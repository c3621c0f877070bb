"""Plain versions of the port's kernels against the JAX package's Pallas
kernels, and the wrappers' CPU behaviour.

The JAX side runs as its own tests run it off the TPU: ``mha_small_t`` in
Pallas interpret mode, ``fused_group_norm_act`` with the fused path switched
on (interpret mode where the shape tiles, its XLA fallback where it does not).
On the CPU the port's wrappers take the plain version, so these tests pin the
function each CUDA kernel is held to on the card (``chip_smoke.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fmdm_tpu.ops.pallas.group_norm as jgn
from fmdm_tpu.ops.pallas.flash_attention import mha_small_t
from fmdm_tpu_torch.ops.kernels.group_norm import K1, group_norm_act, group_norm_act_reference
from fmdm_tpu_torch.ops.kernels.small_t_attention import (
    K2, _SmallTAttention, small_t_attention, small_t_attention_reference)

RNG = np.random.default_rng(1)


def _normal(*shape, scale=1.0, shift=0.0):
    return (RNG.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_fused(x, w, b, groups, act, scale=None, shift=None):
    jgn.set_fused_group_norm(True)
    try:
        return np.asarray(jgn.fused_group_norm_act(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), num_groups=groups, act=act,
            scale=None if scale is None else jnp.asarray(scale),
            shift=None if shift is None else jnp.asarray(shift)))
    finally:
        jgn.set_fused_group_norm(False)


# f32, the same function in both; the sums run in another order (2e-5 abs on
# unit-scale outputs, as tests/test_fused_group_norm.py holds the Pallas
# kernel to the XLA path).
K1_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape,groups,act,film", [
    ((2, 32, 16, 16), 8, True, False),    # cg*S = 4*256: the Pallas kernel tiles
    ((1, 64, 32, 32), 32, True, True),
    ((2, 16, 16, 16), 4, False, True),
    ((2, 8, 64, 64), 4, False, False),
])
def test_k1_plain_matches_jax_fused_kernel(shape, groups, act, film):
    n, c = shape[:2]
    x = _normal(*shape, scale=1.5, shift=0.5)
    w, b = _normal(c, scale=0.1, shift=1.0), _normal(c, scale=0.1)
    s = _normal(n, c, scale=0.2) if film else None
    t = _normal(n, c, scale=0.2) if film else None
    want = _jax_fused(x, w, b, groups, act, s, t)
    kw = dict(num_groups=groups, act=act, scale=None if s is None else _t(s),
              shift=None if t is None else _t(t))
    np.testing.assert_allclose(group_norm_act_reference(_t(x), _t(w), _t(b), **kw).numpy(),
                               want, **K1_TOL)
    np.testing.assert_allclose(group_norm_act(_t(x), _t(w), _t(b), **kw).numpy(), want, **K1_TOL)


@pytest.mark.parametrize("film", [False, True])
def test_k1_at_the_jax_kernel_limit(film):
    """8x8 spatial (< 128) is where the JAX entry falls back to XLA
    (group_norm.py:184): the port's path is pinned to that same function."""
    shape, groups = (2, 64, 8, 8), 32
    x = _normal(*shape)
    w, b = _normal(64, scale=0.1, shift=1.0), _normal(64, scale=0.1)
    s = _normal(2, 64, scale=0.2) if film else None
    t = _normal(2, 64, scale=0.2) if film else None
    want = _jax_fused(x, w, b, groups, True, s, t)
    got = group_norm_act(_t(x), _t(w), _t(b), num_groups=groups, act=True,
                         scale=None if s is None else _t(s), shift=None if t is None else _t(t))
    np.testing.assert_allclose(got.numpy(), want, **K1_TOL)


def test_k1_bf16_rounds_once():
    """In bf16 the plain version rounds its f32 result once, as the TPU kernel
    does: it equals the f32 computation cast to bf16."""
    x = _t(_normal(2, 32, 8, 8)).to(torch.bfloat16)
    w, b = _t(_normal(32, shift=1.0)), _t(_normal(32))
    got = group_norm_act_reference(x, w, b, num_groups=8)
    want = group_norm_act_reference(x.float(), w, b, num_groups=8).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_k1_gradients_match_jax():
    shape, groups = (1, 16, 16, 16), 4
    x, w, b = _normal(*shape), _normal(16, scale=0.1, shift=1.1), _normal(16, scale=0.1)
    s, t = _normal(1, 16, scale=0.2), _normal(1, 16, scale=0.2)

    def jloss(x, w, b, s, t):
        return jnp.sum(jgn.fused_group_norm_act(x, w, b, num_groups=groups, scale=s, shift=t) ** 2)

    jgn.set_fused_group_norm(True)
    try:
        want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, w, b, s, t)))
    finally:
        jgn.set_fused_group_norm(False)
    leaves = [_t(a).requires_grad_(True) for a in (x, w, b, s, t)]
    (group_norm_act(leaves[0], leaves[1], leaves[2], num_groups=groups,
                    scale=leaves[3], shift=leaves[4]) ** 2).sum().backward()
    for got, ref in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-5),
    # bf16: both round P to bf16 before PV and the output to bf16; the f32
    # sums run in another order, so an output may differ by one bf16 ulp
    ("bfloat16", 1e-2),
])
def test_k2_plain_matches_jax_mha_small_t(dtype, tol):
    shape = (2, 8, 64, 8)
    q, k, v = (_normal(*shape) for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(mha_small_t(*(jnp.asarray(a).astype(jd) for a in (q, k, v))), np.float32)
    for fn in (small_t_attention_reference, small_t_attention):
        got = fn(*(_t(a).to(td) for a in (q, k, v)))
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_k2_gradients_follow_the_plain_version():
    q, k, v = (_t(_normal(1, 2, 16, 8)).requires_grad_(True) for _ in range(3))
    small_t_attention(q, k, v).pow(2).sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    small_t_attention_reference(*ref).pow(2).sum().backward()
    for got, want in zip((q, k, v), ref):
        torch.testing.assert_close(got.grad, want.grad)


@pytest.mark.parametrize("dtype,rtol,atol", [
    ("float32", 1e-5, 1e-5),
    # bf16: JAX scales q before the dot and leaves P unrounded in its VJP;
    # the gradients are rounded to bf16 on both sides: one bf16 ulp
    ("bfloat16", 2.0 ** -7, 1e-2),
])
def test_k2_backward_matches_jax_vjp(dtype, rtol, atol):
    """The backward that a card forward of K2 takes (``_SmallTAttention.backward``,
    through the plain version's autograd) and the CPU wrapper's autograd,
    against ``jax.vjp`` of ``mha_small_t`` (its reference VJP, :484-493)."""
    rng = np.random.default_rng(5)
    shape = (2, 4, 64, 8)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(mha_small_t, *(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g).astype(jd))]

    inputs = [_t(a).to(td) for a in (q, k, v)]
    ctx = SimpleNamespace(saved_tensors=tuple(inputs), needs_input_grad=(True, True, True, False),
                          scale=shape[-1] ** -0.5)
    from_kernel = _SmallTAttention.backward(ctx, _t(g).to(td))
    assert from_kernel[3] is None
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    from_cpu = torch.autograd.grad(small_t_attention(*leaves), leaves, _t(g).to(td))
    for got in (from_kernel[:3], from_cpu):
        for a, b in zip(got, want):
            assert a.dtype == td
            np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol, atol=atol)


def test_cpu_calls_launch_no_kernel():
    K1.launches = K2.launches = 0
    x = torch.randn(2, 8, 4, 4)
    group_norm_act(x, torch.ones(8), torch.zeros(8), num_groups=4)
    q = torch.randn(1, 2, 8, 8)
    small_t_attention(q, q, q)
    assert (K1.launches, K2.launches) == (0, 0)


def test_wrappers_hold_cpu_callers_to_the_kernel_contract():
    """The wrappers validate on the CPU as on the card, so a caller that hands
    the kernel a layout it does not take fails here too."""
    x = torch.randn(2, 8, 4, 4).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm_act(x, torch.ones(8), torch.zeros(8), num_groups=4)
    with pytest.raises(ValueError, match="divisible"):
        group_norm_act(x.contiguous(), torch.ones(8), torch.zeros(8), num_groups=3)
    q = torch.randn(1, 2, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        small_t_attention(q.transpose(-1, -2), q, q)
    with pytest.raises(ValueError, match="T <= 1024"):
        big = torch.randn(1, 1, 1025, 8)
        small_t_attention(big, big, big)


def test_wrappers_refuse_devices_without_a_path():
    """A tensor that is neither on the CPU nor on a CUDA card raises: the
    plain version is taken for CPU tensors only."""
    x = torch.zeros((2, 8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_act(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"), num_groups=4)
    q = torch.zeros((1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        small_t_attention(q, q, q)
