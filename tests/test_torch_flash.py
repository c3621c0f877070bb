"""Plain versions of the flash-attention kernels K3, K4 and K5 against the JAX
package's Pallas kernels, and the wrappers' CPU behaviour.

The JAX side runs as ``tests/test_pallas_kernels.py`` runs it off the TPU:
``flash_attention`` / ``flash_forward_partials`` in Pallas interpret mode with
``block_q = block_k = 128`` (Q padded to a block, ``block_k`` dividing Tk),
and ``jax.grad`` / ``jax.vjp`` through its custom VJP, whose backward runs
the Pallas dK/dV and dQ kernels in interpret mode. On the CPU the port's
wrappers take their plain versions, so these tests pin the functions each
CUDA kernel is held to on the card (``chip_smoke.py``).

Tolerances (f32, the same function on both sides, sums in another order):
1e-5 on out and lse, 1e-4 on the gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fmdm_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from fmdm_tpu.ops.pallas.flash_attention import flash_forward_partials as jax_flash_forward_partials
from fmdm_tpu_torch.ops import attention
from fmdm_tpu_torch.ops.kernels.flash_attention import (
    K3, K4, K5, flash_attention, flash_attention_reference, flash_backward,
    flash_backward_dkv, flash_backward_dq, flash_backward_reference, flash_forward)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BLOCKS = dict(block_q=128, block_k=128)

# (q shape, Tk): a small self-attention, a ragged Tq that JAX pads to its
# block, and the VAE's head geometry at T = 1024
FORWARD_CASES = [((1, 2, 256, 32), 256), ((1, 2, 200, 32), 256), ((1, 4, 1024, 64), 1024)]
BACKWARD_CASES = FORWARD_CASES[:2]


def _inputs(seed, q_shape, tk):
    rng = np.random.default_rng(seed)
    kv_shape = q_shape[:-2] + (tk, q_shape[-1])
    return [rng.standard_normal(s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape, q_shape)]


@pytest.mark.parametrize("q_shape,tk", FORWARD_CASES)
def test_k3_plain_matches_jax_flash_forward(q_shape, tk):
    q, k, v, _ = _inputs(0, q_shape, tk)
    scale = q_shape[-1] ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out = np.asarray(jax_flash_attention(jq, jk, jv, scale=scale, **BLOCKS))
    want_lse = np.asarray(jax_flash_forward_partials(jq, jk, jv, scale, **BLOCKS)[1])
    tq_, tk_, tv_ = map(torch.from_numpy, (q, k, v))
    for fn in (flash_attention_reference, flash_forward):
        out, lse = fn(tq_, tk_, tv_, scale)
        assert lse.dtype == torch.float32 and lse.shape == q_shape[:-1] + (1,)
        np.testing.assert_allclose(out.numpy(), want_out, **FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, **FWD_TOL)


@pytest.mark.parametrize("q_shape,tk", BACKWARD_CASES)
def test_flash_backward_matches_jax_grad(q_shape, tk):
    """The XLA formulation and the CPU wrappers against the Pallas backward
    (dK/dV and dQ kernels, interpret mode), for one cotangent."""
    q, k, v, g = _inputs(1, q_shape, tk)
    scale = q_shape[-1] ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, scale=scale, **BLOCKS),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]

    tq_, tk_, tv_, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_reference(tq_, tk_, tv_, scale)
    for got in (flash_backward_reference(tq_, tk_, tv_, out, lse, tg, scale),
                flash_backward(tq_, tk_, tv_, out, lse, tg, scale)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)

    # the parts the two kernels compute, from the same delta
    delta = (tg * out).sum(-1, keepdim=True)
    dk, dv = flash_backward_dkv(tq_, tk_, tv_, tg, lse, delta, scale)
    dq = flash_backward_dq(tq_, tk_, tv_, tg, lse, delta, scale)
    for a, b in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)


def test_flash_backward_matches_jax_vjp_at_a_cross_attention_length():
    """Tk = 77 with q (1, 2, 256, 32): JAX's forward takes the 77 keys as one
    block (interpret mode) and its backward the XLA formulation (:266-280),
    since 77 is no multiple of 128 lanes; the port's plain backward, the one
    K4 and K5 are held to on the card, is that same function."""
    q_shape, tk = (1, 2, 256, 32), 77
    q, k, v, g = _inputs(4, q_shape, tk)
    scale = q_shape[-1] ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, scale=scale, **BLOCKS),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]

    tq_, tk_, tv_, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_forward(tq_, tk_, tv_, scale)
    delta = (tg * out).sum(-1, keepdim=True)
    parts = (flash_backward_dq(tq_, tk_, tv_, tg, lse, delta, scale),
             *flash_backward_dkv(tq_, tk_, tv_, tg, lse, delta, scale))
    for got in (flash_backward_reference(tq_, tk_, tv_, out, lse, tg, scale), parts):
        for a, b, shape in zip(got, want, (q.shape, k.shape, v.shape)):
            assert a.shape == shape
            np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)


@pytest.mark.parametrize("q_shape,tk", BACKWARD_CASES)
def test_flash_backward_matches_autograd_of_the_plain_forward(q_shape, tk):
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, q_shape, tk))
    scale = q_shape[-1] ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_reference(*leaves, scale)[0], leaves, g)
    out, lse = flash_attention_reference(q, k, v, scale)
    for a, b in zip(flash_backward_reference(q, k, v, out, lse, g, scale), want):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    # and the autograd.Function on the CPU (plain forward, plain backward)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    for a, b in zip(torch.autograd.grad(flash_attention(*leaves, scale=scale), leaves, g), want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_sdpa_at_long_t_on_the_cpu_is_the_plain_function():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(3, (1, 2, 1024, 16), 1024))
    torch.testing.assert_close(attention.sdpa(q, k, v),
                               flash_attention_reference(q, k, v, 0.25)[0], **FWD_TOL)


def test_cpu_calls_launch_no_kernel():
    K3.launches = K4.launches = K5.launches = 0
    q = torch.randn(1, 2, 70, 16, requires_grad=True)
    flash_attention(q, q, q).sum().backward()
    out, lse = flash_forward(q.detach(), q.detach(), q.detach(), 0.25)
    flash_backward(q.detach(), q.detach(), q.detach(), out, lse, torch.ones_like(out), 0.25)
    assert (K3.launches, K4.launches, K5.launches) == (0, 0, 0)


def test_wrappers_hold_cpu_callers_to_the_kernel_contract():
    """Validation runs on the CPU as on the card: dtype, head dim, layout,
    shapes, the f32 row vectors, and the device."""
    q = torch.randn(1, 2, 64, 32)
    with pytest.raises(ValueError, match="f32/bf16"):
        flash_forward(q.double(), q.double(), q.double(), 1.0)
    big = torch.randn(1, 1, 8, 129)
    with pytest.raises(ValueError, match="head dims 1..128"):
        flash_forward(big, big, big, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_forward(q.transpose(-1, -2), q, q, 1.0)
    with pytest.raises(ValueError, match="k must be"):
        flash_forward(q, torch.randn(2, 2, 64, 32), q, 1.0)
    with pytest.raises(ValueError, match="v must be"):
        flash_forward(q, q, torch.randn(1, 2, 64, 16), 1.0)
    out, lse = flash_forward(q, q, q, 1.0)
    with pytest.raises(ValueError, match="lse must be"):
        flash_backward(q, q, q, out, lse.squeeze(-1), out, 1.0)
    with pytest.raises(ValueError, match="delta must be"):
        flash_backward_dq(q, q, q, out, lse, lse.double(), 1.0)
    meta = torch.zeros(1, 2, 64, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(meta, meta, meta)
