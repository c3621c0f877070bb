"""The port's ops (fmdm_tpu_torch/ops) against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both; comparisons are in f32
unless a case says otherwise. Tolerances: f32 results differ only in the
order of their sums, a few ulps (held at 1e-5); each looser bound is stated
where it is set.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fmdm_tpu.ops import attention as jattn
from fmdm_tpu.ops import conv as jconv
from fmdm_tpu.ops import norm as jnorm
from fmdm_tpu.ops import resample as jresample
from fmdm_tpu.ops import time_embed as jtime
from fmdm_tpu_torch.ops import attention, conv, norm, resample, time_embed

RNG = np.random.default_rng(0)


def _normal(*shape, scale=1.0, shift=0.0):
    return (RNG.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-5, atol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("x_shape,w_shape,kw", [
    ((2, 3, 9, 9), (5, 3, 3, 3), {}),                              # default k//2 padding
    ((2, 4, 8, 8), (4, 4, 3, 3), {"stride": 2, "padding": 1}),     # DownsampleND's conv
    ((1, 6, 7, 7), (6, 3, 1, 1), {"groups": 2}),
    ((1, 2, 5, 6, 7), (3, 2, 3, 3, 3), {"dilation": 1}),           # 3-D
    ((2, 3, 11), (4, 3, 5), {"padding": 0}),                       # 1-D
])
def test_conv_nd_matches_jax(x_shape, w_shape, kw):
    x, w, b = _normal(*x_shape), _normal(*w_shape, scale=0.3), _normal(w_shape[0])
    want = jconv.conv_nd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    _close(conv.conv_nd(_t(x), _t(w), _t(b), **kw), want)


@pytest.mark.parametrize("shape,groups", [((2, 32, 8, 8), 8), ((2, 12, 5, 5), 4), ((1, 16, 3, 4, 5), 16)])
def test_group_norm_and_stats_match_jax(shape, groups):
    # a large mean exercises the one-pass E[x²]-mean² formulation
    x = _normal(*shape, scale=2.0, shift=3.0)
    w, b = _normal(shape[1], scale=0.1, shift=1.0), _normal(shape[1], scale=0.1)
    jm, jv = jnorm.group_norm_stats(jnp.asarray(x), groups)
    tm, tv = norm.group_norm_stats(_t(x), groups)
    _close(tm, jm)
    _close(tv, jv, rtol=1e-5, atol=1e-4)  # E[x²]-mean² at mean 3: cancellation of ~10 in f32
    want = jnorm.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), num_groups=groups)
    _close(norm.group_norm(_t(x), _t(w), _t(b), num_groups=groups), want, atol=2e-5)


def test_group_norm_parts_matches_jax_with_straddling_group():
    # 5 + 7 = 12 channels under 4 groups of 3: a group straddles the boundary
    a, b = _normal(2, 5, 6, 6), _normal(2, 7, 6, 6)
    w, bias = _normal(12), _normal(12)
    want = jnorm.group_norm_parts([jnp.asarray(a), jnp.asarray(b)], jnp.asarray(w),
                                  jnp.asarray(bias), num_groups=4)
    got = norm.group_norm_parts([_t(a), _t(b)], _t(w), _t(bias), num_groups=4)
    _close(got, want)
    whole = norm.group_norm(torch.cat([_t(a), _t(b)], 1), _t(w), _t(bias), num_groups=4)
    _close(got, whole.numpy())


def test_safe_num_groups():
    for c, g in ((6, 32), (48, 32), (128, 32), (7, 4)):
        assert norm.safe_num_groups(c, g) == jnorm.safe_num_groups(c, g)


@pytest.mark.parametrize("dim,flip,shift", [(32, True, 0), (9, True, 0), (16, False, 1)])
def test_timestep_embedding_matches_jax(dim, flip, shift):
    t = np.array([0, 1, 10, 500, 999], np.int32)
    want = jtime.timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip, freq_shift=shift)
    # sin/cos of arguments up to ~1000 rad: the two libraries' f32 range
    # reductions differ by a few ulps of the argument
    _close(time_embed.timestep_embedding(_t(t), dim, flip_sin_to_cos=flip, freq_shift=shift),
           want, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 3, 4, 5), (2, 2, 9)])
def test_upsample_and_avg_pool_match_jax(shape):
    x = _normal(*shape)
    _close(resample.upsample_nearest(_t(x), 2), jresample.upsample_nearest(jnp.asarray(x), 2),
           rtol=0, atol=0)
    even = _normal(*(shape[:2] + tuple(2 * s for s in shape[2:])))
    _close(resample.avg_pool_nd(_t(even), 2, 2), jresample.avg_pool_nd(jnp.asarray(even), 2, 2))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       # bf16 outputs: one bf16 ulp of |out| <= ~3
                                       ("bfloat16", 2e-2)])
def test_sdpa_xla_matches_jax(dtype, tol):
    q, k, v = (_normal(2, 4, 48, 8) for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.sdpa_xla(*(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    got = attention.sdpa_xla(*(_t(a).to(td) for a in (q, k, v)))
    assert got.dtype == td
    _close(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_sdpa_cpu_dispatch_and_cross_attention():
    q, k, v = _normal(1, 2, 16, 8), _normal(1, 2, 24, 8), _normal(1, 2, 24, 8)
    # CPU tensors take the plain version, cross-attention included
    _close(attention.sdpa(_t(q), _t(k), _t(v)), jattn.sdpa_xla(*map(jnp.asarray, (q, k, v))))


def test_sdpa_refuses_devices_without_a_path():
    q = torch.zeros((1, 2, 16, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention.sdpa(q, q, q)


def test_linear_attention_matches_jax():
    q, k, v = _normal(2, 3, 20, 8), _normal(2, 3, 20, 8), _normal(2, 3, 20, 6)
    want = jattn.linear_attention(*map(jnp.asarray, (q, k, v)))
    _close(attention.linear_attention(_t(q), _t(k), _t(v)), want)
