"""The port's RMSNorm and LayerNorm, ``ResBlockND(norm_type="rmsnorm")`` and
every ``nn/compat.py`` symbol against the JAX package's, on the CPU in f32
with the same numpy-seeded inputs and carried-across weights.

Tolerance: 1e-6 of the output's largest magnitude for every comparison (a
norm's reductions, a ResBlock's convolutions and attention's sums run in
another order); the zeroing is exact.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu.nn import blocks as jblocks
from fmdm_tpu.nn import compat as jcompat
from fmdm_tpu.nn import layers as jlayers
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.ops import norm as jnorm
import fmdm_tpu_torch.nn as tnn
import fmdm_tpu_torch.ops as tops
from fmdm_tpu_torch.nn import blocks as tblocks
from fmdm_tpu_torch.nn import compat as tcompat
from fmdm_tpu_torch.nn import layers as tlayers
from fmdm_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_vae import random_flat_params


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


SHAPES = [(2, 4, 7), (2, 8, 5, 6), (1, 3, 4, 5, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=["1d", "2d", "3d"])
def test_rms_norm_nd_reduces_over_all_non_batch_dims(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    got = tops.rms_norm_nd(_t(x), _t(w)).numpy()
    _close(got, jnorm.rms_norm_nd(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    # all non-batch dims: scaling one channel changes every other channel's output
    x2 = x.copy()
    x2[:, 0] *= 10
    assert not np.allclose(tops.rms_norm_nd(_t(x2), _t(w)).numpy()[:, 1:], got[:, 1:])
    # bf16 in, one rounding at the end
    xb = torch.from_numpy(x).bfloat16()
    assert tops.rms_norm_nd(xb, _t(w)).dtype == torch.bfloat16
    assert torch.equal(tops.rms_norm_nd(xb, _t(w)), tops.rms_norm_nd(xb.float(), _t(w)).bfloat16())


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "bare"])
@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 32)], ids=["2d", "3d"])
def test_layer_norm_matches_jax(shape, affine):
    rng = np.random.default_rng(shape[-1])
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32) if affine else None
    b = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32) if affine else None
    got = tops.layer_norm(_t(x), None if w is None else _t(w), None if b is None else _t(b))
    want = jnorm.layer_norm(jnp.asarray(x), None if w is None else jnp.asarray(w),
                            None if b is None else jnp.asarray(b))
    _close(got.numpy(), want, 1e-6)
    xb = torch.from_numpy(x).bfloat16()
    assert torch.equal(tops.layer_norm(xb, None, None), tops.layer_norm(xb.float(), None, None)
                       .bfloat16())


@pytest.mark.parametrize("shape", SHAPES, ids=["1d", "2d", "3d"])
def test_rms_norm_module_matches_jax(shape):
    jm = jlayers.RMSNormND(shape[1])
    tm = tlayers.RMSNormND(shape[1], device="cpu")
    flat = {"weight": np.random.default_rng(3).uniform(0.5, 1.5, shape[1]).astype(np.float32)}
    load_jax_params(tm, flat)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    _close(tm(_t(x)).detach().numpy(), jm(unflatten_params({k: jnp.asarray(v) for k, v in
                                                          flat.items()}), jnp.asarray(x)), 1e-6)
    assert tm.eps == jm.eps == 1e-6


RES_CASES = {
    "plain": dict(kw=dict(channels=16, emb_channels=None, dropout=0.0), emb=False, parts=False),
    "film": dict(kw=dict(channels=16, emb_channels=12, dropout=0.0, out_channels=24,
                         use_scale_shift_norm=True), emb=True, parts=False),
    "additive": dict(kw=dict(channels=16, emb_channels=12, dropout=0.0,
                             add_embedding_to_hidden=True), emb=True, parts=False),
    "skip_concat_film": dict(kw=dict(channels=24, emb_channels=12, dropout=0.0, out_channels=16,
                                     use_scale_shift_norm=True, act="swish"), emb=True,
                             parts=True),
    "gelu_3d": dict(kw=dict(channels=8, emb_channels=None, dropout=0.0, spatial_dims=3,
                            act="gelu"), emb=False, parts=False),
}


@pytest.mark.parametrize("case", list(RES_CASES))
def test_resblock_rmsnorm_matches_jax(case):
    spec = RES_CASES[case]
    kw = dict(spec["kw"], norm_type="rmsnorm", norm_groups=4)
    jm = jblocks.ResBlockND(**kw)
    tm = tblocks.ResBlockND(**kw, device="cpu")
    assert isinstance(tm.norm1, tlayers.RMSNormND) and isinstance(tm.norm2, tlayers.RMSNormND)
    flat = random_flat_params(jm, 5)
    for name in ("norm1.weight", "norm2.weight"):   # away from 1, so the scale shows
        flat[name] = np.random.default_rng(6).uniform(0.5, 1.5, flat[name].shape).astype(np.float32)
    load_jax_params(tm, flat)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    rng = np.random.default_rng(7)
    spatial = (6,) * kw.get("spatial_dims", 2)
    emb = rng.standard_normal((2, 12)).astype(np.float32) if spec["emb"] else None
    if spec["parts"]:
        parts = [rng.standard_normal((2, c) + spatial).astype(np.float32) for c in (16, 8)]
        want = jm(params, tuple(jnp.asarray(p) for p in parts),
                  None if emb is None else jnp.asarray(emb))
        got = tm(tuple(_t(p) for p in parts), None if emb is None else _t(emb))
    else:
        x = rng.standard_normal((2, kw["channels"]) + spatial).astype(np.float32)
        want = jm(params, jnp.asarray(x), None if emb is None else jnp.asarray(emb))
        got = tm(_t(x), None if emb is None else _t(emb))
    _close(got.detach().numpy(), want, 1e-6)


def test_resblock_rejects_an_unknown_norm():
    with pytest.raises(ValueError, match="Unsupported norm_type"):
        tblocks.ResBlockND(8, None, 0.0, norm_type="layernorm", device="cpu")


@pytest.mark.parametrize("name", ["gn_silu", "gn_swish", "rmsnorm_silu", "rmsnorm_swish"])
def test_resblock_builders_match_jax(name):
    kw = dict(channels=8, emb_channels=None, dropout=0.0, norm_groups=4)
    jm = getattr(jcompat, f"build_resblock_{name}")(**kw)
    tm = getattr(tcompat, f"build_resblock_{name}")(**kw, device="cpu")
    assert type(tm.norm1).__name__ == type(jm.norm1).__name__
    flat = random_flat_params(jm, 8)
    load_jax_params(tm, flat)
    x = np.random.default_rng(9).standard_normal((2, 8, 6, 6)).astype(np.float32)
    want = jm(unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), jnp.asarray(x))
    _close(tm(_t(x)).detach().numpy(), want, 1e-6)


@pytest.mark.parametrize("shape", [(2, 3, 16, 8), (1, 2, 40, 16)], ids=["short", "long"])
def test_qkv_attention_modules_match_jax(shape):
    rng = np.random.default_rng(shape[2])
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    jq = [jnp.asarray(a) for a in (q, k, v)]
    tq = [_t(a) for a in (q, k, v)]
    _close(tcompat.QKVAttention(efficient_attn=False)(*tq).numpy(),
           jcompat.QKVAttention()({}, *jq), 1e-6)
    _close(tcompat.LinearQKVAttention(eps=1e-5)(*tq).numpy(),
           jcompat.LinearQKVAttention(eps=1e-5)({}, *jq), 1e-6)


@pytest.mark.parametrize("nd,kernel,stride,padding", [(1, 3, 2, 1), (2, 2, None, 0),
                                                      (2, 3, 1, 1), (3, 2, 2, 0)])
def test_pool_modules_match_jax(nd, kernel, stride, padding):
    x = np.random.default_rng(nd).standard_normal((2, 3) + (6,) * nd).astype(np.float32)
    for name in ("AvgPoolND", "MaxPoolND"):
        want = getattr(jcompat, name)(nd, kernel, stride, padding)({}, jnp.asarray(x))
        got = getattr(tcompat, name)(nd, kernel, stride, padding)(_t(x))
        _close(got.numpy(), want, 1e-6)
    with pytest.raises(ValueError):
        tcompat.AvgPoolND(4)


def test_zero_module_and_markers():
    block = tblocks.ResBlockND(8, 4, 0.0, norm_groups=4, device="cpu")
    assert tcompat.zero_module(block) is block
    assert all(float(p.detach().abs().max()) == 0 for p in block.parameters())
    jparams = jcompat.zero_module(jblocks.ResBlockND(8, 4, 0.0, norm_groups=4)
                                  .init(jax.random.PRNGKey(0)))
    assert all(float(jnp.abs(v).max()) == 0 for v in jax.tree_util.tree_leaves(jparams))
    assert set(block.state_dict()) == set(flatten_params(jparams))
    assert issubclass(tcompat.TimestepBlock, torch.nn.Module)
    assert issubclass(tcompat.ContextBlock, torch.nn.Module)


def test_the_packages_export_the_jax_names():
    import fmdm_tpu.nn as jnn
    import fmdm_tpu.ops as jops

    functional_core = {"Identity", "Module", "ModuleList", "cast_floating", "flatten_params",
                       "param_count", "unflatten_params", "dropout"}
    missing = [n for n in dir(jnn) if not n.startswith("_") and n not in functional_core
               and not inspect.ismodule(getattr(jnn, n)) and not hasattr(tnn, n)]
    assert not missing, missing
    jax_only_ops = {"set_sdpa_backend", "get_sdpa_backend", "conv_kernel_init", "conv_bias_init"}
    assert set(jops.__all__) - jax_only_ops <= set(tops.__all__)
