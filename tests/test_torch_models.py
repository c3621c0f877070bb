"""The port's blocks, UNet and sampling engine against the JAX package's, on
the CPU in f32.

Weights are drawn with numpy in the shapes of the JAX parameter tree
(``jax.eval_shape`` of ``init``), loaded into the JAX model as a tree and
into the port with ``load_jax_params`` (strict). Inputs come from the same
numpy seed. The two sides differ only in the order of their sums; each
tolerance below says what it allows for.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.nn import blocks as jblocks
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.sample.engine import SamplingEngine as JaxEngine
from fmdm_tpu.sample.engine import sample_with_scheduler as jax_sample_with_scheduler
from fmdm_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn import blocks
from fmdm_tpu_torch.ops import attention as attention_ops
from fmdm_tpu_torch.sample.engine import SamplingEngine, sample_with_scheduler
from fmdm_tpu_torch.schedulers import DPMSolverMultistepScheduler
from fmdm_tpu_torch.utils.weights import load_jax_params

FLAGSHIP_UNET = {
    "unet_impl": "diffusers_nd", "sample_size": 256, "in_channels": 1, "out_channels": 1,
    "layers_per_block": 2, "block_out_channels": [128, 128, 256, 256, 512, 512],
    "down_block_types": ["DownBlock2D"] * 4 + ["AttnDownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "AttnUpBlock2D"] + ["UpBlock2D"] * 4,
}
# the flagship's block topology at reduced width and resolution
REDUCED_UNET = dict(FLAGSHIP_UNET, sample_size=64, block_out_channels=[32, 32, 64, 64, 128, 128])
TINY_UNET = {
    "unet_impl": "diffusers_nd", "sample_size": 16, "in_channels": 1, "out_channels": 1,
    "layers_per_block": 1, "block_out_channels": [16, 32], "norm_num_groups": 8,
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
}
# f32 forward through a few dozen layers, sums in another order
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_shapes(module):
    return flatten_params(jax.eval_shape(module.init, jax.random.PRNGKey(0)))


def random_flat_params(jax_module, seed: int):
    """numpy weights in the JAX tree's shapes: U(±1/√fan_in) for conv/linear
    weights, 1±0.1 / ±0.1 for GroupNorm affines, U(±0.1) for other biases."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, leaf in _jax_shapes(jax_module).items():
        shape = leaf.shape
        if len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            value = rng.uniform(-bound, bound, shape)
        elif "norm" in name.split(".")[-2]:
            value = (1.0 if name.endswith("weight") else 0.0) + 0.1 * rng.standard_normal(shape)
        else:
            value = rng.uniform(-0.1, 0.1, shape)
        flat[name] = value.astype(np.float32)
    return flat


def _jax_params(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(jax_module, torch_module, seed):
    flat = random_flat_params(jax_module, seed)
    load_jax_params(torch_module, flat)
    return _jax_params(flat), torch_module.eval()


@pytest.mark.parametrize("scale_shift,channels,out_channels", [
    (False, 32, 64),   # additive time embedding (the UNet's ResBlocks), 1x1 skip conv
    (True, 32, 32),    # FiLM through the fused GroupNorm+SiLU, identity skip
])
def test_resblock_matches_jax(scale_shift, channels, out_channels):
    kw = dict(channels=channels, emb_channels=48, dropout=0.0, out_channels=out_channels,
              use_scale_shift_norm=scale_shift, norm_groups=8, zero_init_last_conv=False,
              emb_activation_before_proj=True, add_embedding_to_hidden=not scale_shift)
    jb = jblocks.ResBlockND(**kw)
    params, tb = _pair(jb, blocks.ResBlockND(**kw, device="cpu"), seed=1)
    rng = np.random.default_rng(2)
    x, emb = _normal(rng, 2, channels, 8, 8), _normal(rng, 2, 48)
    want = np.asarray(jb(params, jnp.asarray(x), jnp.asarray(emb)))
    with torch.no_grad():
        got = tb(torch.from_numpy(x), torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_resblock_parts_input_matches_jax():
    """The decoder's [hidden, skip] tuple: JAX normalizes per part
    (group_norm_parts), the port normalizes the concatenation through K1's
    path; 24 + 8 channels under 8 groups puts a group across the boundary."""
    kw = dict(channels=32, emb_channels=16, dropout=0.0, out_channels=16, norm_groups=8,
              zero_init_last_conv=False, emb_activation_before_proj=True,
              add_embedding_to_hidden=True)
    jb = jblocks.ResBlockND(**kw)
    params, tb = _pair(jb, blocks.ResBlockND(**kw, device="cpu"), seed=3)
    rng = np.random.default_rng(4)
    hidden, skip, emb = _normal(rng, 2, 24, 8, 8), _normal(rng, 2, 8, 8, 8), _normal(rng, 2, 16)
    want = np.asarray(jb(params, (jnp.asarray(hidden), jnp.asarray(skip)), jnp.asarray(emb)))
    with torch.no_grad():
        got = tb((torch.from_numpy(hidden), torch.from_numpy(skip)), torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_diffusers_attention_matches_jax():
    # 64 channels, 8 heads of d=8 at 4x4 (T=16): the flagship's head geometry
    jb = jblocks.DiffusersAttentionND(64, heads=8, norm_num_groups=32)
    params, tb = _pair(jb, blocks.DiffusersAttentionND(64, heads=8, norm_num_groups=32,
                                                       device="cpu"), seed=5)
    x = _normal(np.random.default_rng(6), 2, 64, 4, 4)
    want = np.asarray(jb(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    assert got.is_contiguous()  # the next ResBlock's kernel takes contiguous tensors only
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("cls", ["UpsampleND", "DownsampleND"])
def test_resampling_blocks_match_jax(cls):
    jb = getattr(jblocks, cls)(2, 8, use_conv=True)
    params, tb = _pair(jb, getattr(blocks, cls)(2, 8, use_conv=True, device="cpu"), seed=7)
    x = _normal(np.random.default_rng(8), 2, 8, 6, 6)
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb(params, jnp.asarray(x))), **F32_TOL)


def test_flagship_state_dict_keys_equal_the_jax_tree():
    """Every dotted name and shape of the flagship's JAX tree, and nothing
    else, loads with strict=True (on the meta device: no memory is used)."""
    jm = JaxFactory().build(FLAGSHIP_UNET, conditioning="concatenate", channels=1)
    shapes = {k: tuple(v.shape) for k, v in _jax_shapes(jm).items()}
    tm = DiffusionUNetFactory().build(FLAGSHIP_UNET, conditioning="concatenate", channels=1,
                                      device="meta")
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == shapes
    assert len(shapes) == 450
    tm.load_state_dict({k: torch.empty(s, device="meta") for k, s in shapes.items()},
                       strict=True, assign=True)
    for name in ("down_blocks.0.resnets.1.conv1.conv.weight", "time_embedding.linear_1.weight",
                 "down_blocks.4.attentions.0.to_out.0.weight", "downsamplers.0.op.conv.weight",
                 "up_blocks.0.upsamplers.0.conv.conv.weight", "conv_norm_out.weight"):
        assert any(k.endswith(name) for k in shapes), name


def test_reduced_unet_forward_matches_jax_and_routes_through_the_kernels(monkeypatch):
    jm = JaxFactory().build(REDUCED_UNET, conditioning="concatenate", channels=1)
    tm = DiffusionUNetFactory().build(REDUCED_UNET, conditioning="concatenate", channels=1,
                                      device="cpu")
    params, tm = _pair(jm, tm, seed=9)
    rng = np.random.default_rng(10)
    x = _normal(rng, 2, 2, 64, 64)
    t = np.array([10, 700], np.int32)
    want = np.asarray(jax.jit(lambda p, x, t: jm(p, x, t))(params, x, t))

    calls = {"k1": 0, "k2": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(blocks, "group_norm_act", counted("k1", blocks.group_norm_act))
    monkeypatch.setattr(attention_ops, "small_t_attention",
                        counted("k2", attention_ops.small_t_attention))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    # the CPU takes the plain versions, and the path reaches no attention
    # kernel on the CPU; the K1 wrapper sees every ResBlock's two norms
    assert calls == {"k1": 64, "k2": 0}


def test_unet_refuses_the_deep_cache_split():
    """The DeepCache split at a depth outside [1, n_up - 1] (TINY_UNET has
    two up blocks: depth 1 only) raises, as in JAX; depth 1 splices."""
    tm = DiffusionUNetFactory().build(TINY_UNET, conditioning="concatenate", channels=1,
                                      device="cpu")
    x = torch.zeros(1, 2, 16, 16)
    for depth in (None, 0, 2):
        with pytest.raises(ValueError, match=r"cache_depth must be in \[1, 1\]"):
            tm(x, 5, cache_depth=depth, return_deep_feature=True)
    with torch.no_grad():
        out, feature = tm(x, 5, cache_depth=1, return_deep_feature=True)
        assert torch.equal(tm(x, 5, deep_cache=feature, cache_depth=1), out)


def _engine_pair(seed):
    jm = JaxFactory().build(TINY_UNET, conditioning="concatenate", channels=1)
    tm = DiffusionUNetFactory().build(TINY_UNET, conditioning="concatenate", channels=1,
                                      device="cpu")
    params, tm = _pair(jm, tm, seed=seed)
    kw = dict(num_train_timesteps=1000, algorithm_type="dpmsolver++", solver_order=2,
              beta_start=0.0001, beta_end=0.02)
    return jm, params, tm, JaxDPM.create(**kw), DPMSolverMultistepScheduler.create(**kw)


def test_sampling_engine_five_steps_matches_jax():
    jm, params, tm, jsched, tsched = _engine_pair(seed=11)
    timesteps = tsched.set_timesteps(5)
    np.testing.assert_array_equal(timesteps, jsched.set_timesteps(5))
    rng = np.random.default_rng(12)
    shape = (2, 1, 16, 16)
    init = _normal(rng, *shape)
    cond = np.full(shape, 0.5, np.float32)
    want = np.asarray(JaxEngine(jm, jsched, timesteps, conditioning_mode="concatenate")(
        params, shape, jax.random.PRNGKey(0), conditioning_batch=jnp.asarray(cond),
        init_sample=jnp.asarray(init)))
    timing = {}
    got = SamplingEngine(tm, tsched, timesteps, conditioning_mode="concatenate", device="cpu")(
        shape, conditioning_batch=torch.from_numpy(cond), init_sample=torch.from_numpy(init),
        timing=timing)
    assert got.dtype == torch.float32 and timing["model_calls"] == 5
    # five f32 model calls and solver steps, sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_sample_with_scheduler_last_steps_matches_jax():
    jm, params, tm, jsched, tsched = _engine_pair(seed=13)
    rng = np.random.default_rng(14)
    shape = (1, 1, 16, 16)
    init, cond = _normal(rng, *shape), _normal(rng, *shape)
    want = np.asarray(jax_sample_with_scheduler(
        jm, params, jsched, 20, shape, jax.random.PRNGKey(0), conditioning_mode="concatenate",
        conditioning_batch=jnp.asarray(cond), last_n_steps=3, init_sample=jnp.asarray(init)))
    got = sample_with_scheduler(
        tm, tsched, 20, shape, conditioning_mode="concatenate",
        conditioning_batch=torch.from_numpy(cond), last_n_steps=3,
        init_sample=torch.from_numpy(init), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_sampling_engine_casts_a_copy_once_and_keeps_f32_solver_state():
    _, _, tm, _, tsched = _engine_pair(seed=15)
    engine = SamplingEngine(tm, tsched, tsched.set_timesteps(3), conditioning_mode="concatenate",
                            compute_dtype=torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cond = torch.full((2, 1, 16, 16), 0.5)
    out = engine((2, 1, 16, 16), gen, conditioning_batch=cond)
    compute_model = engine._compute_model
    engine((2, 1, 16, 16), gen, conditioning_batch=cond)
    assert engine._compute_model is compute_model  # cast once, reused
    assert next(compute_model.parameters()).dtype == torch.bfloat16
    assert next(tm.parameters()).dtype == torch.float32  # the caller's model is untouched
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
