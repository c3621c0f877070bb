"""The port's EfficientUNetND and its blocks against the JAX package's, on
the CPU in f32.

Weights are drawn with numpy in the shapes of the JAX parameter tree and
loaded into both sides (``load_jax_params``, strict), inputs come from the
same numpy seed, and every comparison is held at ``F32_TOL`` (rtol = atol =
1e-4: sums in another order through a few dozen layers). Covered: the
transposed conv and the patchify pool and unpool in 1-, 2- and 3-D; self-
and cross-attention, linear and softmax, with each context layout; a
reduced EfficientUNetND over its options; both MNIST compvis configs at
their published widths; the LDCT configs' parameter names; and
checkpoints carried across in both directions. Its train step and CLIs are
in ``tests/test_torch_efficient_train.py``.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.nn import blocks as jblocks
from fmdm_tpu.nn import layers as jlayers
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.utils import checkpoint as jckpt
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.models.unet_efficient import EfficientUNetND
from fmdm_tpu_torch.nn import blocks, layers
from fmdm_tpu_torch.ops.time_embed import timestep_embedding
from fmdm_tpu_torch.sample import diffusion_utils as tdu
from fmdm_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_models import F32_TOL, _jax_shapes, _normal, _pair, random_flat_params

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
EFFICIENT_CONFIGS = (
    "LDCT/LDCT_ddpm_compvis.json", "LDCT/LDCT_flow_matching_compvis.json",
    "diffusion/ldct_ddpm_compvis.json", "flow_matching/ldct_flow_matching_compvis.json",
    "MNIST/mnist_ddpm_compvis.json", "MNIST/mnist_flow_matching_compvis.json",
    "LDCT/PixelAttention/LDCT_ddpm_attention.json",
    "LDCT/PixelAttention/LDCT_ddpm_attention_compvis.json",
    "LDCT/PixelAttention/LDCT_flow_matching_attention.json",
    "LDCT/PixelAttention/LDCT_flow_matching_attention_compvis.json",
)
# an EfficientUNet cut to three levels of 32/64/64 channels, one res block
REDUCED = {"unet_impl": "efficient_nd", "model_channels": 32, "num_res_blocks": 1,
           "channel_mult": [1, 2, 2], "attention_resolutions": [2], "num_heads": 2,
           "dim_head": 16}


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_module(jm, tm, seed, *inputs, **kw):
    """The JAX module and the port's on the same weights and inputs."""
    params, tm = _pair(jm, tm, seed)
    want = np.asarray(jm(params, *(jnp.asarray(a) for a in inputs), **kw))
    with torch.no_grad():
        got = tm(*(_torch(a) for a in inputs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)


# ---------------------------------------------------------------------------
# Layers and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd,spatial,kernel,stride,padding,output_padding", [
    (1, (9,), 2, 2, 0, 0),
    (2, (5, 6), 3, 2, 1, 1),
    (2, (4, 4), 4, 4, 0, 0),
    (3, (3, 4, 2), 2, 2, 0, 0),
    (3, (3, 3, 3), 3, 1, 1, 0),
])
def test_conv_transpose_nd_matches_jax(nd, spatial, kernel, stride, padding, output_padding):
    kw = dict(kernel_size=kernel, stride=stride, padding=padding, output_padding=output_padding)
    jm = jlayers.ConvTransposeND(nd, 6, 5, **kw)
    tm = layers.ConvTransposeND(nd, 6, 5, **kw, device="cpu")
    assert tm.state_dict().keys() == {"convT.weight", "convT.bias"}
    _check_module(jm, tm, 1, _normal(np.random.default_rng(2), 2, 6, *spatial))


@pytest.mark.parametrize("nd,spatial,factor", [(1, (12,), 2), (2, (8, 12), 2), (2, (8, 8), 4),
                                               (3, (4, 6, 2), 2)])
def test_pool_and_unpool_match_jax(nd, spatial, factor):
    rng = np.random.default_rng(3)
    _check_module(jblocks.PoolND(nd, 3, 8, factor), blocks.PoolND(nd, 3, 8, factor, device="cpu"),
                  4, _normal(rng, 2, 3, *spatial))
    coarse = tuple(s // factor for s in spatial)
    _check_module(jblocks.UnPoolND(nd, 8, 3, factor),
                  blocks.UnPoolND(nd, 8, 3, factor, device="cpu"), 5, _normal(rng, 2, 8, *coarse))


@pytest.mark.parametrize("linear", [False, True], ids=["softmax", "linear"])
@pytest.mark.parametrize("spatial", [(16,), (4, 6), (2, 3, 4)], ids=["1d", "2d", "3d"])
def test_spatial_self_attention_matches_jax(linear, spatial):
    jm = jblocks.SpatialSelfAttention(32, heads=2, dim_head=16, use_linear=linear)
    tm = blocks.SpatialSelfAttention(32, heads=2, dim_head=16, use_linear=linear, device="cpu")
    _check_module(jm, tm, 6, _normal(np.random.default_rng(7), 2, 32, *spatial))


@pytest.mark.parametrize("linear", [False, True], ids=["softmax", "linear"])
@pytest.mark.parametrize("layout", ["channels_first", "tokens_first", "spatial"])
def test_spatial_cross_attention_matches_jax(linear, layout):
    rng = np.random.default_rng(8)
    x = _normal(rng, 2, 32, 4, 4)
    context = {"channels_first": _normal(rng, 2, 6, 10),
               "tokens_first": _normal(rng, 2, 10, 6),
               "spatial": _normal(rng, 2, 6, 5, 3)}[layout]
    jm = jblocks.SpatialCrossAttention(32, context_dim=6, heads=2, dim_head=16, use_linear=linear)
    tm = blocks.SpatialCrossAttention(32, context_dim=6, heads=2, dim_head=16, use_linear=linear,
                                      device="cpu")
    _check_module(jm, tm, 9, x, context)


def test_cross_attention_refuses_a_missing_or_mismatched_context():
    tm = blocks.SpatialCrossAttention(8, context_dim=4, heads=2, dim_head=4, device="cpu")
    x = torch.zeros(1, 8, 2, 2)
    with pytest.raises(ValueError, match="non-empty context"):
        tm(x)
    for bad in (torch.zeros(1, 3, 5), torch.zeros(1, 3, 2, 2)):
        with pytest.raises(ValueError, match="mismatch"):
            tm(x, bad)


# ---------------------------------------------------------------------------
# EfficientUNetND
# ---------------------------------------------------------------------------

def _pair_unets(unet_cfg, conditioning, seed, channels=1):
    jm = JaxFactory().build(unet_cfg, conditioning=conditioning, channels=channels)
    tm = DiffusionUNetFactory().build(unet_cfg, conditioning=conditioning, channels=channels,
                                      device="cpu")
    assert isinstance(tm, EfficientUNetND)
    params, tm = _pair(jm, tm, seed)
    return jm, params, tm


def _check_unet(unet_cfg, conditioning, spatial, context_shape=None, batch=2, seed=10):
    jm, params, tm = _pair_unets(unet_cfg, conditioning, seed)
    rng = np.random.default_rng(seed + 1)
    x = _normal(rng, batch, tm.in_channels, *spatial)
    t = np.array([3, 977][:batch] + [500] * max(batch - 2, 0), np.int32)
    ctx = None if context_shape is None else _normal(rng, batch, *context_shape)
    # one jitted program compiles faster than the eager model's ops one by one
    forward = jax.jit(lambda p, x, t, c: jm(p, x, t, context_ca=c))
    want = np.asarray(forward(params, jnp.asarray(x), jnp.asarray(t),
                              None if ctx is None else jnp.asarray(ctx)))
    with torch.no_grad():
        got = tm(_torch(x), _torch(t), context_ca=None if ctx is None else _torch(ctx)).numpy()
    assert got.shape == (batch, 1) + tuple(spatial)
    np.testing.assert_allclose(got, want, **F32_TOL)
    return tm


UNET_CASES = {
    # id: (config overrides, conditioning, spatial, context shape)
    "2d-concat-film-linear": ({}, "concatenate", (16, 16), None),
    "2d-attention-softmax": ({"use_linear_attn": False, "cross_attention_dim": 4}, "attention",
                             (16, 16), (4, 8, 8)),
    "2d-additive-emb_act_first": ({"use_scale_shift_norm": False,
                                   "emb_activation_before_proj": True}, "concatenate",
                                  (16, 16), None),
    "2d-pool2": ({"pool_factor": 2}, "concatenate", (32, 32), None),
    "2d-attention-linear-no_middle": ({"cross_attention_dim": 4,
                                       "cross_attention_in_middle": False}, "attention",
                                      (16, 16), (4, 64)),
    "1d-concat": ({"spatial_dims": 1}, "concatenate", (32,), None),
    "1d-attention-pool2": ({"spatial_dims": 1, "pool_factor": 2, "cross_attention_dim": 4},
                           "attention", (32,), (4, 8)),
    "3d-concat-softmax-emb_act_first": ({"spatial_dims": 3, "use_linear_attn": False,
                                         "emb_activation_before_proj": True}, "concatenate",
                                        (8, 8, 8), None),
    "3d-attention-additive": ({"spatial_dims": 3, "use_scale_shift_norm": False,
                               "cross_attention_dim": 4}, "attention", (8, 8, 8), (4, 2, 4, 4)),
}


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_reduced_efficient_unet_matches_jax(case):
    overrides, conditioning, spatial, context_shape = UNET_CASES[case]
    _check_unet(dict(REDUCED, **overrides), conditioning, spatial, context_shape)


def test_factory_defaults_follow_jax():
    """The attention defaults (cross-attention wherever self-attention is,
    and in the middle unless the key is given), channel_mult from
    block_out_channels, and the conditioning channels as cross_attention_dim."""
    cfg = {"unet_impl": "efficient_nd", "block_out_channels": [32, 64, 64],
           "attention_resolutions": [2], "num_res_blocks": 1}
    for conditioning, extra in (("attention", {}), ("attention", {"cross_attention_in_middle": False}),
                                ("concatenate", {}), (None, {"conditioning_channels": 3})):
        c = dict(cfg, **extra)
        jm = JaxFactory().build(c, conditioning=conditioning, channels=2)
        tm = DiffusionUNetFactory().build(c, conditioning=conditioning, channels=2, device="cpu")
        for attr in ("in_channels", "model_channels", "out_channels", "attention_resolutions",
                     "cross_attention_resolutions", "cross_attention_in_middle"):
            assert getattr(tm, attr) == getattr(jm, attr), (conditioning, extra, attr)
        assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
            k: tuple(v.shape) for k, v in _jax_shapes(jm).items()}


def test_time_embedding_does_not_flip():
    """EfficientUNet embeds t as sin||cos with no frequency shift, where the
    diffusers UNet flips to cos||sin."""
    t = torch.tensor([0.0, 7.0])
    emb = timestep_embedding(t, 8, flip_sin_to_cos=False, freq_shift=0)
    assert torch.equal(emb[:, :4], torch.sin(t[:, None] * torch.exp(
        -math.log(10000) * torch.arange(4.0) / 4)))


def test_context_without_cross_attention_raises():
    tm = DiffusionUNetFactory().build(REDUCED, conditioning="concatenate", channels=1,
                                      device="cpu")
    with pytest.raises(ValueError, match="cross-attention is disabled"):
        tm(torch.zeros(1, 2, 16, 16), 5, context_ca=torch.zeros(1, 1, 16, 16))


def test_every_efficient_config_builds():
    for rel in EFFICIENT_CONFIGS:
        cfg = json.loads((CONFIGS / rel).read_text())
        assert cfg["model"]["unet"]["unet_impl"] == "efficient_nd"
        jm = JaxFactory().build(cfg["model"]["unet"], cfg["training"].get("conditioning"), 1)
        assert type(jm).__name__ == "EfficientUNetND"
    assert len(EFFICIENT_CONFIGS) == 10


@pytest.mark.parametrize("name", ["mnist_ddpm_compvis", "mnist_flow_matching_compvis"])
def test_mnist_compvis_at_published_width_matches_jax(name):
    cfg = json.loads((CONFIGS / "MNIST" / f"{name}.json").read_text())
    tm = _check_unet(cfg["model"]["unet"], cfg["training"]["conditioning"], (32, 32), seed=12)
    assert sum(p.numel() for p in tm.parameters()) == 6_947_457


@pytest.mark.parametrize("rel,count", [("LDCT/LDCT_ddpm_compvis.json", 115_641_217),
                                       ("LDCT/PixelAttention/LDCT_ddpm_attention.json",
                                        117_239_089)])
def test_ldct_config_names_equal_jax(rel, count):
    cfg = json.loads((CONFIGS / rel).read_text())
    cond = cfg["training"]["conditioning"]
    jm = JaxFactory().build(cfg["model"]["unet"], cond, 1)
    want = {k: tuple(v.shape) for k, v in _jax_shapes(jm).items()}
    tm = DiffusionUNetFactory().build(cfg["model"]["unet"], cond, 1, device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == count
    for key in ("time_embed.0.weight", "input_blocks.13.1.qkv.weight", "middle_block.0.emb_layers.weight",
                "output_blocks.11.1.conv.conv.weight", "out.0.weight", "out.2.conv.weight"):
        assert key in got
    assert ("input_blocks.13.2.kv_proj.weight" in got) == (cond == "attention")


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _run_cfg(conditioning="concatenate"):
    return {"training": {"conditioning": conditioning, "channels": 1, "seed": 0},
            "model": {"model_type": "diffusion", "unet": dict(REDUCED),
                      "scheduler": {"name": "ddpm"}}}


def test_checkpoint_cross_loads_in_both_directions(tmp_path):
    cfg = _run_cfg()
    jm = JaxFactory().build(REDUCED, "concatenate", 1)
    flat = random_flat_params(jm, 3)
    rng = np.random.default_rng(13)
    x, t = _normal(rng, 2, 2, 16, 16), np.array([4, 600], np.int32)

    # JAX writes, the port reads
    jckpt.save_checkpoint({"model": unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}),
                           "epoch": 1}, tmp_path / "jax.pt")
    tm = tdu.build_diffusion_model(cfg, tmp_path / "jax.pt", device="cpu")
    assert all(np.array_equal(v.numpy(), flat[k]) for k, v in tm.state_dict().items())
    # the port writes, JAX reads
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.01)
    tckpt.save_checkpoint({"model": tm, "epoch": 1}, tmp_path / "port.pt")
    jm2, params = jdu.build_diffusion_model(cfg, ckpt_path=str(tmp_path / "port.pt"))
    assert all(np.array_equal(np.asarray(v), tm.state_dict()[k].numpy())
               for k, v in flatten_params(params).items())
    want = np.asarray(jax.jit(jm2)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(_torch(x), _torch(t)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
