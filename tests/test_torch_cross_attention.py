"""The port's attention routing on CUDA and its cross-attention UNet.

``sdpa`` picks its route from the shapes and dtypes alone
(``ops.attention.kernel_route``), before any launch: K2 for self-attention
at T < 1024 and d <= 64, the flash kernels K3-K5 at Tq >= 1024 and d <= 128,
and the plain ``sdpa_xla`` for every other call, as JAX computes every call
no Pallas kernel takes with stock XLA. The routes are held here on the CPU,
where each kernel route must be one its wrapper's checks accept. The
attention-conditioned UNet (mid block ``UNetMidBlock2DCrossAttn``, the
PixelAttention diffusers config at reduced width) is held against JAX.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.sample.engine import normalize_latent_conditioning as jax_normalize
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.ops import attention
from fmdm_tpu_torch.ops.kernels import flash_attention as flash
from fmdm_tpu_torch.ops.kernels import small_t_attention as small_t
from fmdm_tpu_torch.sample.engine import normalize_latent_conditioning, prepare_attention_context
from tests.test_torch_models import F32_TOL, _pair
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401

CONFIG = (Path(__file__).resolve().parents[1] / "configs" / "LDCT" / "PixelAttention"
          / "LDCT_ddpm_attention_diffusers_nd.json")


def _qkv(q_shape, kv_tokens, dtype=torch.float32, v_dim=None):
    k_shape = q_shape[:-2] + (kv_tokens, q_shape[-1])
    v_shape = k_shape[:-1] + (v_dim or q_shape[-1],)
    return tuple(torch.zeros(s, dtype=dtype) for s in (q_shape, k_shape, v_shape))


@pytest.mark.parametrize("q_shape,kv_tokens,dtype,v_dim,route", [
    # the flagship's six calls: self-attention of 64 heads x d=8 at 16² and 8²
    ((8, 64, 256, 8), 256, torch.bfloat16, None, "K2"),
    ((8, 64, 64, 8), 64, torch.float32, None, "K2"),
    ((1, 2, 1023, 64), 1023, torch.float32, None, "K2"),
    # the KL-VAE's mid attention, a ragged T, cross-attention at long T
    ((4, 4, 1024, 64), 1024, torch.float32, None, "flash"),
    ((1, 2, 1000, 64), 1000, torch.bfloat16, None, "K2"),
    ((2, 4, 1024, 64), 77, torch.float32, None, "flash"),
    ((1, 2, 4096, 128), 4096, torch.bfloat16, None, "flash"),
    # the new routes: cross-attention at Tq < 1024 (the mid block's 8² to a
    # 32² latent, a 77-token context), self-attention with d > 64 at T < 1024,
    # d > 128 at Tq >= 1024, V of another head dim, another dtype, and more
    # batch x heads than a grid's y dimension holds
    ((1, 64, 64, 8), 1024, torch.float32, None, "sdpa_xla"),
    ((2, 8, 256, 64), 77, torch.bfloat16, None, "sdpa_xla"),
    ((2, 4, 256, 96), 256, torch.float32, None, "sdpa_xla"),
    ((1, 2, 1024, 160), 1024, torch.float32, None, "sdpa_xla"),
    ((1, 2, 1024, 64), 1024, torch.float32, 32, "sdpa_xla"),
    ((2, 4, 256, 8), 256, torch.float32, 16, "sdpa_xla"),
    ((2, 4, 256, 8), 256, torch.float16, None, "sdpa_xla"),
    ((65536, 1, 16, 8), 16, torch.float32, None, "sdpa_xla"),
])
def test_route_is_chosen_from_the_shape(q_shape, kv_tokens, dtype, v_dim, route):
    q, k, v = _qkv(q_shape, kv_tokens, dtype, v_dim)
    assert attention.kernel_route(q, k, v) == route
    # a kernel route is one the kernel's own checks take: sdpa never raises on
    # a shape JAX computes
    if route == "K2":
        small_t._validate(q, k, v)
    elif route == "flash":
        flash._validate("flash_attention", q, k, v)


def test_mixed_dtypes_take_the_plain_route():
    q, k, v = _qkv((1, 2, 64, 8), 64)
    assert attention.kernel_route(q, k.bfloat16(), v) == "sdpa_xla"
    q, k, v = _qkv((1, 2, 2048, 8), 2048)
    assert attention.kernel_route(q, k, v.bfloat16()) == "sdpa_xla"


def _reduced_attention_unet():
    cfg = json.loads(CONFIG.read_text())
    unet = dict(cfg["model"]["unet"], sample_size=64, block_out_channels=[32, 32, 64, 64, 128, 128])
    return unet, cfg["training"]["latent_norm"]


def test_cross_attention_unet_matches_jax():
    """The PixelAttention diffusers_nd config at reduced width: its mid block
    defaults to UNetMidBlock2DCrossAttn, which attends from 2² (64² input,
    five downsamplings) to a 4-channel latent context of 8 x 8 tokens,
    standardized per sample as the trainer does (``latent_norm``)."""
    unet, latent_norm = _reduced_attention_unet()
    jm = JaxFactory().build(unet, conditioning="attention", channels=1)
    tm = DiffusionUNetFactory().build(unet, conditioning="attention", channels=1, device="cpu")
    assert type(tm.mid_block).__name__ == "UNetMidBlock2DCompat"
    assert tm.mid_block.attentions[0].context_dim == 4
    params, tm = _pair(jm, tm, seed=50)
    rng = np.random.default_rng(51)
    x = rng.standard_normal((2, 1, 64, 64)).astype(np.float32)
    cond = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([5, 900], np.int32)
    ctx = np.asarray(jax_normalize(jnp.asarray(cond), latent_norm))
    want = np.asarray(jax.jit(lambda p, x, t, c: jm(p, x, t, context_ca=c))(params, x, t, ctx))
    port_ctx = prepare_attention_context(normalize_latent_conditioning(torch.from_numpy(cond),
                                                                        latent_norm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), context_ca=port_ctx)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
