"""K1's backward kernels on the card, against the plain backward.

Every test here needs a CUDA card and skips without one (the file's autouse
fixture). The file imports no JAX, so it runs on a machine without it:
``python -m pytest tests/test_torch_group_norm_backward_card.py --noconftest -q``
(``--noconftest``: ``tests/conftest.py`` imports JAX).

The yardstick is the plain backward evaluated in f32 on the same values and
rounded once to each gradient's dtype. In f32 the kernels agree with it to
1e-5 of each gradient's largest magnitude. In bf16, dx, dscale and dshift are
within one bf16 ulp of it (or that f32 tolerance near zero); the plain
backward run in bf16 rounds x's gradient three times and adds the parts in
bf16, so the kernel must be at least as near the f32 gradient as it.
"""

import json
from pathlib import Path

import pytest
import torch

FLOW_CONFIG = (Path(__file__).resolve().parents[1] / "configs" / "LDCT"
               / "LDCT_flow_matching_diffusers_nd.json")
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")


def _draw(shape, dtype, film, seed):
    gen = torch.Generator().manual_seed(seed)
    n, c = shape[:2]
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.5).to(dtype).cuda()
    dy = torch.randn(shape, generator=gen).to(dtype).cuda()
    w = (1 + 0.1 * torch.randn(c, generator=gen)).cuda()
    b = (0.1 * torch.randn(c, generator=gen)).cuda()
    s = (0.2 * torch.randn((n, c), generator=gen)).to(dtype).cuda() if film else None
    t = (0.2 * torch.randn((n, c), generator=gen)).to(dtype).cuda() if film else None
    return x, dy, w, b, s, t


def _f32(t):
    return None if t is None else t.float()


def _ulps_ok(got, want, floor):
    """bf16 ``got`` at most one ulp of ``want`` from it, or within ``floor``."""
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool(((got.float() - want).abs() <= torch.maximum(ulp, torch.tensor(floor))).all())


# (shape, dtype, FiLM, split): the flagship's and the volume's largest calls
# at their train batches, a FiLM call of the volume, a 512 KB group with
# FiLM, the f32 VAE's 2 MB group through the wrapper's plan and through the
# split, 7x7 (no vectors) and a 2 KB group
CASES = [((16, 256, 256, 256), torch.bfloat16, False, False),
         ((4, 192, 8, 128, 128), torch.bfloat16, False, False),
         ((4, 64, 8, 128, 128), torch.bfloat16, True, False),
         ((16, 128, 256, 256), torch.bfloat16, True, False),
         ((4, 256, 256, 256), torch.float32, False, False),
         ((4, 256, 256, 256), torch.float32, True, True),
         ((3, 96, 7, 7), torch.bfloat16, True, False),
         ((16, 512, 8, 8), torch.bfloat16, False, False)]


@pytest.mark.parametrize("shape,dtype,film,split", CASES)
def test_kernel_backward_matches_the_plain_one(shape, dtype, film, split):
    from fmdm_tpu_torch.ops.kernels.group_norm import (
        K1B, _launch_backward, backward_split_plan, group_norm_act_backward_reference,
        vector_aligned)

    x, dy, w, b, s, t = _draw(shape, dtype, film, seed=sum(shape))
    args = (x, w, b, s, t, 32, 1e-5, True)
    p = None
    if split:
        hw = x[0, 0].numel()
        p = backward_split_plan(shape[1] // 32 * hw, hw, x.element_size(),
                                vector_aligned(x, torch.empty_like(x)), shape[0] * 32)
    K1B.reset()
    first = _launch_backward(dy, *args, p=p)
    second = _launch_backward(dy, *args, p=p)
    torch.cuda.synchronize()
    assert K1B.launches == 2 and K1B.variants["split" if split else "single_pass"] == 2
    for g1, g2 in zip(first, second):
        assert (g1 is None) == (g2 is None)
        if g1 is not None:
            assert torch.equal(g1, g2), "two calls on the same inputs differ"
    truth = group_norm_act_backward_reference(_f32(dy), _f32(x), w, b, _f32(s), _f32(t), 32,
                                              1e-5, True)
    for name, got, want in zip(("dx", "dweight", "dbias", "dscale", "dshift"), first, truth):
        if want is None:
            assert got is None
            continue
        scale = float(want.abs().max())
        err = float((got.float() - want).abs().max()) / scale
        if got.dtype == torch.float32:
            assert err <= F32_TOL, f"{name}: {err:.3e} of the largest magnitude"
        else:
            assert _ulps_ok(got, want.to(got.dtype), F32_TOL * scale), f"{name}: {err:.3e}"
    if dtype == torch.bfloat16:
        plain = group_norm_act_backward_reference(dy, x, w, b, s, t, 32, 1e-5, True)
        assert float((first[0].float() - truth[0]).abs().max()) \
            <= float((plain[0].float() - truth[0]).abs().max())


# scripts/bench_3d.py's 3D EfficientUNetND, on 8x128² volumes
UNET_3D = {"unet_impl": "efficient_nd", "spatial_dims": 3, "in_channels": 1, "out_channels": 1,
           "model_channels": 64, "num_res_blocks": 2, "channel_mult": [1, 2, 4],
           "attention_resolutions": [4], "num_heads": 8, "dim_head": 32,
           "use_scale_shift_norm": True}
MODELS = {"flagship": (lambda: json.loads(FLOW_CONFIG.read_text())["model"]["unet"], (256, 256)),
          "3D": (lambda: UNET_3D, (8, 128, 128))}


@pytest.mark.parametrize("which,calls", [("flagship", 64), ("3D", 34)])
def test_a_train_step_runs_one_kernel_backward_per_k1_call(which, calls):
    """The flagship's and the volume's bf16 forward and backward: as many
    single-pass K1 backward launches as K1 forward calls, 64 and 34."""
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
    from fmdm_tpu_torch.ops.kernels.group_norm import K1, K1B

    unet, spatial = MODELS[which]
    model = DiffusionUNetFactory().build(unet(), conditioning="concatenate", channels=1,
                                         device="cuda")
    x = torch.randn((1, model.in_channels) + spatial, device="cuda").to(torch.bfloat16)
    t = torch.tensor([500], dtype=torch.int32, device="cuda")
    K1.reset()
    K1B.reset()
    model(x, t).float().square().mean().backward()
    torch.cuda.synchronize()
    assert K1.launches == calls
    assert K1B.launches == calls and K1B.variants == {"single_pass": calls, "split": 0}
