"""Stable Diffusion 3.5's MMDiT-X in the port (``models/mmdit.py``,
``nn/transformer_blocks.py``) against the plain f32 oracle of
``tests/oracles/mmdit_torch.py`` on the CPU, at a tiny size with every kind
of block (a dual block, a plain one, the last, text-dropping one): the
forward, a rectified-flow train step's loss and gradients through
``make_denoise_train_step`` (text conditioning, continuous timestep), the
logit-normal draw, a 3-step ``SamplingEngine`` call, the position table's
crop, the spans; and the flagship's ``chunk_loss``, bitwise as it was.

Tolerances: both sides run in f32 and differ only in the order of their
sums (the port's fused layer norm, ``addcmul`` and attention path against
the oracle's plain expressions): the forward reads 1.8e-7 of its largest
value, the worst gradient 7.9e-7, the loss 0. ``TOL`` = 2e-5 is 25x that.
The same tests with the model in bf16 read 7.7e-3 (forward), 2.8e-2
(gradient) and 2.3e-4 (loss): each fails by 10x or more."""

import json
import math
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn import transformer_blocks as tb
from fmdm_tpu_torch.ops.kernels import flash_attention
from fmdm_tpu_torch.sample.engine import SamplingEngine
from fmdm_tpu_torch.schedulers.registry import build_scheduler
from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step
from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer
from fmdm_tpu_torch.utils import trace
from tests.oracles import mmdit_torch as oracle

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "flow_matching" / "sd35_medium_mmdit.json"
TINY = {"unet_impl": "sd3_mmdit", "num_layers": 3, "num_attention_heads": 2,
        "attention_head_dim": 32, "caption_projection_dim": 64, "patch_size": 2,
        "in_channels": 4, "out_channels": 4, "sample_size": 8, "pos_embed_max_size": 8,
        "joint_attention_dim": 24, "pooled_projection_dim": 16, "dual_attention_layers": [0],
        "qk_norm": "rms_norm"}
B, S = 2, 5
TOL = 2e-5


def tiny_model():
    model = DiffusionUNetFactory().build(TINY, "text", 4, device="cpu")
    gen = torch.Generator().manual_seed(3)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            if p.dim() == 1 and not name.endswith(".bias"):   # a norm's scale
                p.uniform_(0.9, 1.1, generator=gen)
                continue
            weight = p if p.dim() >= 2 else params[name[:-len("bias")] + "weight"]
            bound = 1 / math.sqrt(math.prod(weight.shape[1:]))
            p.uniform_(-bound, bound, generator=gen)
    return model


def weights(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 4, 8, 8, generator=gen), torch.randn(B, S, 24, generator=gen),
            torch.randn(B, 16, generator=gen))


def close(got, want, tol=TOL):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30)) <= tol


def test_forward_matches_the_oracle():
    model = tiny_model()
    z, tokens, pooled = inputs()
    t = torch.tensor([137.5, 912.25])
    with torch.no_grad():
        got = model(z, t, context_ca=(tokens, pooled))
        want = oracle.forward(weights(model), TINY, z, t, tokens, pooled)
    assert got.shape == (B, 4, 8, 8)
    assert close(got, want), float((got - want).abs().max())


def _train_step(model, compute_dtype=torch.float32):
    scheduler, _ = build_scheduler({"name": "flowmatch", "num_train_timesteps": 1000}, {})
    optimizer, rate = make_adamw(model.parameters(), 1e-4, 0.0, 0, 10)
    return make_denoise_train_step(model, scheduler, optimizer, rate, variant="flow_matching",
                                   conditioning_mode="text", latent_norm=None,
                                   compute_dtype=compute_dtype, device="cpu",
                                   t_sampling="logit_normal", timestep_input="continuous")


def test_train_step_loss_and_gradients_match_the_oracle():
    model = tiny_model()
    w = {k: v.requires_grad_(True) for k, v in weights(model).items()}
    x0, tokens, pooled = inputs(1)
    gen = torch.Generator().manual_seed(2)
    noise, t = torch.randn(x0.shape, generator=gen), torch.sigmoid(torch.randn(B, generator=gen))
    step = _train_step(model)
    loss_sum, count = step.step({"target": x0, "text": (tokens, pooled), "valid": torch.ones(B)},
                                noise=noise, t=t)
    want = oracle.flow_loss(w, TINY, x0, noise, t, tokens, pooled)
    want.backward()
    assert float(count) == B
    want = float(want.detach())
    assert abs(float(loss_sum) / B - want) <= TOL * want
    for name, p in model.named_parameters():
        assert close(p.grad, w[name].grad), name


def test_logit_normal_draw():
    """sigmoid of N(0, 1): logit(t) has mean 0 and std 1; t's median is 1/2.
    At 2e5 draws the sampling error of each moment is ~0.002-0.003; the
    bounds are 5x it."""
    step = _train_step(tiny_model())
    t = step._draw_t(200_000, torch.Generator().manual_seed(5)).double()
    logit = torch.log(t / (1 - t))
    assert ((0 < t) & (t < 1)).all()
    assert abs(float(logit.mean())) < 0.012 and abs(float(logit.std()) - 1) < 0.012
    assert abs(float(t.median()) - 0.5) < 0.006


def test_three_sampling_steps_match_the_oracle():
    """flowmatch Euler at shift 3.0: x <- x + (sigma_next - sigma) v at the
    model's timestep 1000 sigma, three steps, the text context in each."""
    model = tiny_model()
    z, tokens, pooled = inputs(2)
    scheduler, _ = build_scheduler({"name": "flowmatch", "num_train_timesteps": 1000,
                                    "params": {"shift": 3.0}}, {})
    assert scheduler.shift == 3.0
    timesteps = scheduler.set_timesteps(3)
    engine = SamplingEngine(model, scheduler, timesteps, conditioning_mode="text", device="cpu")
    got = engine(z.shape, conditioning_batch=(tokens, pooled), init_sample=z)
    w = weights(model)
    sigmas = [float(s) / 1000 for s in timesteps] + [0.0]
    x = z
    with torch.no_grad():
        for i in range(3):
            v = oracle.forward(w, TINY, x, torch.full((B,), float(timesteps[i])), tokens, pooled)
            x = x + (sigmas[i + 1] - sigmas[i]) * v
    assert close(got, x)


@pytest.mark.parametrize("patches", [(4, 4), (3, 2)])
def test_position_table_crop(patches):
    """The centre crop of the 8x8 table (top = left = (8 - h) // 2) against
    the oracle's table, and diffusers' grid: index / (grid / base_size)."""
    h, w = patches
    table = tb.sincos_table_2d(64, 8, 4)
    want = oracle.sincos_table(64, 8, 4).reshape(8, 8, 64)
    top, left = (8 - h) // 2, (8 - w) // 2
    got = tb.crop_table(table[None], 8, h, w)
    assert got.shape == (1, h * w, 64)
    assert torch.equal(got[0], want[top:top + h, left:left + w].reshape(h * w, 64))
    assert float(table[8 * 3 + 5, 0]) == pytest.approx(math.sin(5 / 2), abs=1e-6)
    assert float(table[8 * 3 + 5, 32]) == pytest.approx(math.sin(3 / 2), abs=1e-6)


def test_spans_of_one_forward_and_backward(monkeypatch):
    """Per forward: one ``mmdit.joint_attention`` per block, one
    ``mmdit.self_attention`` per dual block, one ``mmdit.adaln`` per LayerNorm
    (4 a block, 3 in the last, 1 at the output); ``flash.backward`` per
    backward of the flash kernels' autograd Function (the CPU's ``sdpa``
    never reaches it, so it is called directly here)."""
    model = tiny_model()
    z, tokens, pooled = inputs()
    q = torch.randn(1, 2, 8, 4, requires_grad=True)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        model(z, torch.tensor([1.0, 2.0]), context_ca=(tokens, pooled))
        flash_attention.flash_attention(q, q, q).sum().backward()
    names = [s.name for s in trace.spans()]
    trace.clear()
    assert {n: names.count(n) for n in set(names)} == {
        "mmdit.joint_attention": 3, "mmdit.self_attention": 1, "mmdit.adaln": 12,
        "flash.backward": 1}


def test_sd35_medium_builds_from_its_config():
    cfg = json.loads(CONFIG.read_text())
    model = DiffusionUNetFactory().build(cfg["model"]["unet"], "text", 16, device="meta")
    names = list(model.state_dict())
    assert sum(p.numel() for p in model.parameters()) == 2_243_171_520
    assert len(model.transformer_blocks) == 24
    assert [i for i, b in enumerate(model.transformer_blocks) if b.dual] == list(range(13))
    for name in ("pos_embed.pos_embed", "pos_embed.proj.weight", "context_embedder.weight",
                 "time_text_embed.timestep_embedder.linear_1.weight",
                 "time_text_embed.text_embedder.linear_2.bias",
                 "transformer_blocks.0.attn2.norm_q.weight",
                 "transformer_blocks.0.norm1.linear.weight",
                 "transformer_blocks.22.attn.to_add_out.weight",
                 "transformer_blocks.23.norm1_context.linear.weight",
                 "transformer_blocks.5.ff_context.net.0.proj.weight", "norm_out.linear.weight",
                 "proj_out.weight"):
        assert name in names, name
    assert not any(n.startswith("transformer_blocks.23.attn.to_add_out") or
                   n.startswith("transformer_blocks.23.ff_context") or
                   n.startswith("transformer_blocks.13.attn2") for n in names)
    assert tuple(model.state_dict()["pos_embed.pos_embed"].shape) == (1, 384 * 384, 1536)
    assert tuple(model.state_dict()["transformer_blocks.0.norm1.linear.weight"].shape) == \
        (9 * 1536, 1536)


def test_trainer_reads_the_recipe_from_the_config():
    cfg = json.loads(CONFIG.read_text())
    cfg["model"]["unet"] = TINY
    _, _, step = build_denoise_trainer(cfg, variant="flow_matching", num_samples=4, device="cpu")
    assert (step.conditioning_mode, step.t_sampling, step.timestep_input) == (
        "text", "logit_normal", "continuous")
    with pytest.raises(ValueError, match="flow matching only"):
        make_denoise_train_step(tiny_model(), None, None, None, variant="diffusion",
                                conditioning_mode="text", latent_norm=None, device="cpu",
                                t_sampling="logit_normal")


def test_flagship_chunk_loss_is_bitwise_unchanged():
    """The concatenated-conditioning flow loss, restated as it was before the
    text conditioning: int32 timesteps t (N - 1), the conditioning stacked on
    the input's channels."""
    cfg = {"unet_impl": "diffusers_nd", "block_out_channels": [8, 16], "norm_num_groups": 4,
           "layers_per_block": 1, "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
           "up_block_types": ["AttnUpBlock2D", "UpBlock2D"]}
    torch.manual_seed(0)
    model = DiffusionUNetFactory().build(cfg, "concatenate", 1, device="cpu")
    scheduler, _ = build_scheduler({"name": "flowmatch", "num_train_timesteps": 1000}, {})
    optimizer, rate = make_adamw(model.parameters(), 1e-4, 0.0, 0, 10)
    step = make_denoise_train_step(model, scheduler, optimizer, rate, variant="flow_matching",
                                   conditioning_mode="concatenate", latent_norm=None,
                                   device="cpu")
    gen = torch.Generator().manual_seed(4)
    x0, cond, noise = (torch.randn(2, 1, 8, 8, generator=gen) for _ in range(3))
    t, valid = torch.rand(2, generator=gen), torch.tensor([1.0, 0.0])
    _, loss_sum, count = step.chunk_loss(x0, cond, valid, noise, t)
    tb_ = t.reshape(-1, 1, 1, 1)
    pred = model(torch.cat([(1 - tb_) * x0 + tb_ * noise, cond], dim=1),
                 (t * 999).to(torch.int32), context_ca=None).float()
    want = (torch.square(pred - (noise - x0)).mean(dim=(1, 2, 3)) * valid).sum()
    assert torch.equal(loss_sum, want) and float(count) == 1.0
