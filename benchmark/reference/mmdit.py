"""
Plain reference of Stable Diffusion 3.5 Medium's MMDiT-X (Esser et al.,
arXiv 2403.03206; diffusers' ``SD3Transformer2DModel``) at a config's
``model.unet`` block, and its rectified-flow train step with the text
inputs. Parameter names follow the program's state dict (diffusers'), so
one dict of weights loads into both; every product is an ``Ops`` product
(``reference/ops.py``: f32 with TF32 off, or the fp8 control), recorded
with its shapes on the ``meta`` device.

    x    = conv_p(z) flattened + centre crop of the 2-D sin-cos table
    temb = MLP_t(sinusoid_256(t)) + MLP_p(pooled);  c = W_c tokens
    block i: adaLN-Zero (9 chunks for the dual blocks, 6 else) on x, on c
             adaLN-Zero (the last block: the continuous adaLN, scale first);
             joint attention of RMS-normed q, k over [x tokens, c tokens];
             x += gate1 a_x; dual: x += gate3 attn2(LN(x_in) (1+scale3)+shift3);
             x += gate2 FF(mod(x)); c likewise but in the last block
    out  = unpatchify(W_o (LN(x) (1 + scale) + shift))

LayerNorm (no affine, eps 1e-6), RMSNorm (eps 1e-6) and tanh-GELU are plain
f32. To fit f32 training of 2.2e9 parameters on one card, the attention
runs in blocks of ``QUERY_BLOCK`` queries and each transformer block and
each query block is recomputed in the backward (``torch.utils.checkpoint``:
the same arithmetic, so the same values); on ``meta`` (counting) neither
happens, and each attention is recorded whole.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.layers import Conv, Linear, timestep_embedding
from benchmark.reference.ops import Ops
from benchmark.reference.training import AdamW, cosine_rate

QUERY_BLOCK = 1024
EPS = 1e-6


def pos_table(dim: int, grid: int, base_size: int, device="cpu") -> torch.Tensor:
    """diffusers' ``get_2d_sincos_pos_embed(dim, grid, base_size)`` as (1,
    grid², dim) f32: positions index / (grid / base_size) in f32, row-major;
    the first half of the features encodes the column, the second the row,
    each [sin, cos] of pos · 10000^(-i / (dim / 4)) in f64."""
    pos = torch.arange(grid, dtype=torch.float32, device=device) / (grid / base_size)
    omega = 10000.0 ** (-torch.arange(dim // 4, dtype=torch.float64, device=device) / (dim / 4))
    col = pos.repeat(grid).double()
    row = pos.repeat_interleave(grid).double()
    parts = []
    for p in (col, row):
        angle = p[:, None] * omega[None, :]
        parts += [torch.sin(angle), torch.cos(angle)]
    return torch.cat(parts, dim=1).float()[None]


def layer_norm(x):
    return F.layer_norm(x.float(), (x.shape[-1],), eps=EPS)


def modulate(x, scale, shift):
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * self.weight.float()


def _grad_tensors(*ts) -> bool:
    return torch.is_grad_enabled() and not ts[0].is_meta


def attention(ops: Ops, q, k, v):
    """Ops' attention over (B, H, T, d), in query blocks outside ``meta``."""
    t = q.shape[-2]
    if q.is_meta or t <= QUERY_BLOCK:
        return ops.attention(q, k, v)
    outs = []
    for start in range(0, t, QUERY_BLOCK):
        qb = q[..., start:start + QUERY_BLOCK, :]
        outs.append(checkpoint(ops.attention, qb, k, v, use_reentrant=False)
                    if _grad_tensors(q) else ops.attention(qb, k, v))
    return torch.cat(outs, dim=-2)


class Attention(nn.Module):
    """diffusers' ``Attention`` as SD3 uses it: the image stream's to_q/k/v,
    to_out.0, norm_q/k; with ``joint`` the text stream's add_q/k/v_proj,
    norm_added_q/k and (``context_out``) to_add_out."""

    def __init__(self, ops: Ops, dim: int, heads: int, head_dim: int, joint: bool,
                 context_out: bool):
        super().__init__()
        self.ops, self.heads, self.joint = ops, heads, joint
        inner = heads * head_dim
        self.to_q, self.to_k, self.to_v = (Linear(ops, dim, inner) for _ in range(3))
        self.to_out = nn.ModuleList([Linear(ops, inner, dim)])
        self.norm_q, self.norm_k = RMSNorm(head_dim), RMSNorm(head_dim)
        if joint:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (Linear(ops, dim, inner)
                                                                 for _ in range(3))
            self.norm_added_q, self.norm_added_k = RMSNorm(head_dim), RMSNorm(head_dim)
            if context_out:
                self.to_add_out = Linear(ops, inner, dim)

    def _split(self, x):
        b, t, c = x.shape
        return x.reshape(b, t, self.heads, c // self.heads).transpose(1, 2)

    def forward(self, x, c=None):
        q = self.norm_q(self._split(self.to_q(x)))
        k = self.norm_k(self._split(self.to_k(x)))
        v = self._split(self.to_v(x))
        if self.joint:
            q = torch.cat([q, self.norm_added_q(self._split(self.add_q_proj(c)))], dim=2)
            k = torch.cat([k, self.norm_added_k(self._split(self.add_k_proj(c)))], dim=2)
            v = torch.cat([v, self._split(self.add_v_proj(c))], dim=2)
        o = attention(self.ops, q, k, v)
        o = o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)
        n = x.shape[1]
        out = self.to_out[0](o[:, :n])
        if not self.joint:
            return out
        return out, (self.to_add_out(o[:, n:]) if hasattr(self, "to_add_out") else None)


class AdaLinear(nn.Module):
    """``norm1`` / ``norm1_context`` / ``norm_out``: Linear(SiLU(temb)) in chunks."""

    def __init__(self, ops: Ops, dim: int, chunks: int):
        super().__init__()
        self.chunks = chunks
        self.linear = Linear(ops, dim, chunks * dim)

    def forward(self, temb):
        return self.linear(F.silu(temb)).chunk(self.chunks, dim=1)


class FeedForward(nn.Module):
    def __init__(self, ops: Ops, dim: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = Linear(ops, dim, 4 * dim)
        self.net = nn.ModuleList([proj, nn.Identity(), Linear(ops, 4 * dim, dim)])

    def forward(self, x):
        return self.net[2](gelu_tanh(self.net[0].proj(x)))


class Block(nn.Module):
    def __init__(self, ops: Ops, dim: int, heads: int, head_dim: int, dual: bool, last: bool):
        super().__init__()
        self.dual, self.last = dual, last
        self.norm1 = AdaLinear(ops, dim, 9 if dual else 6)
        self.norm1_context = AdaLinear(ops, dim, 2 if last else 6)
        self.attn = Attention(ops, dim, heads, head_dim, joint=True, context_out=not last)
        if dual:
            self.attn2 = Attention(ops, dim, heads, head_dim, joint=False, context_out=False)
        self.ff = FeedForward(ops, dim)
        if not last:
            self.ff_context = FeedForward(ops, dim)

    def forward(self, x, c, temb):
        e = self.norm1(temb)
        shift1, scale1, gate1, shift2, scale2, gate2 = e[:6]
        ec = self.norm1_context(temb)
        g = modulate(c, ec[0], ec[1]) if self.last else modulate(c, ec[1], ec[0])
        a_x, a_c = self.attn(modulate(x, scale1, shift1), g)
        x_in = x
        x = x + gate1[:, None] * a_x
        if self.dual:
            shift3, scale3, gate3 = e[6:]
            x = x + gate3[:, None] * self.attn2(modulate(x_in, scale3, shift3))
        x = x + gate2[:, None] * self.ff(modulate(x, scale2, shift2))
        if self.last:
            return x, c
        _, _, c_gate1, c_shift2, c_scale2, c_gate2 = ec
        c = c + c_gate1[:, None] * a_c
        c = c + c_gate2[:, None] * self.ff_context(modulate(c, c_scale2, c_shift2))
        return x, c


class MMDiT(nn.Module):
    def __init__(self, ops: Ops, unet: dict):
        super().__init__()
        heads, head_dim = int(unet["num_attention_heads"]), int(unet["attention_head_dim"])
        dim = heads * head_dim
        self.patch = int(unet["patch_size"])
        self.max_size = int(unet["pos_embed_max_size"])
        self.out_channels = int(unet["out_channels"])
        layers = int(unet["num_layers"])
        dual = set(unet["dual_attention_layers"])
        self.pos_embed = nn.Module()
        self.pos_embed.proj = Conv(ops, 2, int(unet["in_channels"]), dim, self.patch,
                                   stride=self.patch, padding=0)
        self.pos_embed.register_buffer("pos_embed", torch.empty(1, self.max_size ** 2, dim))
        self.time_text_embed = nn.Module()
        for name, width in (("timestep_embedder", 256),
                            ("text_embedder", int(unet["pooled_projection_dim"]))):
            mlp = nn.Module()
            mlp.linear_1, mlp.linear_2 = Linear(ops, width, dim), Linear(ops, dim, dim)
            setattr(self.time_text_embed, name, mlp)
        self.context_embedder = Linear(ops, int(unet["joint_attention_dim"]), dim)
        self.transformer_blocks = nn.ModuleList([
            Block(ops, dim, heads, head_dim, i in dual, i == layers - 1) for i in range(layers)])
        self.norm_out = AdaLinear(ops, dim, 2)
        self.proj_out = Linear(ops, dim, self.patch ** 2 * self.out_channels)

    @staticmethod
    def _mlp(mlp, x):
        return mlp.linear_2(F.silu(mlp.linear_1(x)))

    def forward(self, z, t, tokens, pooled):
        b, _, hh, ww = z.shape
        h, w, m = hh // self.patch, ww // self.patch, self.max_size
        x = self.pos_embed.proj(z.float()).flatten(2).transpose(1, 2)
        table = self.pos_embed.pos_embed.reshape(m, m, -1)
        top, left = (m - h) // 2, (m - w) // 2
        x = x + table[top:top + h, left:left + w].reshape(1, h * w, -1).float()
        temb = self._mlp(self.time_text_embed.timestep_embedder,
                         timestep_embedding(t.reshape(-1), 256, flip_sin_to_cos=True))
        temb = temb + self._mlp(self.time_text_embed.text_embedder, pooled.float())
        c = self.context_embedder(tokens.float())
        for block in self.transformer_blocks:
            x, c = (checkpoint(block, x, c, temb, use_reentrant=False) if _grad_tensors(x)
                    else block(x, c, temb))
        scale, shift = self.norm_out(temb)
        y = self.proj_out(modulate(x, scale, shift))
        p, co = self.patch, self.out_channels
        y = y.reshape(b, h, w, p, p, co).permute(0, 5, 1, 3, 2, 4)
        return y.reshape(b, co, h * p, w * p)


def build(ops: Ops, model_cfg: dict, in_channels: int, out_channels: int) -> nn.Module:
    return MMDiT(ops, model_cfg["unet"])


def flow_loss(model: nn.Module, x0, tokens, pooled, noise, t, num_train: int = 1000):
    """x_t = (1 - t) x0 + t eps, the model at the continuous timestep
    num_train t regressing eps - x0; the batch mean of per-sample mean
    squares, in f32."""
    x0, noise, t = x0.float(), noise.float(), t.float()
    tb = t.reshape(-1, 1, 1, 1)
    pred = model((1.0 - tb) * x0 + tb * noise, t * num_train, tokens, pooled).float()
    return torch.square(pred - (noise - x0)).mean(dim=(1, 2, 3)).mean()


def train_steps(model: nn.Module, batches: Sequence[dict], start: Dict[str, torch.Tensor], *,
                base_lr: float, weight_decay: float, warmup: int, total: int,
                start_step: int) -> dict:
    """``reference/training.py::train_steps`` on the text inputs (``x0``,
    ``tokens``, ``pooled``, ``noise``, ``t`` per batch), the change taken
    against ``start`` (the weights the model was loaded from, on any
    device)."""
    params = dict(model.named_parameters())
    opt = AdamW(params, weight_decay)
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for i, b in enumerate(batches):
        for p in params.values():
            p.grad = None
        loss = flow_loss(model, b["x0"], b["tokens"], b["pooled"], b["noise"], b["t"])
        loss.backward()
        losses.append(loss.detach().item())
        if i == 0:
            first_grad = {k: float(p.grad.norm()) if p.grad is not None else 0.0
                          for k, p in params.items()}
        opt.step(cosine_rate(start_step + i, base_lr, warmup, total))
    change = {k: float((p.detach() - start[k].to(p.device)).norm()) for k, p in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "sizes": {k: p.numel() for k, p in params.items()}}
