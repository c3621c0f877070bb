"""Plain f32 torch of Stable Diffusion 3.5's MMDiT-X forward and its
rectified-flow loss, written from the equations of Esser et al. (arXiv
2403.03206) and diffusers' ``SD3Transformer2DModel`` as functions of a dict
of weights under diffusers' names. Test-only: it imports neither JAX nor
any module of ``fmdm_tpu_torch``, and shares no code with either.

    x    = conv_p(z) flattened + crop(sincos table)
    temb = MLP_t(sinusoid_256(t)) + MLP_p(pooled)
    c    = W_c tokens
    block i: adaLN-Zero(-X) modulations of x and c, joint attention (RMS-
             normed q, k; image tokens then text tokens), gated residuals,
             for dual blocks an image-only attention, tanh-GELU MLPs;
             the last block keeps no text stream
    out  = unpatchify(W_o (LN(x) (1 + scale) + shift))
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def sincos_table(dim: int, grid: int, base_size: int) -> torch.Tensor:
    """(grid², dim): columns in the first half, rows in the second, each
    [sin, cos]; positions in f32 as index / (grid / base_size), the rest in
    f64 (diffusers' ``get_2d_sincos_pos_embed``)."""
    pos = np.arange(grid, dtype=np.float32) / np.float32(grid / base_size)
    col = np.tile(pos[None, :], (grid, 1)).reshape(-1).astype(np.float64)
    row = np.tile(pos[:, None], (1, grid)).reshape(-1).astype(np.float64)
    omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float64) / (dim / 4))
    parts = []
    for p in (col, row):
        ang = p[:, None] * omega[None, :]
        parts += [np.sin(ang), np.cos(ang)]
    return torch.from_numpy(np.concatenate(parts, axis=1)).float()


def lin(w, name, x):
    return x @ w[name + ".weight"].t() + w[name + ".bias"]


def ln(x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6)


def rms(x, weight):
    return x / torch.sqrt((x ** 2).mean(-1, keepdim=True) + 1e-6) * weight


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def attention(q, k, v):
    """softmax(q kᵀ / √d) v over (B, H, T, d)."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return torch.softmax(s, dim=-1) @ v


def heads(x, n):
    b, t, c = x.shape
    return x.reshape(b, t, n, c // n).transpose(1, 2)


def merge(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def forward(w, cfg, z, t, tokens, pooled):
    """The model's output (B, C, H, W) for latents z, timesteps t (the
    model's input: 1000 sigma), text tokens and the pooled vector."""
    p, n = cfg["patch_size"], cfg["num_attention_heads"]
    dim = n * cfg["attention_head_dim"]
    b, _, hh, ww = z.shape
    h, wd = hh // p, ww // p
    x = F.conv2d(z, w["pos_embed.proj.weight"], w["pos_embed.proj.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    m = cfg["pos_embed_max_size"]
    table = sincos_table(dim, m, cfg["sample_size"] // p).reshape(m, m, dim)
    top, left = (m - h) // 2, (m - wd) // 2
    x = x + table[top:top + h, left:left + wd].reshape(1, h * wd, dim)

    half = 128
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half)
    ang = t.float()[:, None] * freqs[None]
    sinus = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)
    temb = lin(w, "time_text_embed.timestep_embedder.linear_2",
               F.silu(lin(w, "time_text_embed.timestep_embedder.linear_1", sinus)))
    temb = temb + lin(w, "time_text_embed.text_embedder.linear_2",
                      F.silu(lin(w, "time_text_embed.text_embedder.linear_1", pooled)))
    c = lin(w, "context_embedder", tokens)
    st = F.silu(temb)

    def mod(u, scale, shift):
        return ln(u) * (1 + scale[:, None]) + shift[:, None]

    def mlp(prefix, u):
        return lin(w, prefix + ".net.2", gelu_tanh(lin(w, prefix + ".net.0.proj", u)))

    layers = cfg["num_layers"]
    for i in range(layers):
        pre = f"transformer_blocks.{i}."
        dual = i in cfg["dual_attention_layers"]
        last = i == layers - 1
        e = lin(w, pre + "norm1.linear", st).chunk(9 if dual else 6, dim=1)
        sh1, sc1, g1, sh2, sc2, g2 = e[:6]
        hx = mod(x, sc1, sh1)
        if dual:
            sh3, sc3, g3 = e[6:]
            h3 = mod(x, sc3, sh3)
        ec = lin(w, pre + "norm1_context.linear", st)
        if last:
            csc, csh = ec.chunk(2, dim=1)
            hc = mod(c, csc, csh)
        else:
            csh1, csc1, cg1, csh2, csc2, cg2 = ec.chunk(6, dim=1)
            hc = mod(c, csc1, csh1)
        a = pre + "attn."
        q = rms(heads(lin(w, a + "to_q", hx), n), w[a + "norm_q.weight"])
        k = rms(heads(lin(w, a + "to_k", hx), n), w[a + "norm_k.weight"])
        v = heads(lin(w, a + "to_v", hx), n)
        qc = rms(heads(lin(w, a + "add_q_proj", hc), n), w[a + "norm_added_q.weight"])
        kc = rms(heads(lin(w, a + "add_k_proj", hc), n), w[a + "norm_added_k.weight"])
        vc = heads(lin(w, a + "add_v_proj", hc), n)
        o = merge(attention(torch.cat([q, qc], 2), torch.cat([k, kc], 2), torch.cat([v, vc], 2)))
        tx = x.shape[1]
        x = x + g1[:, None] * lin(w, a + "to_out.0", o[:, :tx])
        if dual:
            a2 = pre + "attn2."
            q2 = rms(heads(lin(w, a2 + "to_q", h3), n), w[a2 + "norm_q.weight"])
            k2 = rms(heads(lin(w, a2 + "to_k", h3), n), w[a2 + "norm_k.weight"])
            v2 = heads(lin(w, a2 + "to_v", h3), n)
            x = x + g3[:, None] * lin(w, a2 + "to_out.0", merge(attention(q2, k2, v2)))
        x = x + g2[:, None] * mlp(pre + "ff", mod(x, sc2, sh2))
        if not last:
            c = c + cg1[:, None] * lin(w, a + "to_add_out", o[:, tx:])
            c = c + cg2[:, None] * mlp(pre + "ff_context", mod(c, csc2, csh2))
    sc, sh = lin(w, "norm_out.linear", st).chunk(2, dim=1)
    y = lin(w, "proj_out", mod(x, sc, sh))
    co = y.shape[-1] // (p * p)
    y = y.reshape(b, h, wd, p, p, co).permute(0, 5, 1, 3, 2, 4)
    return y.reshape(b, co, h * p, wd * p)


def flow_loss(w, cfg, x0, noise, t, tokens, pooled):
    """Rectified flow: x_t = (1 - t) x0 + t eps, the model at 1000 t
    regressing eps - x0; the batch mean of per-sample mean squares."""
    tb = t.reshape(-1, 1, 1, 1)
    pred = forward(w, cfg, (1 - tb) * x0 + tb * noise, 1000.0 * t, tokens, pooled)
    return ((pred - (noise - x0)) ** 2).mean(dim=(1, 2, 3)).mean()
