"""The f32 arithmetic of the tensor-core attention kernels, emulated in numpy.

K3, K4 and K5 (and K2 on f32 inputs) compute their products on the tensor
cores in 3xTF32: each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi),
both rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero,
10 explicit mantissa bits), and a * b is taken as hi*lo + lo*hi + hi*hi, each
TF32 product exact and summed in f32 per k = 8 step of ``mma.m16n8k8``. These
tests pin why the kernels take three products: at the VAE's head geometry
the 3xTF32 attention, forward and backward, stays within ``chip_smoke.py``'s
f32 tolerance of the float64 result, where one TF32 product does not. The
emulation rounds every sum to nearest; how the tensor core rounds its
accumulator is not modelled here.
"""

import numpy as np
import pytest

from chip_smoke import TOL

RTOL, ATOL = TOL["float32"]


def tf32(x):
    """Round f32 to TF32 as cvt.rna.tf32.f32 does: add half of the dropped
    13-bit unit to the magnitude, then clear those bits."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)  # x - hi is exact in f32


def mma_matmul(pairs, k_dim: int):
    """sum over (a, b) in ``pairs`` of a @ b as the tensor core forms it: per
    k = 8 step, the step's exact products (float64) added to the f32
    accumulator, the pairs in the order given."""
    acc = None
    for k0 in range(0, k_dim, 8):
        for a, b in pairs:
            step = a[..., k0:k0 + 8].astype(np.float64) @ b[..., k0:k0 + 8, :].astype(np.float64)
            acc = step.astype(np.float32) if acc is None else (acc + step).astype(np.float32)
    return acc


def matmul_3xtf32(a, b):
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return mma_matmul([(a_hi, b_lo), (a_lo, b_hi), (a_hi, b_hi)], a.shape[-1])


def matmul_1xtf32(a, b):
    return mma_matmul([(tf32(a), tf32(b))], a.shape[-1])


def attention(q, k, v, scale, matmul):
    """out and lse of softmax(q*scale k^T) v: f32 softmax, products by ``matmul``."""
    s = matmul((q * np.float32(scale)).astype(np.float32), np.swapaxes(k, -1, -2))
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m).astype(np.float32)
    l = p.sum(-1, keepdims=True, dtype=np.float32)
    return matmul(p, v) / l, m + np.log(l)


def attention_f64(q, k, v, scale):
    s = (q.astype(np.float64) * scale) @ np.swapaxes(k, -1, -2).astype(np.float64)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    return (p @ v.astype(np.float64)) / l, m + np.log(l)


def within(got, ref) -> bool:
    return bool(np.all(np.abs(got - ref) <= ATOL + RTOL * np.abs(ref)))


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),         # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),          # below the tie rounds down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),       # a tie to an odd unit, still away
])
def test_tf32_rounds_to_nearest_ties_away(x, want):
    assert tf32(np.float32(x)) == np.float32(want)


def test_split_keeps_f32_accuracy():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi, lo = split(x)
    assert np.all(x - hi == (x.astype(np.float64) - hi.astype(np.float64)))  # exact
    # hi + lo leaves at most 2^-22 of x (two 11-bit significands, each rounded)
    assert np.all(np.abs(hi.astype(np.float64) + lo - x) <= 2.0 ** -22 * np.abs(x))
    assert np.any(lo != 0)


def test_3xtf32_attention_keeps_f32_accuracy_where_one_tf32_product_does_not():
    """(1, 2, 1024, 64), the VAE's head geometry: the emulated 3xTF32 out and
    lse are within the f32 tolerance of float64, one TF32 product's out is not."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 1024, 64)).astype(np.float32) for _ in range(3))
    scale = 64 ** -0.5
    ref_out, ref_lse = attention_f64(q, k, v, scale)

    out3, lse3 = attention(q, k, v, scale, matmul_3xtf32)
    assert within(out3, ref_out) and within(lse3, ref_lse)
    assert np.abs(out3 - ref_out).max() < 1e-6

    out1, lse1 = attention(q, k, v, scale, matmul_1xtf32)
    assert not within(out1, ref_out)
    assert np.abs(out1 - ref_out).max() > 1e-4


def backward(q, k, v, g, lse, delta, scale, matmul):
    """(dq, dk, dv) as K4 and K5 form them: p = exp(scale * q k^T - lse) scaled
    after the dot, dV = P^T dO, dS = P (dO V^T - delta), dK = scale * dS^T q,
    dQ = scale * dS k; f32 elementwise, products by ``matmul``."""
    t = lambda x: np.swapaxes(x, -1, -2)
    p = np.exp(matmul(q, t(k)) * np.float32(scale) - lse).astype(np.float32)
    ds = p * (matmul(g, t(v)) - delta)
    return (matmul(ds, k) * np.float32(scale), matmul(t(ds), q) * np.float32(scale),
            matmul(t(p), g))


def backward_f64(q, k, v, g, scale):
    """(dq, dk, dv), and the lse and delta the kernels are given, in float64."""
    q, k, v, g = (x.astype(np.float64) for x in (q, k, v, g))
    t = lambda x: np.swapaxes(x, -1, -2)
    out, lse = attention_f64(q, k, v, scale)
    delta = (g * out).sum(-1, keepdims=True)
    p = np.exp((q @ t(k)) * scale - lse)
    ds = p * (g @ t(v) - delta)
    return (ds @ k * scale, t(ds) @ q * scale, t(p) @ g), lse, delta


def test_3xtf32_backward_keeps_f32_accuracy_where_one_tf32_product_does_not():
    """(1, 2, 1024, 64): dq, dk and dv of the emulated 3xTF32 backward, from
    the float64 lse and delta rounded to f32, are within the f32 tolerance of
    float64; with one TF32 product each of them falls outside. So the
    backward's four and three products take three TF32 products each too."""
    rng = np.random.default_rng(1)
    q, k, v, g = (rng.standard_normal((1, 2, 1024, 64)).astype(np.float32) for _ in range(4))
    scale = 64 ** -0.5
    want, lse, delta = backward_f64(q, k, v, g, scale)
    lse, delta = lse.astype(np.float32), delta.astype(np.float32)

    got3 = backward(q, k, v, g, lse, delta, scale, matmul_3xtf32)
    got1 = backward(q, k, v, g, lse, delta, scale, matmul_1xtf32)
    for name, a3, a1, ref in zip(("dq", "dk", "dv"), got3, got1, want):
        assert within(a3, ref), name
        assert np.abs(a3 - ref).max() < 2e-6, name
        assert not within(a1, ref), name
        assert np.abs(a1 - ref).max() > 1e-4, name
