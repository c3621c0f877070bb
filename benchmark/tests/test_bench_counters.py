"""The counters of operations and bytes, the published peaks and the trace
readers, against hand-worked values: one 3x3 conv, one 3x3x3 conv, one
GroupNorm call, one attention call; every roofline and mfu formula at or
under 100% on those inputs; the kernel classes pinned on names the H100's
traces show."""

import dataclasses
import math
from pathlib import Path

import pytest
import torch

from benchmark import counters, devtrace, peaks
from benchmark.harness import Bench, TraceReading
from benchmark.reference.ops import Op, Ops

ROOT = Path(__file__).resolve().parents[2]
BF16 = 2


def kernel_calls(ops):
    """Calls per forward that the program sends to its kernels."""
    return {"k1": sum(op.kind == "group_norm" and op.kernel for op in ops),
            "k2": sum(counters.attention_route(op) == "k2" for op in ops),
            "flash": sum(counters.attention_route(op) == "flash" for op in ops)}


def record(fn, *args, **kw):
    rec = []
    fn(Ops(recorder=rec), *args, **kw)
    return rec


def test_conv_3x3():
    x = torch.zeros(2, 4, 8, 8, requires_grad=True)
    w, b = torch.zeros(6, 4, 3, 3), torch.zeros(6)
    (op,) = record(lambda o: o.conv(x, w, b, 1, 1))
    # every output element: 4 channels x 9 taps
    assert op.macs == 2 * 6 * 8 * 8 * 4 * 9
    assert (op.x, op.w, op.y) == (2 * 4 * 64, 6 * 4 * 9, 2 * 6 * 64)
    assert counters.product_flops(op, train=False) == 2 * op.macs
    # backward: wgrad, and dgrad as the input needs a gradient
    assert counters.product_flops(op, train=True) == 6 * op.macs
    want = max(2 * op.macs / peaks.BF16_FLOPS, (op.x + op.w + op.y) * BF16 / peaks.HBM_BYTES)
    assert counters.conv_bound_s([op], False, "bfloat16") == pytest.approx(want)
    assert counters.conv_bound_s([op], True, "bfloat16") == pytest.approx(3 * want)


def test_conv_3x3x3_without_input_gradient():
    x = torch.zeros(1, 2, 4, 8, 8)
    w, b = torch.zeros(3, 2, 3, 3, 3), torch.zeros(3)
    (op,) = record(lambda o: o.conv(x, w, b, 1, 1))
    assert op.macs == 3 * 4 * 8 * 8 * 2 * 27
    assert not op.grad_input
    assert counters.product_flops(op, train=True) == 4 * op.macs   # no dgrad


def test_group_norm_k1_bytes():
    x = torch.zeros(2, 64, 16, 16)
    w, b = torch.ones(64), torch.zeros(64)
    scale, shift = torch.zeros(2, 64), torch.zeros(2, 64)
    (op,) = record(lambda o: o.group_norm(x, w, b, 32, 1e-5, act=True, scale=scale, shift=shift,
                                          kernel=True))
    n = 2 * 64 * 256
    # x read, y written (bf16), the f32 affine, the FiLM's scale and shift
    moved = 2 * n * BF16 + 2 * 64 * 4 + 2 * 2 * 64 * BF16
    assert counters.k1_bound_s([op], "bfloat16") == pytest.approx(moved / peaks.HBM_BYTES)
    plain = Op("group_norm", x=n, y=n, w=128, kernel=False)
    assert counters.k1_bound_s([plain], "bfloat16") == 0.0


def test_attention_counts_and_routes():
    q = torch.zeros(2, 4, 256, 8)
    (op,) = record(lambda o: o.attention(q, q, q))
    assert op.macs == 2 * 4 * 256 * 256 * (8 + 8)
    assert counters.attention_route(op) == "k2"
    fwd = max(2 * op.macs / peaks.BF16_FLOPS, 4 * q.numel() * BF16 / peaks.HBM_BYTES)
    assert counters.attention_bound_s([op], "k2", False, "bfloat16") == pytest.approx(fwd)
    long_q = torch.zeros(1, 2, 1024, 32)
    (long_op,) = record(lambda o: o.attention(long_q, long_q, long_q))
    assert counters.attention_route(long_op) == "flash"
    bwd = max(4 * long_op.macs / peaks.BF16_FLOPS, 8 * long_q.numel() * BF16 / peaks.HBM_BYTES)
    fwd = max(2 * long_op.macs / peaks.BF16_FLOPS, 4 * long_q.numel() * BF16 / peaks.HBM_BYTES)
    assert counters.attention_bound_s([long_op], "flash", True, "bfloat16") == \
        pytest.approx(fwd + bwd)
    assert kernel_calls([op, long_op]) == {"k1": 0, "k2": 1, "flash": 1}


@pytest.mark.parametrize("name,calls,gflop", [
    # 32 ResBlocks x 2 K1 calls; K2 at 16x16 (2 down, 3 up) and in the middle;
    # BENCHMARKS.md's sanity range for one forward: ~493 GFLOP per image
    ("ldct_unet2d_flow", {"k1": 64, "k2": 6, "flash": 0}, (400, 600)),
    # 17 ResBlocks x 2; the middle's softmax attention at 2048 tokens
    ("volume3d_efficientunet", {"k1": 34, "k2": 0, "flash": 1}, (700, 1100)),
])
def test_forward_counts_at_published_widths(name, calls, gflop):
    import json

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    ops = counters.record_forward(cfg, 1, train=False)
    assert kernel_calls(ops) == calls
    assert gflop[0] * 1e9 < counters.flops(ops, train=False) < gflop[1] * 1e9


def reading(ops, train, **kw):
    base = dict(train=train, forwards_per_unit=1, timed_units=1, timed_s=1.0, units=1,
                window_s=1.0, busy_s=1.0, kernel_s={}, class_s={}, ops=ops, dtype="bfloat16",
                peak_bytes=1)
    base.update(kw)
    return TraceReading(**base)


@pytest.mark.parametrize("train", [False, True])
def test_rooflines_at_most_100_at_their_bound(train):
    """With each kernel class taking exactly its least time, every share
    reads 100%, and less for any longer time; mfu reads 100% when the
    untraced window is the products' time at the peak."""
    x = torch.zeros(2, 4, 8, 8, requires_grad=train)
    ops = record(lambda o: o.conv(x, torch.zeros(6, 4, 3, 3), torch.zeros(6), 1, 1))
    ops += record(lambda o: o.group_norm(x, torch.ones(4), torch.zeros(4), 2, 1e-5, act=True,
                                         kernel=True))
    q = torch.zeros(1, 2, 64, 8)
    ops += record(lambda o: o.attention(q, q, q))
    q2 = torch.zeros(1, 2, 1024, 32)
    ops += record(lambda o: o.attention(q2, q2, q2))
    bench = Bench(ROOT)
    bounds = {"convolution": counters.conv_bound_s(ops, train, "bfloat16"),
              "K1 group_norm_act": counters.k1_bound_s(ops, "bfloat16"),
              "K2 small_t_attention": counters.attention_bound_s(ops, "k2", False, "bfloat16")}
    flash = counters.attention_bound_s(ops, "flash", train, "bfloat16")
    bounds.update({k: flash / 3 for k in devtrace.FLASH})
    for slack, cap in ((1.0, 100.0), (1.5, 100.0 / 1.5)):
        r = reading(ops, train, class_s={k: v * slack for k, v in bounds.items()})
        for name in ("conv_roofline", "k1_roofline", "k2_roofline", "flash_roofline"):
            assert bench.reader(name).read(r) == pytest.approx(cap)
    work = counters.flops(ops, train)
    r = reading(ops, train, timed_units=3, timed_s=3 * work / peaks.BF16_FLOPS)
    assert bench.reader("mfu.train").read(r) == pytest.approx(100.0)
    slower = dataclasses.replace(r, timed_s=6 * work / peaks.BF16_FLOPS)
    assert bench.reader("mfu.train").read(slower) == pytest.approx(50.0)
    assert bench.reader("device_idle_pct.train").read(reading(ops, train, busy_s=0.25)) == 75.0
    busy = reading(ops, train, busy_s=0.25, units=5)
    assert bench.reader("device_busy_ms.train").read(busy) == pytest.approx(50.0)
    # nothing timed or no device activity traced: nothing to read
    assert bench.reader("mfu.sample").read(reading(ops, train, timed_units=0)) is None
    assert bench.reader("device_idle_pct.sample").read(reading(ops, train, busy_s=0.0)) is None
    assert bench.reader("device_busy_ms.sample").read(reading(ops, train, busy_s=0.0)) is None
    assert bench.reader("conv_roofline.sample").read(reading(ops, train)) is None


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::gn_cluster<__nv_bfloat16, __nv_bfloat16, true>(", "K1 group_norm_act"),
    ("void (anonymous namespace)::flash_fwd<__nv_bfloat16, 32>(__nv_bfloat16 const*", "K3 flash_forward"),
    ("void small_t_attention<__nv_bfloat16, 8>(", "K2 small_t_attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32", "convolution"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float", "convolution"),
    ("void cudnn::cnn::wgrad2d_grouped_direct_kernel<true, true, int, __nv_bfloat16, float", "convolution"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>", "elementwise and copies"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::direct_copy", "elementwise and copies"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<", "elementwise and copies"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float", "elementwise and copies"),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_coopA_NNT", "matrix product"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<", "optimizer (foreach)"),
])
def test_kernel_classes(name, label):
    assert devtrace.classify(name) == label


def test_busy_is_the_union_of_intervals():
    t = devtrace.Trace.__new__(devtrace.Trace)
    t.device = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 30.0, "a")]
    t.host = [(12.0, 19.0, "cudaLaunchKernel")]
    assert t.device_busy_s() == pytest.approx(22e-6)
    assert t.kernel_seconds() == {"a": pytest.approx(20e-6), "b": pytest.approx(7e-6)}
    out = t.breakdown(window_s=40e-6)
    assert dict(out["idle_gaps"]) == {"cudaLaunchKernel": pytest.approx(8e-6),
                                      "window edges": pytest.approx(10e-6)}
    assert math.isclose(sum(s for _, s in out["device_ops"]), 27e-6)
