"""
K1's plan candidates, forward and backward, timed on one CUDA card.

    python -m fmdm_tpu_torch.ops.kernels.group_norm_report [--seed 0]

For each group size of the main paths (bf16 at the sample's batch 8, f32 at
the VAE's batch 4), times the single-pass kernel under every distinct plan
that :func:`~fmdm_tpu_torch.ops.kernels.group_norm.plan` gives over a grid
of chunk targets, largest cluster sizes and pieces per chunk, and the split
variant (the design before the single pass), beside the plan the wrapper
takes, the bound (one read of x, one write of out at 3.35 TB/s) and a copy
of x (``Tensor.copy_``, the same bytes moved by PyTorch's copy kernel). Device
time of back-to-back calls behind a spin kernel (CUDA events), GroupNorm +
SiLU without FiLM. Prints how many clusters of each plan the card holds at
once (``cudaOccupancyMaxActiveClusters``; a 16-CTA plan is tried only where
it schedules) and the card's name and power limit.

Then the backward's (``gn_bwd_*``) at the train paths' largest groups (the
flagship's calls at batch 16, the 3D model's at batch 4) and two small ones,
bf16 with f32 weights: every distinct plan that
:func:`~fmdm_tpu_torch.ops.kernels.group_norm.backward_plan` gives over the
same grid, and its split, beside the wrapper's plan and the bound (x and dy
read, dx written at 3.35 TB/s). ``chip_smoke.py`` [26c] times the backward
over every call of each train step.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from fmdm_tpu_torch.ops.kernels.group_norm import (
    PORTABLE_CLUSTER, WIDE_CLUSTER, _bwd_device_plan, _device_plan, _launch, _launch_backward,
    _max_bwd_clusters, _max_clusters, backward_plan, backward_split_plan, plan, split_plan,
    vector_aligned)

HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 100_000_000
GROUPS = 32
# (shape, dtype): group sizes 512 KB, 1 MB, 256 KB, 64 KB and 2 KB in bf16;
# 1 MB, 2 MB and 256 KB in f32. (64,256,64,64) moves the main shape's bytes
# in 64 KB groups, clusters of one: the same work without a cluster barrier.
SHAPES = (((8, 128, 256, 256), torch.bfloat16), ((8, 256, 256, 256), torch.bfloat16),
          ((8, 256, 128, 128), torch.bfloat16), ((8, 256, 64, 64), torch.bfloat16),
          ((64, 256, 64, 64), torch.bfloat16), ((8, 512, 8, 8), torch.bfloat16),
          ((4, 128, 256, 256), torch.float32), ((4, 256, 256, 256), torch.float32),
          ((4, 512, 64, 64), torch.float32))
# the backward's shapes, bf16: 512 KB and 1 MB groups (the flagship at
# batch 16), the 3D model's 1.5 MB, 512 KB and 128 KB groups at batch 4, and
# 8 KB and 2 KB groups
BACKWARD_SHAPES = ((16, 256, 256, 256), (16, 128, 256, 256), (4, 192, 8, 128, 128),
                   (4, 128, 4, 64, 64), (4, 256, 2, 32, 32), (16, 512, 16, 16), (16, 512, 8, 8))
CHUNK_TARGETS = (16 * 1024, 32 * 1024, 64 * 1024, 128 * 1024, 232_448)
PIECES = (1, 4, 8)


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)  # hold the card while the host queues the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def describe(p, at_once) -> str:
    """A plan in a few words; ``at_once(p)``: its clusters the card holds at once."""
    if not p.single_pass:
        return f"split, {p.ctas} blocks per group"
    return (f"cluster {p.ctas} x {p.smem / 1024:g} KB, {-(-p.chunk // p.piece)} pieces, "
            f"{at_once(p)} clusters at once")


def backward(gen, sms: int) -> None:
    """The backward's plan candidates at BACKWARD_SHAPES (see the module's
    docstring)."""
    def at_once(p):
        return _max_bwd_clusters(0, p.ctas, p.smem, True, False, p.vec)

    for shape in BACKWARD_SHAPES:
        n, c = shape[:2]
        x, dy = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        w = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        b = 0.1 * torch.randn(c, generator=gen, device="cuda")
        hw = x[0, 0].numel()
        group_size = c // GROUPS * hw
        vec = vector_aligned(x, torch.empty_like(x))
        bound = 3 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        chosen = _bwd_device_plan(0, group_size, hw, 2, vec, n * GROUPS, True, False)
        candidates = {chosen: "wrapper's plan",
                      backward_split_plan(group_size, hw, 2, vec, n * GROUPS, sm_count=sms):
                      "split"}
        for target in CHUNK_TARGETS:
            for max_cluster in (PORTABLE_CLUSTER, WIDE_CLUSTER):
                for pieces in PIECES:
                    p = backward_plan(group_size, hw, 2, vec, n * GROUPS, max_cluster=max_cluster,
                                      chunk_bytes=target, pieces=pieces, sm_count=sms)
                    if p.single_pass and p.ctas > PORTABLE_CLUSTER and at_once(p) < 1:
                        continue
                    candidates.setdefault(p, f"target {target // 1024} KB")
        print(f"backward {shape} bf16, f32 weights, G={GROUPS}: group "
              f"{group_size * 2 / 1024:g} KB, bound {bound:.4f} ms (x and dy read, dx written)")
        for p, label in candidates.items():
            ms = time_ms(lambda: _launch_backward(dy, x, w, b, None, None, GROUPS, 1e-5, True, p))
            print(f"  {describe(p, at_once):58s} {ms:.4f} ms ({bound / ms * 100:.1f}% of bound) "
                  f"[{label}]")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("group_norm_report: no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator().manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, dtype in SHAPES:
        n, c = shape[:2]
        x = torch.randn(shape, generator=gen).to("cuda", dtype)
        w = (1 + 0.1 * torch.randn(c, generator=gen)).to("cuda", dtype)
        b = (0.1 * torch.randn(c, generator=gen)).to("cuda", dtype)
        group_size = x[0, :c // GROUPS].numel()
        es, vec = x.element_size(), vector_aligned(x, torch.empty_like(x))
        bound = 2 * x.numel() * es / HBM_BYTES_PER_S * 1e3
        bf16 = dtype == torch.bfloat16

        def at_once(p, bf16=bf16):
            return _max_clusters(0, p.ctas, p.smem, bf16, bf16, p.vec)

        chosen = _device_plan(0, group_size, es, vec, n * GROUPS, bf16, bf16)
        candidates = {chosen: "wrapper's plan",
                      split_plan(group_size, es, vec, n * GROUPS, sm_count=sms): "split"}
        for target in CHUNK_TARGETS:
            for max_cluster in (PORTABLE_CLUSTER, WIDE_CLUSTER):
                for pieces in PIECES:
                    p = plan(group_size, es, vec, n * GROUPS, max_cluster=max_cluster,
                             chunk_bytes=target, pieces=pieces, sm_count=sms)
                    if p.single_pass and p.ctas > PORTABLE_CLUSTER and at_once(p) < 1:
                        continue
                    candidates.setdefault(p, f"target {target // 1024} KB")
        out = torch.empty_like(x)
        copy = time_ms(lambda: out.copy_(x))
        print(f"{shape} {str(dtype)[6:]} G={GROUPS}: group {group_size * es / 1024:g} KB, "
              f"bound {bound:.4f} ms; Tensor.copy_ of x (the same bytes read and written) "
              f"{copy:.4f} ms ({bound / copy * 100:.1f}% of bound)")
        for p, label in candidates.items():
            ms = time_ms(lambda: _launch(x, w, b, None, None, GROUPS, 1e-5, True, p))
            print(f"  {describe(p, at_once):58s} {ms:.4f} ms ({bound / ms * 100:.1f}% of bound) "
                  f"[{label}]")
    backward(torch.Generator("cuda").manual_seed(args.seed), sms)
    print(f"[{card}]")


if __name__ == "__main__":
    main()
