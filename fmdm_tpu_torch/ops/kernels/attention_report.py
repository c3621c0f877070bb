"""
Timings of the attention kernels K2 to K5 against SDPA, and the rounding of
P in K2 at large logits, on one CUDA card.

    python -m fmdm_tpu_torch.ops.kernels.attention_report [--seed 0]

Times K2 at the flagship's shapes and K3, K4 and K5 at the VAE's (device time
of back-to-back calls behind a spin kernel, CUDA events) beside
``F.scaled_dot_product_attention`` and, for the backward, autograd of it
(dq, dk and dv in one call, the work of K4 and K5 together). Then, for K2 in
bf16 with q scaled 8x, it counts the outputs outside ``chip_smoke.py``'s bf16
tolerance of the plain version and prints each against float64 with P rounded
to bf16 as the plain version rounds it, and the row's largest shares p/l:
when one of the two sides lands a bf16 ulp of P away from float64 on a key
that carries much of the row, the difference is the rounding of P and not a
fault of the kernel.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from fmdm_tpu_torch.ops.kernels.flash_attention import (
    flash_backward_dkv, flash_backward_dq, flash_forward)
from fmdm_tpu_torch.ops.kernels.small_t_attention import (
    small_t_attention, small_t_attention_reference)

BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2e-3  # chip_smoke.py's TOL["bfloat16"]
SPIN_CYCLES = 100_000_000


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


def rounding_report(q, k, v) -> None:
    got = small_t_attention(q, k, v).double()
    ref = small_t_attention_reference(q, k, v).double()
    outside = (got - ref).abs() > BF16_ATOL + BF16_RTOL * ref.abs()
    s = (q.double() @ k.double().transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    rounded = (p.to(v.dtype).double() @ v.double()) / l
    print(f"  {tuple(q.shape)} bf16 q*8: {int(outside.sum())} of {got.numel()} outputs outside "
          f"the bf16 tolerance; max |kernel - float64| {float((got - rounded).abs().max()):.3e}, "
          f"max |plain - float64| {float((ref - rounded).abs().max()):.3e} (float64 with P "
          f"rounded to bf16)")
    for b, h, r, c in outside.nonzero().tolist():
        share = (p[b, h, r] / l[b, h, r]).topk(min(3, q.shape[-2])).values.tolist()
        print(f"    at {(b, h, r, c)}: kernel {float(got[b, h, r, c]):.6f}, plain "
              f"{float(ref[b, h, r, c]):.6f}, float64 {float(rounded[b, h, r, c]):.6f}; "
              f"largest p/l {[round(x, 4) for x in share]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_report: no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(args.seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def inputs(shape, dtype):
        return [torch.randn(shape, generator=gen).to("cuda", dtype) for _ in range(3)]

    print(f"timings [{card}]")
    for shape, dtype in (((8, 64, 256, 8), torch.bfloat16), ((8, 64, 64, 8), torch.bfloat16),
                         ((32, 64, 256, 8), torch.bfloat16), ((2, 64, 256, 8), torch.float32)):
        q, k, v = inputs(shape, dtype)
        print(f"  K2 {shape} {str(dtype)[6:]}: kernel {time_ms(lambda: small_t_attention(q, k, v)):.4f}"
              f" ms, SDPA {time_ms(lambda: sdpa(q, k, v)):.4f} ms")
    q, k, v = inputs((4, 4, 1024, 64), torch.float32)
    print(f"  K3 (4, 4, 1024, 64) float32: kernel "
          f"{time_ms(lambda: flash_forward(q, k, v, 0.125)):.4f} ms, SDPA "
          f"{time_ms(lambda: sdpa(q, k, v)):.4f} ms")
    dout = torch.randn_like(q)  # not from gen: the draws below stay what they were
    out, lse = flash_forward(q, k, v, 0.125)
    delta = (dout * out).sum(dim=-1, keepdim=True)
    k4 = time_ms(lambda: flash_backward_dkv(q, k, v, dout, lse, delta, 0.125))
    k5 = time_ms(lambda: flash_backward_dq(q, k, v, dout, lse, delta, 0.125))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa_out = sdpa(*leaves)
    library = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True))
    print(f"  K4 (4, 4, 1024, 64) float32: kernel {k4:.4f} ms; K5: kernel {k5:.4f} ms; K4 + K5 "
          f"{k4 + k5:.4f} ms, autograd of SDPA (dq, dk, dv) {library:.4f} ms")

    print(f"K2 with logits scaled 8x [{card}]")
    for shape in ((2, 64, 256, 8), (8, 64, 256, 8), (8, 64, 64, 8), (32, 64, 64, 8)):
        q, k, v = inputs(shape, torch.bfloat16)
        rounding_report(q * 8, k, v)


if __name__ == "__main__":
    main()
