#!/usr/bin/env python3
"""
Drive the PyTorch port (``fmdm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--batches 8,32]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each printing one or more lines:

1. the card (``nvidia-smi`` name and power limit, maximum SM clock), torch
   and CUDA versions;
2. the build of every kernel from ``fmdm_tpu_torch/csrc`` with ``nvcc``;
3. K1 (fused GroupNorm+SiLU) against its plain version, f32 and bf16, each
   case twice and bitwise equal: both variants (the single-pass cluster
   kernel, and the split forced) and every group-size class of the main
   paths (2 KB at batch 32 to 1 MB in bf16, 2 MB in f32), a ragged last
   chunk, 7x7 and an unaligned x (one element per load), SiLU and FiLM on
   and off, f32 weights under bf16; its timings at the largest call;
4. K2 (small-T attention) against its plain version: the flagship's two
   calls in f32 and bf16, T = 1, T = 17, ragged T = 100 at d = 24, T = 1000
   at d = 64, the 8² call at batch 32, and bf16 logits scaled up 8x on five
   draws (where P's rounding may tie, an output also passes no farther from
   float64 than the plain version); its timings, and the name of the kernel
   SDPA launches at the timed shape;
5. the full-width flagship forward (batch 1, f32, TF32 off) on the card
   through K1 and K2, against the same module on the CPU's plain path, and
   the kernels' launch counts per forward;
6. the first 3 steps of that sample in f32 at batch 1 through
   ``SamplingEngine``, on the card against the CPU plain path;
7. the 50-step DPM-Solver++ (order 2) sample at 256² in bf16 through
   ``SamplingEngine``: finite output, launch counts, seconds and denoise
   steps/s;
8. K3 (flash forward) against its plain version: the VAE's shape in f32
   and bf16, a ragged T, cross-attention to 77 keys, d = 32 and 128, one key,
   17 queries, the f32 cases on four draws each; timings, and the name of
   the kernel SDPA launches;
9. K4 (dK/dV) and K5 (dQ) against the plain backward at the same shapes, at
   one key, at 17 queries, and at a head dim whose rows are not 16-byte
   aligned; two calls on the same inputs bitwise equal; timings, and the pair
   beside autograd of SDPA;
10. the full-width KL-VAE forward at the posterior's mode (batch 1, f32,
    TF32 off) on the card through K1 and K3, against the same module on the
    CPU's plain path, and the launch counts per reconstruct;
11. its train step (L1 + KL, AdamW) at batch 1 on the card against the CPU
    plain path with the same posterior noise: loss, every gradient, the
    parameters after the update; then 10 timed steps at the config's batch 4
    with launches per step (K1, K3, K4, K5) and peak memory;
12. encode, decode and reconstruct at batch 4: images/s, launches per call;
13. K1 over the calls recorded in [5] and [10], replayed at the sample's
    first batch in bf16 and the VAE's batch 4 in f32, each call on inputs
    of its own: every call against its plain version, the device launches
    per variant (every bf16 flagship call one single-pass launch), the
    summed kernel time against the summed bound and F.group_norm+F.silu;
14. ``sdpa`` at shapes no kernel takes (cross-attention at Tq < 1024, d = 96
    at T = 256, d = 160 at T = 1024) on its plain route on the card, against
    ``sdpa_xla`` on the CPU, with no kernel launched;
15. the full-width forward of the attention-conditioned flagship
    (``configs/LDCT/PixelAttention/LDCT_ddpm_attention_diffusers_nd.json``,
    mid block ``UNetMidBlock2DCrossAttn`` attending to a 4x32x32 latent),
    card against the CPU plain path, and its launches;
16. the flagship's denoise train step (DDPM, AdamW at the cosine-warmup
    rate) through ``build_denoise_trainer``, f32, TF32 off, at batch 1 on the
    card against the CPU plain path with the same noise and t: loss, every
    gradient, the card's update against AdamW replayed on the CPU, launches;
17. 10 timed train steps at the config's batch 8 (ms per step, images/s,
    peak memory, launches per step) and one flow-matching step of
    ``configs/LDCT/LDCT_flow_matching_diffusers_nd.json``;
18. the first 3 DDPM steps of the config's schedule through
    ``SamplingEngine``, f32, batch 1, card against CPU with the same noise
    per step; then 5 bf16 DDPM steps at batch 8 drawing from a CUDA generator;
19. each scheduler ported for the decode path (DDIM at eta 0 and 1, UniPC
    bh1/bh2 at orders 1-3 with and without Karras sigmas, DPM-Solver++ at
    order 3, with Karras sigmas and as 'sde-dpmsolver++', DPM-SDE) over a
    whole 25-step schedule at the decode's sample shape, card against CPU on
    the same model outputs and noise, no model;
20. a trained run's decode at full width: a run dir written with the
    config's ``train_config.json`` and a ``diff_last.pt`` from the port's
    ``save_checkpoint`` (the ``--seed`` weights after one AdamW step, their
    EMA, the optimizer's state), read back through ``load_run_config``,
    ``resolve_checkpoint`` and ``build_diffusion_model`` bitwise (``model``
    and, under ``set_use_ema``, ``ema``); ``decode_diffusion_batch`` in f32
    at batch 4, 8 inference steps, under the config's DDPM and seven
    scheduler overrides, a partial decode from ``start_step`` 700 with
    ``init_from_reference``, and a flow-matching run dir: model calls, K1
    and K2 launches per call, denoise steps/s, peak memory; then two decodes
    of 3 model calls at batch 1 (DPM-SDE with injected noise, UniPC order 3
    with Karras sigmas), card against the CPU plain path, with PSNR and SSIM
    between them;
21. the whole run's seconds, a ``{"kernels": [...]}`` line, then the result
    line ``{"ok": true, "device": {...}}``.

The flagship is ``model.unet`` of ``configs/LDCT/LDCT_ddpm_diffusers_nd.json``
with concatenate conditioning and random weights drawn from ``--seed`` (in
the train step every weight, the zero-initialized ones too); the
VAE is ``configs/LDCT/LDCT_autoencoder_kl.json`` at its published widths with
every weight drawn from ``--seed`` (the zero-initialized projections too, so
every gradient path carries signal). Any failed check raises, and the script
then exits non-zero without a result line; so does a machine without a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
CONFIG = REPO_ROOT / "configs" / "LDCT" / "LDCT_ddpm_diffusers_nd.json"
FLOW_CONFIG = REPO_ROOT / "configs" / "LDCT" / "LDCT_flow_matching_diffusers_nd.json"
ATTENTION_CONFIG = (REPO_ROOT / "configs" / "LDCT" / "PixelAttention"
                    / "LDCT_ddpm_attention_diffusers_nd.json")
VAE_CONFIG = REPO_ROOT / "configs" / "LDCT" / "LDCT_autoencoder_kl.json"

# H100 SXM, NVIDIA data sheet (dense): HBM rate and peak operation rates
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
TF32_OPS_PER_S = 495e12    # TF32 tensor cores
BF16_OPS_PER_S = 989e12    # bf16 tensor cores
# exponentials (ex2) per clock per SM on the SFUs of compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput)
SFU_EXP_PER_CLOCK_PER_SM = 16

SPIN_CYCLES = 100_000_000  # ~60 ms at the H100's clocks: longer than queuing 20 calls

NUM_STEPS = 50
K1_PER_FORWARD = 64  # 32 ResBlocks x 2 GroupNorm+SiLU
K2_PER_FORWARD = 6   # 5 attentions at 16², 1 at 8²
# KL-VAE launches: K1 runs every ResBlock's two GroupNorm+SiLU and norm_out +
# SiLU (the attention's own GroupNorm has no SiLU and stays a plain op); K3
# runs the one mid attention at 32² (T = 1024) of each half
VAE_LAUNCHES = {
    "encode": {"K1": 2 * 10 + 1, "K3": 1},       # 4 stages x 2 ResBlocks + 2 mid
    "decode": {"K1": 2 * 14 + 1, "K3": 1},       # 4 stages x 3 ResBlocks + 2 mid
    "reconstruct": {"K1": 50, "K3": 2},
    "train step": {"K1": 50, "K3": 2, "K4": 2, "K5": 2},  # K1's backward is plain
}
# the flagship's denoise train step (and each DDPM step): the forward's
# kernels, K1's and K2's backward being the autograd of their plain versions
DENOISE_LAUNCHES = {"K1": K1_PER_FORWARD, "K2": K2_PER_FORWARD}
# the attention-conditioned flagship: its mid block cross-attends (sdpa_xla)
# instead of self-attending, so K2 serves the other five calls
CROSS_ATTENTION_LAUNCHES = {"K1": K1_PER_FORWARD, "K2": K2_PER_FORWARD - 1}
DDPM_STEPS = 3       # card vs CPU
DDPM_BF16_STEPS = 5  # at the config's batch
REL_TOL = 1e-3  # card vs CPU plain path: conv algorithms and sum orders differ
# sdpa at shapes no kernel takes (q shape, Tk, dtype, what)
SDPA_PLAIN_CASES = (
    ((1, 64, 64, 8), 1024, "float32", "cross-attention, 8² to a 32² latent"),
    ((2, 8, 256, 64), 77, "bfloat16", "cross-attention to 77 tokens"),
    ((2, 4, 256, 96), 256, "float32", "self-attention, d = 96 at T = 256"),
    ((1, 2, 1024, 160), 1024, "float32", "self-attention, d = 160 at T = 1024"),
)
TRAIN_STEPS = 10
DECODE_BATCH = 4     # run_model's default --batch_size
SCHEDULER_STEPS = 25  # [19]: a whole schedule per scheduler
# [20]: inference steps per decode, cut from 25 to keep the run near 300 s:
# at batch 4 in f32 a flagship forward takes 0.6-1.1 s on the H100, where
# cuDNN runs one convolution as an FFT-tiled GEMM of 66,048 launches
# (python -m fmdm_tpu_torch.sample.decode_report)
DECODE_STEPS = 8
# [19]: the schedulers of the decode path, as (registry name, create params)
NEW_SCHEDULERS = (
    ("ddim", {}), ("ddim", {"eta": 1.0}),
    *(("unipc", {"solver_type": kind, "solver_order": order, "use_karras_sigmas": karras})
      for kind in ("bh1", "bh2") for order in (1, 2, 3) for karras in (False, True)),
    ("dpm_multistep", {"solver_order": 3}), ("dpm_multistep", {"use_karras_sigmas": True}),
    ("dpm_multistep", {"algorithm_type": "sde-dpmsolver++"}), ("dpm_sde", {}),
)
# card vs CPU over a whole chain of scheduler steps: the same f32 operations,
# which the card may contract into FMAs
SCHEDULER_REL_TOL = 1e-5
# [20]: the decode runs, as (label, scheduler_override, decode kwargs)
DECODE_RUNS = (
    ("ddpm (the config's)", None, {}),
    ("ddim", "ddim", {}),
    ("unipc", "unipc", {}),
    ("unipc order 3, Karras", "unipc?solver_order=3,use_karras_sigmas=true", {}),
    ("dpmsolver++ order 3", "dpmsolver++?solver_order=3", {}),
    ("dpmsolver++ Karras", "dpmsolver++?use_karras_sigmas=true", {}),
    ("sde-dpmsolver++", "dpmsolver++?algorithm_type=sde-dpmsolver++", {}),
    ("dpmsolversde", "dpmsolversde", {}),
    ("ddpm from start_step 700, init_from_reference", None,
     {"start_step": 700, "init_from_reference": True}),
)
# [20]: card vs CPU, decodes of 3 model calls at batch 1 (steps, override)
DECODE_PARITY = ((2, "dpmsolversde"), (3, "unipc?solver_order=3,use_karras_sigmas=true"))
SERVE_CALLS = 5
K2_X8_DRAWS = 4   # further draws of K2's bf16 case at logits x8
K3_F32_DRAWS = 3  # further draws of each f32 K3 case


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs, from CUDA
    events. A spin kernel holds the card while the host queues the runs, so
    a small kernel is timed on the device and not at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 20) -> float:
    """Mean host time of one call of ``fn`` (validation, allocation, launch),
    measured while a spin kernel keeps the card busy so no call waits on it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


@functools.lru_cache(maxsize=1)
def exp_per_s() -> float:
    """Exponentials per second on this card's SFUs: 16 per clock per SM, at
    the maximum SM clock, over every SM."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_EXP_PER_CLOCK_PER_SM * sms * max_sm_clock_mhz() * 1e6


def product_seconds(ops: float, dtype: str) -> dict:
    """Least time for ``ops`` matrix-product operations on inputs of
    ``dtype``: bf16 on the tensor cores; f32 the faster of f32 FMAs and
    3xTF32 (three TF32 products per f32 product, which keeps f32 accuracy)."""
    if dtype == "bfloat16":
        return {"bf16 tensor cores": ops / BF16_OPS_PER_S}
    fma, tf32x3 = ops / F32_OPS_PER_S, 3 * ops / TF32_OPS_PER_S
    return {"3xTF32": tf32x3} if tf32x3 <= fma else {"f32 FMA": fma}


def bound_ms(bytes_moved: float, **op_seconds: float):
    """Least time for the work on this card in ms, the larger of the bytes
    over the HBM rate and each operation term (seconds, by name), and what
    sets it: ("bytes" or "operations", the term's name)."""
    terms = {"bytes": bytes_moved / HBM_BYTES_PER_S, **op_seconds}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, ("bytes" if term == "bytes" else "operations"), term


def attention_bound(bytes_moved: float, ops: float, exps: float, dtype: str):
    """bound_ms of an attention kernel: its bytes, its products at the
    dtype's rate, and its exponentials on the SFUs."""
    return bound_ms(bytes_moved, **product_seconds(ops, dtype), **{"exp (SFU)": exps / exp_per_s()})


def sdpa_kernels(torch, cases) -> dict:
    """The names of the device kernels ``F.scaled_dot_product_attention``
    launches at each (shape, dtype) of ``cases`` (q, k and v of one shape),
    from one ``torch.profiler`` pass each. Taken at the start of the run:
    after the sampling phases the profiler has recorded no device events at
    all on the H100, while the same pass at the start records them."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = {}
    for shape, dtype in cases:
        q = torch.zeros(shape, device="cuda", dtype=getattr(torch, dtype))
        torch.nn.functional.scaled_dot_product_attention(q, q, q)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            torch.nn.functional.scaled_dot_product_attention(q, q, q)
            torch.cuda.synchronize()
        kernels = dict.fromkeys(e.name[:120] for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA
                                and not getattr(e, "is_user_annotation", False))
        names[(tuple(shape), dtype)] = "; ".join(kernels) or "not recorded"
    return names


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_close(what: str, got, ref, rtol: float, atol: float) -> float:
    import torch

    err = max_err(got, ref)
    ok = bool(torch.all((got.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()))
    log(f"  {what}: max_abs_err {err:.3e} (tolerance {atol:g} + {rtol:g}*|ref|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max_abs_err {err})")
    return err


# Tolerances, kernel vs plain version on the same inputs. f32: the sums run
# in another order (split reduction, per-thread dot products), a few f32 ulps.
# bf16: both round nearly the same f32 value, so they may differ by one bf16
# ulp (2^-8 relative) of the output.
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -7, 2e-3)}


def k1_inputs(torch, gen, shape, dtype, w_dtype=None, film=False, offset=0):
    """x (``offset`` elements into its buffer, so a non-zero offset leaves it
    unaligned), weight, bias, and FiLM's scale and shift or None, on the card."""
    import math

    n, c = shape[:2]
    flat = torch.randn(offset + math.prod(shape), generator=gen).to("cuda", dtype)
    x = flat[offset:].view(shape)
    w = (1 + 0.1 * torch.randn(c, generator=gen)).to("cuda", w_dtype or dtype)
    b = (0.1 * torch.randn(c, generator=gen)).to("cuda", w_dtype or dtype)
    s = (0.2 * torch.randn(n, c, generator=gen)).to("cuda", dtype) if film else None
    t = (0.2 * torch.randn(n, c, generator=gen)).to("cuda", dtype) if film else None
    return x, w, b, s, t


def k1_bound(x, w):
    """bound_ms of one K1 call: one read of x, one write of out, the affine
    once; ~11 f32 operations per element (statistics 3, normalize+affine 4,
    SiLU 4)."""
    return bound_ms(2 * x.numel() * x.element_size() + 2 * w.numel() * w.element_size(),
                    **{"f32 elementwise": 11 * x.numel() / F32_OPS_PER_S})


def k1_library(torch, x, w, b, s, t, groups, eps, act):
    """The same function in PyTorch calls: F.group_norm, FiLM, F.silu."""
    y = torch.nn.functional.group_norm(x, groups, w.to(x.dtype), b.to(x.dtype), eps)
    if s is not None:
        nd = x.dim() - 2
        y = y * (1 + s.reshape(s.shape + (1,) * nd)) + t.reshape(t.shape + (1,) * nd)
    return torch.nn.functional.silu(y) if act else y


def phase_k1(torch, card: str, gen, own_gen, main_batch: int) -> dict:
    from fmdm_tpu_torch.ops.kernels.group_norm import (
        K1, _launch, group_norm_act, group_norm_act_reference, split_plan, vector_aligned)

    log("[3] K1 group_norm_act vs its plain version, each case twice (bitwise equal)")
    groups, eps = 32, 1e-5
    # group sizes of the main paths: 512 KB and 1 MB in bf16 (clusters of 8,
    # or 16), 2 MB in f32 (a cluster of 16 where it schedules, else the
    # split), 2 KB at batch 32 (a cluster of one); 70,000 elements, which no
    # cluster divides into whole sweeps (ragged last chunk and piece); 7x7
    # and an unaligned x take one element per load (the second in a cluster
    # of 2 or 4); f32 weights under bf16 activations; then the split variant
    # forced at the flagship's shape and at 7x7. The flagship-shape cases
    # draw from `gen`, which the later phases share; the others draw from
    # `own_gen`, so the inputs of every later phase do not depend on them.
    cases = [((2, 128, 256, 256), act, film, None, 0, False, gen)
             for act in (True, False) for film in (False, True)]
    cases += [((2, 256, 256, 256), True, False, None, 0, False, gen),
              ((32, 512, 8, 8), True, True, None, 0, False, own_gen),
              ((2, 1024, 8, 8), True, True, None, 0, False, gen),
              ((2, 224, 100, 100), True, True, None, 0, False, own_gen),
              ((3, 96, 7, 7), True, True, None, 0, False, gen),
              ((2, 128, 128, 128), True, False, None, 1, False, own_gen),
              ((2, 64, 32, 32), True, False, torch.float32, 0, False, gen),
              ((2, 128, 256, 256), True, True, None, 0, True, own_gen),
              ((3, 96, 7, 7), True, False, None, 0, True, own_gen)]
    worst = 0.0
    for shape, act, film, w_dtype, offset, split, draw in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b, s, t = k1_inputs(torch, draw, shape, dtype, w_dtype, film, offset)
            kw = dict(num_groups=groups, eps=eps, act=act, scale=s, shift=t)
            if split:
                out = torch.empty_like(x)
                p = split_plan(x[0, :shape[1] // groups].numel(), x.element_size(),
                               vector_aligned(x, out), shape[0] * groups,
                               sm_count=torch.cuda.get_device_properties(0).multi_processor_count)
                call = functools.partial(_launch, x, w, b, s, t, groups, eps, act, p)
            else:
                call = functools.partial(group_norm_act, x, w, b, **kw)
            before = dict(K1.variants)
            got = call()
            again = call()
            torch.cuda.synchronize()
            variant = next(k for k in K1.variants if K1.variants[k] != before[k])
            if not torch.equal(got, again):
                raise AssertionError(f"K1 {shape} {dtype}: two calls on the same inputs differ")
            ref = group_norm_act_reference(x, w, b, **kw)
            rtol, atol = TOL[str(dtype).split(".")[1]]
            err = check_close(f"{tuple(shape)} G={groups} {str(dtype)[6:]} act={act} film={film} "
                              f"weights {str(w.dtype)[6:]}{' offset 1' if offset else ''} "
                              f"[{variant.replace('_', ' ')}]", got, ref, rtol, atol)
            if dtype == torch.bfloat16:
                worst = max(worst, err)

    def timed(shape, dtype):
        x, w, b, _, _ = k1_inputs(torch, gen, shape, dtype)
        kw = dict(num_groups=groups, eps=eps, act=True)
        err = max_err(group_norm_act(x, w, b, **kw), group_norm_act_reference(x, w, b, **kw))
        ms = time_ms(lambda: group_norm_act(x, w, b, **kw))
        plain = time_ms(lambda: group_norm_act_reference(x, w, b, **kw))
        library = time_ms(lambda: k1_library(torch, x, w, b, None, None, groups, eps, True))
        bound, bound_by, term = k1_bound(x, w)
        host = host_us(lambda: group_norm_act(x, w, b, **kw))
        log(f"  timing {shape} {str(dtype)[6:]} G={groups} SiLU: kernel {ms:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}), plain {plain:.4f} ms, F.group_norm+F.silu "
            f"{library:.4f} ms; host {host:.1f} us per call [{card}]")
        return dict(max_abs_err=max(err, worst), ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=bound_by, bound_term=term, library_ms=library, shape=list(shape),
                    dtype=str(dtype)[6:])

    timed((2, 128, 256, 256), torch.float32)
    timed((2, 128, 256, 256), torch.bfloat16)
    # the main path's largest call: (batch, 128, 256, 256) bf16, SiLU, no FiLM
    main = timed((main_batch, 128, 256, 256), torch.bfloat16)
    return dict(name=K1.name, route="cuda", source=K1.source, replaces=K1.replaces, **main)


@contextlib.contextmanager
def recording_k1():
    """Record the K1 calls the models make (per-sample shape, groups, eps,
    act, FiLM) while passing each on to the kernel."""
    from fmdm_tpu_torch.nn import blocks, vae_modules

    calls = []
    kernel = blocks.group_norm_act

    def record(x, weight, bias, **kw):
        calls.append((tuple(x.shape[1:]), kw["num_groups"], kw.get("eps", 1e-5),
                      kw.get("act", True), kw.get("scale") is not None))
        return kernel(x, weight, bias, **kw)

    blocks.group_norm_act = vae_modules.group_norm_act = record
    try:
        yield calls
    finally:
        blocks.group_norm_act = vae_modules.group_norm_act = kernel


def phase_k1_path(torch, card: str, gen, what: str, calls, batch: int, dtype) -> dict:
    """K1 over one pass's recorded calls at ``batch`` in ``dtype``, each on
    inputs of its own (so L2 does not carry one call's x into the next):
    every call against its plain version, the launches per variant, and the
    summed kernel time against the summed bound and the same calls in PyTorch."""
    from fmdm_tpu_torch.ops.kernels.group_norm import K1, group_norm_act, group_norm_act_reference

    inputs = []
    for shape, groups, eps, act, film in calls:
        # the models run with every weight in the activations' dtype
        x, w, b, s, t = k1_inputs(torch, gen, (batch,) + shape, dtype, film=film)
        inputs.append(((x, w, b), dict(num_groups=groups, eps=eps, act=act, scale=s, shift=t)))
    rtol, atol = TOL[str(dtype).split(".")[1]]
    worst = 0.0
    K1.reset()
    for args, kw in inputs:
        got = group_norm_act(*args, **kw)
        ref = group_norm_act_reference(*args, **kw)
        worst = max(worst, max_err(got, ref))
        if not bool(torch.all((got.float() - ref.float()).abs() <= atol + rtol * ref.float().abs())):
            raise AssertionError(f"K1 {tuple(args[0].shape)} {dtype} disagrees with its plain version")
    torch.cuda.synchronize()
    variants = dict(K1.variants)
    if K1.launches != len(calls):
        raise AssertionError(f"{what}: {K1.launches} K1 calls for {len(calls)}")

    def kernel_pass():
        for args, kw in inputs:
            group_norm_act(*args, **kw)

    def library_pass():
        for (x, w, b), kw in inputs:
            k1_library(torch, x, w, b, kw["scale"], kw["shift"], kw["num_groups"], kw["eps"],
                       kw["act"])

    ms = time_ms(kernel_pass, iters=10, warmup=2)
    library = time_ms(library_pass, iters=10, warmup=2)
    bound = sum(k1_bound(args[0], args[1])[0] for args, _ in inputs)
    log(f"  {what}: {len(calls)} calls at batch {batch} {str(dtype)[6:]}, max_abs_err "
        f"{worst:.3e} (tolerance {atol:g} + {rtol:g}*|ref|); kernel {ms:.4f} ms summed, bound "
        f"{bound:.4f} ms (bytes), F.group_norm+F.silu {library:.4f} ms; device launches by "
        f"variant {variants} [{card}]")
    return dict(ms=ms, bound_ms=bound, library_ms=library, calls=len(calls), batch=batch,
                dtype=str(dtype)[6:], variants=variants, max_abs_err=worst)


def k2_timed(main_batch: int):
    """K2's timed (shape, dtype): the flagship's two calls at batch 2 (and
    the 16² call in f32), the 8² call at the sample's batch, the 16² call at
    batch 32; last the main path's 16² call at the sample's batch."""
    return [((2, 64, 256, 8), "float32"), ((2, 64, 256, 8), "bfloat16"),
            ((2, 64, 64, 8), "bfloat16"), ((main_batch, 64, 64, 8), "bfloat16"),
            ((32, 64, 256, 8), "bfloat16"), ((main_batch, 64, 256, 8), "bfloat16")]


def small_t_float64(torch, q, k, v):
    """K2's function in float64 on the same inputs, P rounded to V's dtype
    as the kernel and the plain version round it."""
    s = (q.double() @ k.double().transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (p.to(v.dtype).double() @ v.double()) / p.sum(-1, keepdim=True)


def check_close_or_nearer(torch, what: str, got, ref, exact, rtol: float, atol: float) -> float:
    """check_close, except that an output outside the tolerance of the plain
    version also passes where it is no farther from the float64 evaluation
    ``exact`` than the plain version is, plus the tolerance: where p sits
    within f32 ulps of a bf16 midpoint, P's rounding may fall on either side
    in the kernel and in the plain version, and the plain side may be the one
    off."""
    diff = (got.double() - ref.double()).abs()
    near = diff <= atol + rtol * ref.double().abs()
    nearer = (got.double() - exact).abs() <= (ref.double() - exact).abs() + atol + rtol * exact.abs()
    ok = bool(torch.all(near | nearer))
    err = float(diff.max())
    log(f"  {what}: max_abs_err {err:.3e} (tolerance {atol:g} + {rtol:g}*|ref|, or no farther "
        f"from float64 than the plain version; {int((~near).sum())} outputs by the second) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max_abs_err {err})")
    return err


def phase_k2(torch, card: str, gen, own_gen, main_batch: int, library_kernels: dict) -> dict:
    from fmdm_tpu_torch.ops.kernels.small_t_attention import (
        K2, small_t_attention, small_t_attention_reference)

    log("[4] K2 small_t_attention vs its plain version")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the flagship's two calls, T = 1, T = 17 (16-row tiles filled raggedly);
    # off-path: ragged T with d padded to 32, T near the limit at d = 64; then
    # the 8² call at the sample's batch 32, and logits 8x larger in bf16
    # (q * 8, exact), where one or two keys carry most of a row. There P's
    # rounding to bf16 can fall on either side for kernel and plain version
    # when p sits within f32 ulps of a midpoint, so that case is also judged
    # against float64 (check_close_or_nearer), on the draw from `gen` and on
    # further draws from `own_gen`, which leave the later phases' inputs as
    # they were.
    cases = [(shape, dtype, 1.0, gen) for shape in ((2, 64, 256, 8), (2, 64, 64, 8), (2, 4, 1, 8),
                                                     (2, 64, 17, 8), (3, 5, 100, 24), (1, 2, 1000, 64))
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [((32, 64, 64, 8), torch.bfloat16, 1.0, gen)]
    cases += [((2, 64, 256, 8), torch.bfloat16, 8.0, draw) for draw in (gen,) + (own_gen,) * K2_X8_DRAWS]
    worst = 0.0
    for shape, dtype, q_mul, draw in cases:
        q, k, v = (torch.randn(shape, generator=draw).to("cuda", dtype) for _ in range(3))
        q = q * q_mul
        got = small_t_attention(q, k, v)
        torch.cuda.synchronize()
        ref = small_t_attention_reference(q, k, v)
        rtol, atol = TOL[str(dtype).split(".")[1]]
        if q_mul != 1.0:
            err = check_close_or_nearer(
                torch, f"{shape} {str(dtype)[6:]} q*8{'' if draw is gen else ' (own draw)'}", got,
                ref, small_t_float64(torch, q, k, v), rtol, atol)
        else:
            err = check_close(f"{shape} {str(dtype)[6:]}", got, ref, rtol, atol)
        if dtype == torch.bfloat16:
            worst = max(worst, err)

    def timed(shape, dtype):
        q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype) for _ in range(3))
        err = max_err(small_t_attention(q, k, v), small_t_attention_reference(q, k, v))
        ms = time_ms(lambda: small_t_attention(q, k, v))
        plain = time_ms(lambda: small_t_attention_reference(q, k, v))
        library = time_ms(lambda: sdpa(q, k, v))
        library_kernel = library_kernels[(shape, str(dtype)[6:])]
        bh, t, d = shape[0] * shape[1], shape[2], shape[3]
        # q, k, v read, out written; QK^T and PV, 2 operations per FMA; T*T exponentials
        bound, bound_by, term = attention_bound(4 * q.numel() * q.element_size(),
                                                4 * bh * t * t * d, bh * t * t, str(dtype)[6:])
        host = host_us(lambda: small_t_attention(q, k, v))
        log(f"  timing {shape} {str(dtype)[6:]}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
            f"({term}), plain {plain:.4f} ms, F.scaled_dot_product_attention {library:.4f} ms "
            f"[{library_kernel}]; host {host:.1f} us per call [{card}]")
        return dict(max_abs_err=max(err, worst), ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=bound_by, bound_term=term, library_ms=library,
                    library_kernel=library_kernel, shape=list(shape), dtype=str(dtype)[6:])

    main = [timed(shape, getattr(torch, dtype)) for shape, dtype in k2_timed(main_batch)][-1]
    return dict(name=K2.name, route="cuda", source=K2.source, replaces=K2.replaces, **main)


# flash-attention cases (q shape, Tk, dtype): the VAE's mid attention at the
# train step's batch 4 in f32 (timed) and bf16, a ragged T that is no tile
# multiple, cross-attention to a 77-token context, and d = 32 and 128
FLASH_CASES = (((4, 4, 1024, 64), 1024, "float32"), ((4, 4, 1024, 64), 1024, "bfloat16"),
               ((1, 2, 1000, 64), 1000, "float32"), ((2, 4, 1024, 64), 77, "float32"),
               ((1, 2, 1024, 32), 1024, "float32"), ((1, 2, 1024, 128), 1024, "float32"))
# K3 also at one key, and at 17 queries (one 64-row tile, its warps filled raggedly)
K3_CASES = FLASH_CASES + tuple((q_shape, tk, dtype) for q_shape, tk in
                               (((1, 2, 64, 64), 1), ((1, 2, 17, 64), 1024))
                               for dtype in ("float32", "bfloat16"))
# K4 and K5 at all of these (17 queries are a column mask in K4, whose lse and
# delta then take the plain copy), and at d = 18, where no row starts 16-byte
# aligned and every tile is staged by the plain copy
BACKWARD_CASES = K3_CASES + (((1, 2, 100, 18), 50, "float32"), ((1, 2, 100, 18), 50, "bfloat16"))


def flash_inputs(torch, gen, q_shape, tk, dtype):
    """q, k, v, dout on the card."""
    kv_shape = q_shape[:-2] + (tk, q_shape[-1])
    return [torch.randn(s, generator=gen).to("cuda", getattr(torch, dtype))
            for s in (q_shape, kv_shape, kv_shape, q_shape)]


def flash_product_ms(ops: float) -> str:
    return (f"f32 FMA {ops / F32_OPS_PER_S * 1e3:.4f} ms, "
            f"3xTF32 {3 * ops / TF32_OPS_PER_S * 1e3:.4f} ms")


def phase_k3(torch, card: str, gen, own_gen, library_kernels: dict) -> dict:
    from fmdm_tpu_torch.ops.kernels.flash_attention import (
        K3, flash_attention_reference, flash_forward)

    log("[8] K3 flash_forward vs its plain version")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = 0.0
    # every case on a draw from `gen`; the f32 ones, whose tolerance is a few
    # ulps, also on K3_F32_DRAWS draws from `own_gen`, which leave the later
    # phases' inputs as they were
    draws = [(case, gen) for case in K3_CASES]
    draws += [(case, own_gen) for case in K3_CASES if case[2] == "float32"
              for _ in range(K3_F32_DRAWS)]
    for (q_shape, tk, dtype), draw in draws:
        q, k, v, _ = flash_inputs(torch, draw, q_shape, tk, dtype)
        scale = q_shape[-1] ** -0.5
        out, lse = flash_forward(q, k, v, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, scale)
        what = f"q {q_shape} Tk={tk} {dtype}{'' if draw is gen else ' (own draw)'}"
        worst = max(worst, check_close(f"{what} out", out, ref_out, *TOL[dtype]),
                    check_close(f"{what} lse", lse, ref_lse, *TOL["float32"]))

    q_shape, tk, dtype = FLASH_CASES[0]
    q, k, v, _ = flash_inputs(torch, gen, q_shape, tk, dtype)
    scale = q_shape[-1] ** -0.5
    ms = time_ms(lambda: flash_forward(q, k, v, scale))
    plain = time_ms(lambda: flash_attention_reference(q, k, v, scale))
    library = time_ms(lambda: sdpa(q, k, v))
    library_kernel = library_kernels[(q_shape, dtype)]
    bh, t, d = q_shape[0] * q_shape[1], q_shape[2], q_shape[3]
    # q, k, v read, out and lse written; QK^T and PV, 2 operations per FMA;
    # one exponential per score
    ops = 4 * bh * t * tk * d
    bound, bound_by, term = attention_bound(4 * q.numel() * q.element_size() + bh * t * 4, ops,
                                            bh * t * tk, dtype)
    log(f"  timing {q_shape} {dtype}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({term}; "
        f"products {flash_product_ms(ops)}), plain {plain:.4f} ms, "
        f"F.scaled_dot_product_attention {library:.4f} ms [{library_kernel}] [{card}]")
    return dict(name=K3.name, route="cuda", source=K3.source, replaces=K3.replaces,
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by,
                bound_term=term, library_ms=library, library_kernel=library_kernel,
                shape=list(q_shape), dtype=dtype)


def phase_k4_k5(torch, card: str, gen):
    from fmdm_tpu_torch.ops.kernels.flash_attention import (
        K4, K5, flash_backward_dkv, flash_backward_dq, flash_backward_reference, flash_forward)

    log("[9] K4 flash_backward_dkv and K5 flash_backward_dq vs the plain backward")
    worst = {"K4": 0.0, "K5": 0.0}

    def prepared(q_shape, tk, dtype):
        q, k, v, dout = flash_inputs(torch, gen, q_shape, tk, dtype)
        scale = q_shape[-1] ** -0.5
        out, lse = flash_forward(q, k, v, scale)
        delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
        return q, k, v, dout, out, lse, delta, scale

    for q_shape, tk, dtype in BACKWARD_CASES:
        q, k, v, dout, out, lse, delta, scale = prepared(q_shape, tk, dtype)
        dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta, scale)
        dq = flash_backward_dq(q, k, v, dout, lse, delta, scale)
        torch.cuda.synchronize()
        ref_dq, ref_dk, ref_dv = flash_backward_reference(q, k, v, out, lse, dout, scale)
        what = f"q {q_shape} Tk={tk} {dtype}"
        again = (*flash_backward_dkv(q, k, v, dout, lse, delta, scale),
                 flash_backward_dq(q, k, v, dout, lse, delta, scale))
        if not all(torch.equal(a, b) for a, b in zip(again, (dk, dv, dq))):
            raise AssertionError(f"K4/K5 {what}: two calls on the same inputs differ")
        worst["K4"] = max(worst["K4"], check_close(f"K4 {what} dk", dk, ref_dk, *TOL[dtype]),
                          check_close(f"K4 {what} dv", dv, ref_dv, *TOL[dtype]))
        worst["K5"] = max(worst["K5"], check_close(f"K5 {what} dq", dq, ref_dq, *TOL[dtype]))

    q_shape, tk, dtype = FLASH_CASES[0]
    q, k, v, dout, out, lse, delta, scale = prepared(q_shape, tk, dtype)
    ms = {"K4": time_ms(lambda: flash_backward_dkv(q, k, v, dout, lse, delta, scale)),
          "K5": time_ms(lambda: flash_backward_dq(q, k, v, dout, lse, delta, scale))}
    plain = time_ms(lambda: flash_backward_reference(q, k, v, out, lse, dout, scale))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(*leaves)
    library = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True))
    bh, t, d = q_shape[0] * q_shape[1], q_shape[2], q_shape[3]
    reads = 4 * q.numel() * 4 + 2 * bh * t * 4  # q, k, v, dO; lse, delta
    # K4: QK^T, dO V^T, P^T dO, dS^T Q; K5: QK^T, dO V^T, dS K; each
    # recomputes one exponential per score
    ops = {"K4": 8 * bh * t * tk * d, "K5": 6 * bh * t * tk * d}
    bounds = {"K4": attention_bound(reads + 2 * q.numel() * 4, ops["K4"], bh * t * tk, dtype),
              "K5": attention_bound(reads + q.numel() * 4, ops["K5"], bh * t * tk, dtype)}
    records = []
    for name, record in (("K4", K4), ("K5", K5)):
        bound, bound_by, term = bounds[name]
        log(f"  timing {name} {q_shape} {dtype}: kernel {ms[name]:.4f} ms, bound {bound:.4f} ms "
            f"({term}; products {flash_product_ms(ops[name])}) [{card}]")
        records.append(dict(name=record.name, route="cuda", source=record.source,
                            replaces=record.replaces, max_abs_err=worst[name], ms=ms[name],
                            plain_ms=plain, bound_ms=bound, bound_by=bound_by, bound_term=term,
                            library_ms=library, shape=list(q_shape), dtype=dtype))
    log(f"  every case bitwise equal across two calls; K4 + K5 {ms['K4'] + ms['K5']:.4f} ms, "
        f"plain backward (dq, dk, dv) {plain:.4f} ms, autograd of "
        f"F.scaled_dot_product_attention (dq, dk, dv) {library:.4f} ms [{card}]")
    return records


def random_weights(torch, model, gen) -> None:
    """Draw every parameter from ``gen``: U(±1/√fan_in) for conv weights,
    1±0.1 / ±0.1 for GroupNorm affines, U(±0.1) for other biases."""
    import math

    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                bound = 1.0 / math.sqrt(math.prod(p.shape[1:]))
                draw = torch.empty(p.shape).uniform_(-bound, bound, generator=gen)
            elif "norm" in name.split(".")[-2]:
                draw = (1.0 if name.endswith("weight") else 0.0) + 0.1 * torch.randn(
                    p.shape, generator=gen)
            else:
                draw = torch.empty(p.shape).uniform_(-0.1, 0.1, generator=gen)
            p.copy_(draw)


def read_counts(records) -> dict:
    return {r.name.split()[0]: r.launches for r in records}


def expect_counts(what: str, counts: dict, want: dict, calls: int = 1) -> None:
    got = {k: v / calls for k, v in counts.items() if v or k in want}
    if got != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"{what}: launches per call {got}; expected {want}")


def rel_err(got, ref) -> float:
    return max_err(got, ref) / float(ref.float().abs().max())


def phase_vae(torch, card: str, seed: int, gen, records):
    """Phases [10]-[12]; returns the launch counts of the timed train steps
    and the K1 calls of one reconstruct."""
    from fmdm_tpu_torch.sample.vae_utils import (
        build_vae_model, decode_vae_batch, encode_vae_batch, reconstruct_vae_batch)
    from fmdm_tpu_torch.train.vae_impl import KLTrainStep

    log("[10] full-width KL-VAE forward at the posterior mode: card (K1, K3) vs CPU plain path, "
        "f32, TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = json.loads(VAE_CONFIG.read_text())
    model = build_vae_model(cfg, generator=torch.Generator().manual_seed(seed), device="cuda")
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    cpu_model = copy.deepcopy(model).cpu()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.rand((1, 1, 256, 256), generator=gen)
    inputs = model.image_to_model_range(x)
    with torch.no_grad():
        with recording_k1() as k1_calls:
            model(inputs.cuda(), sample_posterior=False)  # warm-up
        torch.cuda.synchronize()
        reset_counts(records)
        start = time.perf_counter()
        rec, posterior = model(inputs.cuda(), sample_posterior=False)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - start
        counts = read_counts(records)
        start = time.perf_counter()
        rec_cpu, posterior_cpu = cpu_model(inputs, sample_posterior=False)
        cpu_s = time.perf_counter() - start
    expect_counts("the VAE reconstruct", counts, VAE_LAUNCHES["reconstruct"])
    errs = (rel_err(rec.cpu(), rec_cpu), rel_err(posterior.mode().cpu(), posterior_cpu.mode()))
    log(f"  {n_params} parameters; reconstruction {tuple(rec.shape)}, latent "
        f"{tuple(posterior.mode().shape)}; max|gpu-cpu|/max|cpu| = {errs[0]:.3e} "
        f"(reconstruction), {errs[1]:.3e} (latent mean) (tolerance {REL_TOL:g})")
    log(f"  launches per reconstruct: K1 {counts['K1']} (device launches by variant "
        f"{records[0].variants}), K3 {counts['K3']}; forward {fwd_s * 1e3:.2f} ms on the card, "
        f"{cpu_s:.2f} s on the CPU [{card}]")
    if not (torch.isfinite(rec).all() and max(errs) <= REL_TOL):
        raise AssertionError(f"card VAE forward disagrees with the CPU plain path ({errs})")

    log("[11] KL-VAE train step (L1 + kl_weight * KL, AdamW), f32, TF32 off: batch 1 card vs "
        "CPU plain path, same posterior noise")
    training = cfg["training"]
    lr = float(training["learning_rate"])
    trainers = [KLTrainStep(m, training) for m in (model, cpu_model)]
    raw = torch.rand((1, 1, 256, 256), generator=gen)
    valid = torch.ones(1)
    noise = torch.randn((1, 4, 32, 32), generator=gen)
    before = [p.detach().cpu().clone() for p in model.parameters()]
    reset_counts(records)
    metrics_gpu, _ = trainers[0].step(raw.cuda(), valid.cuda(), noise=noise.cuda())
    torch.cuda.synchronize()
    expect_counts("the VAE train step", read_counts(records), VAE_LAUNCHES["train step"])
    start = time.perf_counter()
    metrics_cpu, _ = trainers[1].step(raw, valid, noise=noise)
    cpu_s = time.perf_counter() - start
    loss_rel = abs(float(metrics_gpu["loss"]) - float(metrics_cpu["loss"])) / abs(
        float(metrics_cpu["loss"]))
    worst_grad, worst_name, flips = 0.0, "", 0
    card_params = []
    for (name, pg), pc, p0 in zip(model.named_parameters(), cpu_model.parameters(), before):
        err = rel_err(pg.grad.cpu(), pc.grad)
        if err > worst_grad:
            worst_grad, worst_name = err, name
        after = pg.detach().cpu()
        card_params.append((p0, pg.grad.cpu(), after))
        # an AdamW step moves an element by at most lr; the two sides may take
        # opposite signs only where the gradient is at rounding level
        gap = (after - pc.detach()).abs()
        if float(gap.max()) > 2 * lr * (1 + 1e-3):
            raise AssertionError(f"{name}: card and CPU parameters {float(gap.max())} apart "
                                 f"after one AdamW step of lr {lr}")
        flips += int((gap > 1e-3 * lr).sum())
    # the card's update is AdamW's: the CPU optimizer on the card's own
    # gradients and parameters gives the card's parameters within f32 ulps
    replay = [p0.clone().requires_grad_(True) for p0, _, _ in card_params]
    for p, (_, g, _) in zip(replay, card_params):
        p.grad = g
    torch.optim.AdamW(replay, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                      weight_decay=float(training["weight_decay"])).step()
    update_err = max(max_err(p.detach(), after) for p, (_, _, after) in zip(replay, card_params))
    log(f"  loss card {float(metrics_gpu['loss']):.6f} CPU {float(metrics_cpu['loss']):.6f} "
        f"(rel {loss_rel:.3e}); worst gradient max|gpu-cpu|/max|cpu| {worst_grad:.3e} "
        f"({worst_name}); parameters after AdamW: {flips} of {n_params} elements differ by more "
        f"than 1e-3*lr, none by more than 2*lr; card update vs AdamW replayed on the CPU "
        f"{update_err:.3e}; CPU step {cpu_s:.2f} s")
    if not (loss_rel <= REL_TOL and worst_grad <= REL_TOL and update_err <= 1e-6):
        raise AssertionError(f"card train step disagrees with the CPU plain path (loss {loss_rel}, "
                             f"gradient {worst_grad} at {worst_name}, update {update_err})")
    del cpu_model, trainers[1], card_params, replay, before

    batch = int(training["batch_size"])
    raw = torch.rand((batch, 1, 256, 256), generator=gen).cuda()
    valid = torch.ones(batch, device="cuda")
    noise_gen = torch.Generator("cuda").manual_seed(seed)
    trainers[0].step(raw, valid, generator=noise_gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(records)
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics, _ = trainers[0].step(raw, valid, generator=noise_gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - start) / TRAIN_STEPS
    train_counts = read_counts(records)
    expect_counts("a timed VAE train step", train_counts, VAE_LAUNCHES["train step"], TRAIN_STEPS)
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError("the timed VAE train steps gave a non-finite loss")
    log(f"  batch {batch}, {TRAIN_STEPS} steps: {step_s * 1e3:.2f} ms per step, "
        f"{batch / step_s:.2f} images/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches per step {({k: v // TRAIN_STEPS for k, v in train_counts.items() if v})}, "
        f"last loss {float(metrics['loss']):.6f} [{card}]")

    log(f"[12] KL-VAE serving at batch {batch}, f32, TF32 off")
    model.eval()
    images = torch.rand((batch, 1, 256, 256), generator=gen).cuda()
    with torch.no_grad():
        latents = encode_vae_batch(model, images)
        calls = (("encode", lambda: encode_vae_batch(model, images)),
                 ("decode", lambda: decode_vae_batch(model, latents)),
                 ("reconstruct", lambda: reconstruct_vae_batch(model, images)))
        for what, fn in calls:
            fn()  # warm-up
            torch.cuda.synchronize()
            reset_counts(records)
            start = time.perf_counter()
            for _ in range(SERVE_CALLS):
                out = fn()
            torch.cuda.synchronize()
            call_s = (time.perf_counter() - start) / SERVE_CALLS
            counts = read_counts(records)
            expect_counts(f"VAE {what}", counts, VAE_LAUNCHES[what], SERVE_CALLS)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"VAE {what}: non-finite output")
            log(f"  {what}: output {tuple(out.shape)}, {call_s * 1e3:.2f} ms per call, "
                f"{batch / call_s:.2f} images/s, launches per call "
                f"{({k: v // SERVE_CALLS for k, v in counts.items() if v})} [{card}]")
    return train_counts, k1_calls


def reset_counts(records) -> None:
    for r in records:
        r.reset()


def phase_sdpa_routes(torch, card: str, gen, records) -> None:
    """[14]: sdpa on the card at shapes no kernel takes, against sdpa_xla on
    the CPU; no kernel may launch."""
    from fmdm_tpu_torch.ops.attention import kernel_route, sdpa, sdpa_xla

    log("[14] sdpa's plain route on the card (shapes no kernel takes) vs sdpa_xla on the CPU")
    reset_counts(records)
    for q_shape, tk, dtype, what in SDPA_PLAIN_CASES:
        q, k, v, _ = flash_inputs(torch, gen, q_shape, tk, dtype)
        route = kernel_route(q, k, v)
        if route != "sdpa_xla":
            raise AssertionError(f"sdpa q {q_shape} Tk={tk} {dtype}: route {route}, not sdpa_xla")
        got = sdpa(q, k, v)
        torch.cuda.synchronize()
        ref = sdpa_xla(q.cpu(), k.cpu(), v.cpu())
        check_close(f"{what}: q {q_shape} Tk={tk} {dtype} [{route}]", got.cpu(), ref, *TOL[dtype])
    if any(r.launches for r in records):
        raise AssertionError(f"sdpa's plain route launched a kernel: {read_counts(records)}")


def phase_cross_attention(torch, card: str, seed: int, gen, records) -> None:
    """[15]: the attention-conditioned flagship's forward, card vs CPU."""
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
    from fmdm_tpu_torch.sample.engine import normalize_latent_conditioning, prepare_attention_context

    log("[15] full-width forward of the attention-conditioned flagship (mid block "
        "UNetMidBlock2DCrossAttn to a 4x32x32 latent): card (K1, K2, sdpa_xla) vs CPU plain path, "
        "f32, TF32 off")
    cfg = json.loads(ATTENTION_CONFIG.read_text())
    model = DiffusionUNetFactory().build(cfg["model"]["unet"], conditioning="attention", channels=1,
                                         device="cuda")
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.randn((1, 1, 256, 256), generator=gen)
    # the conditioning is a KL-VAE latent of a 256² slice, standardized per sample
    latent = torch.randn((1, 4, 32, 32), generator=gen)
    ctx = prepare_attention_context(normalize_latent_conditioning(latent,
                                                                  cfg["training"]["latent_norm"]))
    t = torch.tensor([500])
    with torch.no_grad():
        model(x.cuda(), t.cuda(), context_ca=ctx.cuda())  # warm-up
        torch.cuda.synchronize()
        reset_counts(records)
        y = model(x.cuda(), t.cuda(), context_ca=ctx.cuda())
        torch.cuda.synchronize()
        counts = read_counts(records)
        start = time.perf_counter()
        y_cpu = cpu_model(x, t, context_ca=ctx)
        cpu_s = time.perf_counter() - start
    expect_counts("the cross-attention forward", counts, CROSS_ATTENTION_LAUNCHES)
    rel = rel_err(y.cpu(), y_cpu)
    log(f"  output {tuple(y.shape)}; max|gpu-cpu|/max|cpu| = {rel:.3e} (tolerance {REL_TOL:g}); "
        f"launches per forward {({k: v for k, v in counts.items() if v})}; the mid block's "
        f"cross-attention takes sdpa_xla; {cpu_s:.2f} s on the CPU [{card}]")
    if not (torch.isfinite(y).all() and rel <= REL_TOL):
        raise AssertionError(f"card cross-attention forward disagrees with the CPU plain path ({rel})")


def grad_errors(model, cpu_model):
    """The worst (error, name) over the parameters: max|gpu - cpu| of the
    gradients over max|cpu|. A key projection's bias gets no gradient but
    rounding (the softmax cancels a shift of the keys), so its error is taken
    over the largest gradient of the projection's weight instead."""
    cpu_grads = {name: p.grad for name, p in cpu_model.named_parameters()}
    worst = (0.0, "")
    for name, p in model.named_parameters():
        ref = cpu_grads[name]
        scale = cpu_grads[name[:-len("bias")] + "weight"] if name.endswith("to_k.bias") else ref
        worst = max(worst, (max_err(p.grad.cpu(), ref) / float(scale.abs().max()), name))
    return worst


def train_batch(torch, gen, batch: int, device: str) -> dict:
    """A synthetic batch of 256² slices in [-1, 1] (targets and conditioning)."""
    shape = (batch, 1, 256, 256)
    return {"target": (torch.rand(shape, generator=gen) * 2 - 1).to(device),
            "image": (torch.rand(shape, generator=gen) * 2 - 1).to(device),
            "valid": torch.ones(batch, device=device)}


def phase_denoise(torch, card: str, seed: int, gen, records):
    """Phases [16]-[18]: the flagship's denoise train step and DDPM sampling;
    returns the launch counts of the timed train steps."""
    from fmdm_tpu_torch.sample.engine import SamplingEngine
    from fmdm_tpu_torch.schedulers import build_scheduler
    from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer

    log("[16] flagship denoise train step (DDPM, AdamW at the cosine-warmup rate), f32, TF32 off: "
        "batch 1 card vs CPU plain path, same noise and t")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = json.loads(CONFIG.read_text())
    training = cfg["training"]
    batch = int(training["train_batch_size"])
    warmup = int(training["lr_warmup_steps"])
    # num_samples sets only the schedule's length: every step here runs past
    # the warmup, where the rate is the config's learning rate
    model, scheduler, step = build_denoise_trainer(cfg, variant="diffusion", num_samples=batch,
                                                   device="cuda")
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    cpu_model, _, cpu_step = build_denoise_trainer(cfg, variant="diffusion", num_samples=batch,
                                                   device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    step.global_step = cpu_step.global_step = warmup
    lr = step.lr_schedule(warmup)
    n_params = sum(p.numel() for p in model.parameters())
    data = train_batch(torch, gen, 1, "cpu")
    noise = torch.randn((1, 1, 256, 256), generator=gen)
    t = torch.randint(0, scheduler.num_train_timesteps, (1,), generator=gen)
    before = [p.detach().cpu().clone() for p in model.parameters()]
    reset_counts(records)
    loss_gpu, _ = step.step({k: v.cuda() for k, v in data.items()}, noise=noise.cuda(), t=t.cuda())
    torch.cuda.synchronize()
    expect_counts("the flagship train step", read_counts(records), DENOISE_LAUNCHES)
    start = time.perf_counter()
    loss_cpu, _ = cpu_step.step(data, noise=noise, t=t)
    cpu_s = time.perf_counter() - start
    loss_rel = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    worst_grad, worst_name = grad_errors(model, cpu_model)
    # the card's update is AdamW's: the CPU optimizer on the card's own
    # gradients and parameters gives the card's parameters within f32 ulps
    replay = [p0.clone().requires_grad_(True) for p0 in before]
    for p, pg in zip(replay, model.parameters()):
        p.grad = pg.grad.cpu()
    torch.optim.AdamW(replay, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                      weight_decay=float(training["weight_decay"])).step()
    update_err = max(max_err(p.detach(), pg.detach().cpu())
                     for p, pg in zip(replay, model.parameters()))
    moved = max(max_err(pg.detach().cpu(), p0) for pg, p0 in zip(model.parameters(), before))
    log(f"  {n_params} parameters, t = {int(t)}, rate {lr:g}; loss card {float(loss_gpu):.6f} CPU "
        f"{float(loss_cpu):.6f} (rel {loss_rel:.3e}); worst gradient max|gpu-cpu|/max|cpu| "
        f"{worst_grad:.3e} ({worst_name}; each to_k.bias over its weight's largest); card "
        f"update vs AdamW replayed on the CPU {update_err:.3e} "
        f"(largest move {moved:.3e}); launches per step {DENOISE_LAUNCHES}; CPU step "
        f"{cpu_s:.2f} s [{card}]")
    if not (loss_rel <= REL_TOL and worst_grad <= REL_TOL and update_err <= 1e-6 and moved > 0):
        raise AssertionError(f"card train step disagrees with the CPU plain path (loss {loss_rel}, "
                             f"gradient {worst_grad} at {worst_name}, update {update_err})")
    del cpu_step, replay, before

    log(f"[17] flagship denoise train step, {TRAIN_STEPS} timed steps at the config's batch "
        f"{batch}, f32, TF32 off; one flow-matching step")
    data = train_batch(torch, gen, batch, "cuda")
    noise_gen = torch.Generator("cuda").manual_seed(seed)
    step.step(data, generator=noise_gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(records)
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        loss_sum, count = step.step(data, generator=noise_gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - start) / TRAIN_STEPS
    train_counts = read_counts(records)
    expect_counts("a timed flagship train step", train_counts, DENOISE_LAUNCHES, TRAIN_STEPS)
    if not (bool(torch.isfinite(loss_sum)) and float(count) == batch):
        raise AssertionError(f"the timed train steps gave loss {float(loss_sum)}, count {float(count)}")
    log(f"  batch {batch}, {TRAIN_STEPS} steps: {step_s * 1e3:.2f} ms per step, "
        f"{batch / step_s:.2f} images/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches per step {({k: v // TRAIN_STEPS for k, v in train_counts.items() if v})}, "
        f"last mean loss {float(loss_sum) / batch:.6f} [{card}]")
    flow_cfg = json.loads(FLOW_CONFIG.read_text())
    _, flow_sched, flow_step = build_denoise_trainer(flow_cfg, variant="flow_matching",
                                                     num_samples=batch, device="cuda")
    flow_step.global_step = warmup
    reset_counts(records)
    flow_loss, _ = flow_step.step(data, generator=noise_gen)
    torch.cuda.synchronize()
    expect_counts("a flow-matching train step", read_counts(records), DENOISE_LAUNCHES)
    log(f"  flow matching ({type(flow_sched).__name__}), batch {batch}: mean loss "
        f"{float(flow_loss) / batch:.6f}")
    if not bool(torch.isfinite(flow_loss)):
        raise AssertionError("the flow-matching train step gave a non-finite loss")
    del flow_step, flow_sched

    log(f"[18] DDPM sampling: the first {DDPM_STEPS} steps of the config's schedule, f32, batch 1, "
        f"card vs CPU plain path with the same noise per step; then {DDPM_BF16_STEPS} bf16 steps "
        f"at batch {batch} from a CUDA generator")
    ddpm, n_inference = build_scheduler(cfg["model"]["scheduler"], training)
    timesteps = ddpm.set_timesteps(n_inference)
    shape = (1, 1, 256, 256)
    init = torch.randn(shape, generator=gen)
    cond = torch.rand(shape, generator=gen) * 2 - 1
    noises = [torch.randn(shape, generator=gen) for _ in range(DDPM_STEPS)]
    cpu_model.load_state_dict(model.state_dict())
    short = []
    for m, d in ((model, "cuda"), (cpu_model, "cpu")):
        engine = SamplingEngine(m, ddpm, timesteps[:DDPM_STEPS], conditioning_mode="concatenate",
                                device=d)
        short.append(engine(shape, conditioning_batch=cond, init_sample=init,
                            step_noise=noises).cpu())
    rel = rel_err(*short)
    log(f"  timesteps {timesteps[:DDPM_STEPS].tolist()}: max|gpu-cpu|/max|cpu| = {rel:.3e} "
        f"(tolerance {REL_TOL:g})")
    if not (torch.isfinite(short[0]).all() and rel <= REL_TOL):
        raise AssertionError(f"card DDPM steps disagree with the CPU plain path (rel {rel})")
    del cpu_model
    engine = SamplingEngine(model, ddpm, timesteps[:DDPM_BF16_STEPS], conditioning_mode="concatenate",
                            compute_dtype=torch.bfloat16, device="cuda")
    shape = (batch, 1, 256, 256)
    cond = torch.full(shape, 0.5, device="cuda")
    engine(shape, torch.Generator("cuda").manual_seed(seed), conditioning_batch=cond)  # warm-up
    reset_counts(records)
    timing = {}
    out = engine(shape, torch.Generator("cuda").manual_seed(seed), conditioning_batch=cond,
                 timing=timing)
    expect_counts("bf16 DDPM sampling", read_counts(records), DENOISE_LAUNCHES, DDPM_BF16_STEPS)
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bf16 DDPM sample: shape {tuple(out.shape)} or non-finite values")
    log(f"  bf16, batch {batch}: {DDPM_BF16_STEPS} steps in {timing['model_seconds']:.4f} s, "
        f"output mean {float(out.mean()):.4f} std {float(out.std()):.4f} [{card}]")
    return train_counts


def phase_schedulers(torch, gen) -> None:
    """[19]: each scheduler of the decode path over a whole schedule, card
    against CPU, on the same model outputs and noise (no model)."""
    from fmdm_tpu_torch.schedulers import build_scheduler

    shape = (DECODE_BATCH, 1, 256, 256)
    log(f"[19] the decode path's schedulers, {SCHEDULER_STEPS} steps at {shape} f32: card vs CPU "
        f"on the same model outputs and noise")
    for name, params in NEW_SCHEDULERS:
        scheduler, _ = build_scheduler({"name": name, "params": params}, {})
        timesteps = scheduler.set_timesteps(SCHEDULER_STEPS)
        start = torch.randn(shape, generator=gen) * scheduler.init_noise_scale(timesteps)
        outputs = [torch.randn(shape, generator=gen) for _ in timesteps]
        noises = [torch.randn(shape, generator=gen) for _ in timesteps] if scheduler.needs_noise \
            else None
        ends = []
        for device in ("cuda", "cpu"):
            x = start.to(device)
            state = scheduler.init_state(timesteps, x)
            for i in range(len(timesteps)):
                noise = {"noise": noises[i].to(device)} if noises else {}
                state, x = scheduler.step(state, outputs[i].to(device), i, x, timesteps, **noise)
            ends.append(x.cpu())
        rel = rel_err(*ends)
        what = f"{name} {params or ''}".strip()
        log(f"  {what}: {len(timesteps)} steps, max|gpu-cpu|/max|cpu| = {rel:.3e} "
            f"(tolerance {SCHEDULER_REL_TOL:g})")
        if not (torch.isfinite(ends[0]).all() and rel <= SCHEDULER_REL_TOL):
            raise AssertionError(f"{what}: the card's steps disagree with the CPU's (rel {rel})")


def image_range(x):
    """Model range [-1, 1] -> [0, 1], clipped (the evaluation's range)."""
    return ((x.float() + 1) / 2).clamp(0, 1)


def phase_decode(torch, card: str, seed: int, gen, records) -> dict:
    """[20]: decode the flagship from a trained run dir under every scheduler;
    returns the K1 and K2 launches of the timed decodes."""
    import tempfile

    from fmdm_tpu_torch.sample.diffusion_utils import (
        build_diffusion_model, decode_diffusion_batch, set_use_ema)
    from fmdm_tpu_torch.sample.sampling_utils import load_run_config, resolve_checkpoint
    from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer
    from fmdm_tpu_torch.utils.checkpoint import save_checkpoint
    from fmdm_tpu_torch.utils.config import save_json_config
    from fmdm_tpu_torch.utils.evaluation import compute_ssim_sample, psnr_from_mse

    log(f"[20] a trained run's decode at full width: run dir -> build_diffusion_model -> "
        f"decode_diffusion_batch, f32, TF32 off, batch {DECODE_BATCH}, {DECODE_STEPS} steps")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = json.loads(CONFIG.read_text())
    cfg["training"]["ema_decay"] = 0.999   # a run trained with EMA records it
    with tempfile.TemporaryDirectory() as tmp:
        run_dir, flow_dir = Path(tmp) / "ddpm", Path(tmp) / "flow"
        save_json_config(run_dir / "train_config.json", cfg)
        # the --seed weights after one AdamW step at batch 1, and their EMA
        model, _, step = build_denoise_trainer(cfg, variant="diffusion", num_samples=1,
                                               device="cuda")
        random_weights(torch, model, torch.Generator().manual_seed(seed))
        step.ema = [p.detach().clone() for p in model.parameters()]
        step.global_step = int(cfg["training"]["lr_warmup_steps"])  # past the warmup's zero rate
        loss, _ = step.step(train_batch(torch, gen, 1, "cuda"),
                            generator=torch.Generator("cuda").manual_seed(seed))
        written = {"model": {k: v.cpu() for k, v in model.state_dict().items()},
                   "ema": {k: v.cpu() for k, v in step.ema_state_dict().items()}}
        save_checkpoint({"model": written["model"], "ema": written["ema"],
                         "optimizer": step.optimizer, "lr_scheduler": {"last_epoch": 1},
                         "scaler": None, "epoch": 1, "best_metric": float(loss)},
                        run_dir / "diff_last.pt")
        del model, step
        run_cfg = load_run_config(run_dir)
        ckpt = resolve_checkpoint(run_dir, run_cfg["model"]["model_type"])
        for tree in ("ema", "model"):
            set_use_ema(tree == "ema")
            model = build_diffusion_model(run_cfg, ckpt, device="cuda")
            loaded = model.state_dict()
            same = loaded.keys() == written[tree].keys() and all(
                torch.equal(loaded[k].cpu(), v) for k, v in written[tree].items())
            log(f"  {ckpt.name} '{tree}' tree: {len(loaded)} tensors, equal to the written ones "
                f"bitwise: {same}")
            if not same:
                raise AssertionError(f"the '{tree}' tree read back from {ckpt} differs")
        set_use_ema(False)
        moved = max(max_err(loaded[k].cpu(), written["ema"][k]) for k in loaded)
        if moved == 0:
            raise AssertionError("the EMA tree equals the model's: the check cannot tell them apart")

        training, model_cfg = run_cfg["training"], run_cfg["model"]
        shape = (DECODE_BATCH, 1, 256, 256)
        cond = (torch.rand(shape, generator=gen) * 2 - 1).cuda()
        reference = (torch.rand(shape, generator=gen) * 2 - 1).cuda()
        decode_gen = torch.Generator("cuda")
        decode_diffusion_batch(model, training, model_cfg, shape, cond, generator=decode_gen,
                               num_inference_steps=2, device="cuda")  # warm-up: cuDNN's first calls

        def timed_decode(label, model, training, model_cfg, override, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(records)
            timing = {}
            out = decode_diffusion_batch(model, training, model_cfg, shape, cond,
                                         generator=decode_gen.manual_seed(seed), timing=timing,
                                         num_inference_steps=DECODE_STEPS,
                                         reference_batch=reference, scheduler_override=override,
                                         device="cuda", **kw)
            calls, secs = timing["model_calls"], timing["model_seconds"]
            counts = read_counts(records)
            expect_counts(f"decode '{label}'", counts, DENOISE_LAUNCHES, calls)
            finite = bool(torch.isfinite(out).all())
            log(f"  {label}: {calls} model calls in {secs:.4f} s, "
                f"{DECODE_BATCH * calls / secs:.2f} denoise steps/s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches K1 {counts['K1']} "
                f"K2 {counts['K2']}, finite={finite}, output mean {float(out.mean()):.4f} std "
                f"{float(out.std()):.4f} [{card}]")
            if tuple(out.shape) != shape or not finite:
                raise AssertionError(f"decode '{label}': shape {tuple(out.shape)} or non-finite")
            return counts

        totals = {"K1": 0, "K2": 0}
        for label, override, kw in DECODE_RUNS:
            counts = timed_decode(label, model, training, model_cfg, override, **kw)
            totals = {k: totals[k] + counts[k] for k in totals}

        flow_cfg = json.loads(FLOW_CONFIG.read_text())
        save_json_config(flow_dir / "train_config.json", flow_cfg)
        flow = build_diffusion_model(flow_cfg, device="cuda")
        random_weights(torch, flow, torch.Generator().manual_seed(seed + 1))
        save_checkpoint({"model": flow, "epoch": 1}, flow_dir / "flow_last.pt")
        flow_run = load_run_config(flow_dir)
        flow_ckpt = resolve_checkpoint(flow_dir, flow_run["model"]["model_type"])
        flow = build_diffusion_model(flow_run, flow_ckpt, device="cuda")
        counts = timed_decode(f"flow matching from {flow_ckpt.name} "
                              f"({flow_run['model']['scheduler']['name']})", flow,
                              flow_run["training"], flow_run["model"], None)
        totals = {k: totals[k] + counts[k] for k in totals}
        del flow

        cpu_model = build_diffusion_model(run_cfg, ckpt, device="cpu")
        one = (1, 1, 256, 256)
        for steps, override in DECODE_PARITY:
            init = torch.randn(one, generator=gen)
            noises = [torch.randn(one, generator=gen) for _ in range(2 * steps - 1)]
            outs = []
            for m, device in ((model, "cuda"), (cpu_model, "cpu")):
                timing = {}
                out = decode_diffusion_batch(
                    m, training, model_cfg, one, cond[:1].to(device), timing=timing,
                    num_inference_steps=steps, scheduler_override=override, init_noise=init,
                    step_noise=noises if "sde" in override else None, device=device)
                outs.append(out.cpu())
            rel = rel_err(*outs)
            mse = float(((image_range(outs[0]) - image_range(outs[1])) ** 2).mean())
            ssim = compute_ssim_sample(image_range(outs[0])[0].numpy(), image_range(outs[1])[0].numpy())
            log(f"  card vs CPU, {override}, {timing['model_calls']} model calls at batch 1: "
                f"max|gpu-cpu|/max|cpu| = {rel:.3e} (tolerance {REL_TOL:g}); PSNR "
                f"{psnr_from_mse(mse):.2f} dB, SSIM {ssim:.6f} (images in [0, 1])")
            if not (torch.isfinite(outs[0]).all() and rel <= REL_TOL):
                raise AssertionError(f"decode {override}: card disagrees with the CPU (rel {rel})")
    return totals


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batches", default="8,32",
                        help="sample batch sizes; the first one's run counts the launches")
    args = parser.parse_args()
    batches = [int(b) for b in args.batches.split(",")]

    run_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
    from fmdm_tpu_torch.nn.layers import init_weights
    from fmdm_tpu_torch.ops.kernels import build
    from fmdm_tpu_torch.ops.kernels.flash_attention import K3, K4, K5
    from fmdm_tpu_torch.ops.kernels.group_norm import K1
    from fmdm_tpu_torch.ops.kernels.small_t_attention import K2
    from fmdm_tpu_torch.sample.engine import SamplingEngine
    from fmdm_tpu_torch.schedulers import DPMSolverMultistepScheduler

    records = (K1, K2)
    card = card_line()
    log(f"[1] card: {card}; maximum SM clock {max_sm_clock_mhz():.0f} MHz, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    info = build.build()
    lib = build.library()
    log(f"[2] kernels built by nvcc for sm_90a from {build.CSRC_DIR.relative_to(REPO_ROOT)}: "
        f"{[p.name for p in sorted(build.CSRC_DIR.glob('*.cu'))]} -> "
        f"{info.path.relative_to(REPO_ROOT)} in {info.seconds:.1f} s; loaded {lib._name}")
    for line in info.log.splitlines():
        if "ptxas" in line and ("Used" in line or "spill" in line or "Compiling" in line):
            log(f"    {line.strip()}")

    # the kernels SDPA launches at K2's and K3's timed shapes (self-attention)
    library_kernels = sdpa_kernels(torch, k2_timed(batches[0]) + [FLASH_CASES[0][::2]])

    gen = torch.Generator().manual_seed(args.seed)
    k1_gen = torch.Generator().manual_seed(args.seed + 1)
    k1 = phase_k1(torch, card, gen, k1_gen, batches[0])
    k2 = phase_k2(torch, card, gen, torch.Generator().manual_seed(args.seed + 2), batches[0],
                  library_kernels)

    log("[5] full-width flagship forward: card (K1, K2) vs CPU plain path, f32, TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = json.loads(CONFIG.read_text())["model"]["unet"]
    model = DiffusionUNetFactory().build(cfg, conditioning="concatenate", channels=1, device="cuda")
    init_weights(model, torch.Generator().manual_seed(args.seed)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.randn((1, 2, 256, 256), generator=gen)
    t = torch.tensor([500])
    with torch.no_grad():
        with recording_k1() as flagship_k1_calls:
            model(x.cuda(), t.cuda())  # warm-up
        torch.cuda.synchronize()
        reset_counts(records)
        start = time.perf_counter()
        y_gpu = model(x.cuda(), t.cuda())
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - start
        counts = (K1.launches, K2.launches)
        y_gpu = y_gpu.cpu()
        start = time.perf_counter()
        cpu_model = copy.deepcopy(model).cpu()
        y_cpu = cpu_model(x, t)
        cpu_s = time.perf_counter() - start
    if counts != (K1_PER_FORWARD, K2_PER_FORWARD):
        raise AssertionError(f"one forward launched K1 {counts[0]}x and K2 {counts[1]}x; "
                             f"expected {K1_PER_FORWARD} and {K2_PER_FORWARD}")
    if (K1.launches, K2.launches) != counts:
        raise AssertionError("the CPU forward launched a kernel")
    rel = max_err(y_gpu, y_cpu) / float(y_cpu.abs().max())
    log(f"  {n_params} parameters; output {tuple(y_gpu.shape)} finite="
        f"{bool(torch.isfinite(y_gpu).all())}; max|gpu-cpu|/max|cpu| = {rel:.3e} "
        f"(tolerance {REL_TOL:g})")
    log(f"  launches per forward: K1 {counts[0]}, K2 {counts[1]}; forward {fwd_s * 1e3:.2f} ms "
        f"on the card, {cpu_s:.2f} s on the CPU [{card}]")
    if len(flagship_k1_calls) != K1_PER_FORWARD:
        raise AssertionError(f"recorded {len(flagship_k1_calls)} K1 calls in one forward")
    if not (torch.isfinite(y_gpu).all() and rel <= REL_TOL):
        raise AssertionError(f"card forward disagrees with the CPU plain path (rel {rel})")

    scheduler = DPMSolverMultistepScheduler.create(
        num_train_timesteps=1000, algorithm_type="dpmsolver++", solver_order=2,
        beta_start=0.0001, beta_end=0.02)
    timesteps = scheduler.set_timesteps(NUM_STEPS)

    log("[6] the sampling loop: first 3 DPM++ steps, f32, batch 1, card vs CPU plain path")
    shape = (1, 1, 256, 256)
    init = torch.randn(shape, generator=gen)
    cond = torch.full(shape, 0.5)
    short = [SamplingEngine(m, scheduler, timesteps[:3], conditioning_mode="concatenate",
                            device=d)(shape, conditioning_batch=cond, init_sample=init).cpu()
             for m, d in ((model, "cuda"), (cpu_model, "cpu"))]
    rel = max_err(*short) / float(short[1].abs().max())
    log(f"  max|gpu-cpu|/max|cpu| = {rel:.3e} (tolerance {REL_TOL:g})")
    if not (torch.isfinite(short[0]).all() and rel <= REL_TOL):
        raise AssertionError(f"card sampling loop disagrees with the CPU plain path (rel {rel})")
    del cpu_model

    log(f"[7] {NUM_STEPS}-step DPM-Solver++ (order 2) sample at 256², bf16 model, f32 scheduler")
    engine = SamplingEngine(model, scheduler, timesteps, conditioning_mode="concatenate",
                            compute_dtype=torch.bfloat16, device="cuda")
    main_launches = None
    for batch in batches:
        shape = (batch, 1, 256, 256)
        cond = torch.full(shape, 0.5, device="cuda")
        noise = torch.Generator("cuda").manual_seed(args.seed + batch)
        engine(shape, noise, conditioning_batch=cond)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        timing = {}
        reset_counts(records)
        out = engine(shape, noise, conditioning_batch=cond, timing=timing)
        launches = (K1.launches, K2.launches)
        want = (NUM_STEPS * K1_PER_FORWARD, NUM_STEPS * K2_PER_FORWARD)
        if launches != want:
            raise AssertionError(f"sample batch {batch} launched {launches}; expected {want}")
        # every bf16 flagship call is one launch of the single pass
        if K1.variants != {"single_pass": want[0], "split": 0}:
            raise AssertionError(f"sample batch {batch}: K1 device launches {K1.variants}")
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"sample batch {batch}: shape {tuple(out.shape)} or non-finite values")
        if main_launches is None:
            main_launches, main_variants = launches, dict(K1.variants)
        secs = timing["model_seconds"]
        log(f"  batch {batch}: {secs:.4f} s, {batch * NUM_STEPS / secs:.2f} denoise steps/s, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches K1 {launches[0]} "
            f"K2 {launches[1]}, output mean {float(out.mean()):.4f} std {float(out.std()):.4f} [{card}]")

    k3 = phase_k3(torch, card, gen, torch.Generator().manual_seed(args.seed + 3), library_kernels)
    k4, k5 = phase_k4_k5(torch, card, gen)
    all_records = (K1, K2, K3, K4, K5)
    train_counts, vae_k1_calls = phase_vae(torch, card, args.seed, gen, all_records)
    vae_batch = int(json.loads(VAE_CONFIG.read_text())["training"]["batch_size"])

    log("[13] K1 over the recorded calls of one flagship forward and one VAE reconstruct")
    forward = phase_k1_path(torch, card, k1_gen, "flagship forward", flagship_k1_calls, batches[0],
                            torch.bfloat16)
    if forward["variants"] != {"single_pass": K1_PER_FORWARD, "split": 0}:
        raise AssertionError(f"flagship forward: K1 device launches {forward['variants']}")
    reconstruct = phase_k1_path(torch, card, k1_gen, "VAE reconstruct", vae_k1_calls, vae_batch,
                                torch.float32)
    k1["per_forward"] = {"flagship forward": forward, "VAE reconstruct": reconstruct}
    k1["variants"] = main_variants

    phase_sdpa_routes(torch, card, gen, all_records)
    phase_cross_attention(torch, card, args.seed, gen, all_records)
    denoise_counts = phase_denoise(torch, card, args.seed, gen, all_records)
    phase_schedulers(torch, gen)
    decode_counts = phase_decode(torch, card, args.seed, gen, all_records)

    k1["launches"], k2["launches"] = main_launches
    k3["launches"], k4["launches"], k5["launches"] = (train_counts[k] for k in ("K3", "K4", "K5"))
    # each path's launches, counted from 0 over its run: the sample's, and
    # the TRAIN_STEPS timed steps of each train step
    sample_counts = {"K1": main_launches[0], "K2": main_launches[1]}
    for r in (k1, k2, k3, k4, k5):
        kernel = r["name"].split()[0]
        r["launches_by_path"] = {
            f"{NUM_STEPS}-step sample, batch {batches[0]}": sample_counts.get(kernel, 0),
            f"flagship train step x {TRAIN_STEPS}": denoise_counts[kernel],
            f"VAE train step x {TRAIN_STEPS}": train_counts[kernel],
            f"decode from a run dir, {len(DECODE_RUNS) + 1} runs at batch {DECODE_BATCH}":
                decode_counts.get(kernel, 0)}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "bound_term", "library_ms", "shape", "dtype")
    extra = ("library_kernel", "variants", "per_forward", "launches_by_path")
    log(f"whole run: {time.perf_counter() - run_start:.1f} s")
    log(json.dumps({"kernels": [{**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
                                for r in (k1, k2, k3, k4, k5)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
