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
   paths (2 KB at batch 32 to 1 MB in bf16, 2 MB in f32, and the VQ-VAE's
   one channel per group at (4, 32, 256, 256)), a ragged last
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
6. the first 2 steps of that sample in f32 at batch 1 through
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
    parameters after the update; then 2 timed steps at the config's batch 4
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
16b. the quality recipe's train step: flow matching in bf16 (the flow
    config under ``mixed_precision: bf16``, AdamW past the warm-up) through
    ``build_denoise_trainer`` at batch 2, on the card and on the CPU plain
    path, each held against the same step in f32 on the CPU with the same
    noise and t: the loss, the whole gradient and the whole AdamW update,
    each as one vector relative to the f32 one's norm; the card's distance
    at most twice the CPU's on each; the same step on the card with a
    flow target planted without its ``(1 - t)`` factor must fail that check;
    launches per step;
17. 2 timed train steps at the config's batch 8 (ms per step, images/s,
    peak memory, launches per step) and one flow-matching step of
    ``configs/LDCT/LDCT_flow_matching_diffusers_nd.json`` in its own f32;
18. the first 2 DDPM steps of the config's schedule through
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
    at batch 4, 2 inference steps, under the config's DDPM and seven
    scheduler overrides, a partial decode from ``start_step`` 700 with
    ``init_from_reference``, and a flow-matching run dir: model calls, K1
    and K2 launches per call, denoise steps/s, peak memory; then two decodes
    of 3 model calls at batch 1 (DPM-SDE with injected noise, UniPC order 3
    with Karras sigmas), card against the CPU plain path, with PSNR and SSIM
    between them;
21. ``python -m fmdm_tpu_torch.run_model`` in subprocesses on [20]'s run
    dirs, their ``data_root`` pointed at a synthetic LDCT root (2 cases of 4
    slices at 256², HU; the tensor cache on): ``build_tensor_cache``,
    ``evaluate`` of the 8 slices at batch 4 with 4 steps under the config's
    DDPM and under UniPC (exit code, CSV rows, finite metrics, the
    throughput line, denoise steps/s, wall time), ``decode --save
    --start_step 700``, and on the flow run dir ``encode --save`` and
    ``debug_compare``; the same DDPM ``evaluate`` in this process (launches
    per model call, peak memory); then ``evaluate`` of one sample at batch 1
    with 2 DDPM calls on the card and on the CPU with the card's draws
    replayed: per-image MSE, the decoded batch and the saved predictions;
22. training from a config: ``python -m fmdm_tpu_torch.train`` in
    subprocesses over a synthetic LDCT root (a train split of 3 cases and a
    test split of 4, 6 slices of 256² each): the flagship DDPM config for 1
    epoch at its batch 8 (18 slices: a ragged, padded last batch; [35a]
    resumes the same config for a second under torchrun), the
    flow-matching config for 1 epoch, the KL-VAE config for 1 epoch at
    batch 4 with the validation split, and ``--debug_visual_only`` on the
    DDPM run: exit codes, ``metrics.csv``, checkpoints, visuals, and the
    loop's logged build seconds, samples/s, checkpoint seconds per write;
    then the DDPM and VAE loops for one epoch in this process: launches per
    train step, start-up trial, visual model call and validation call, peak
    memory, and each checkpoint read back against the weights it saved;
23. EfficientUNet (``unet_impl`` ``efficient_nd``) at full width, batch 1,
    f32, TF32 off: the forwards of ``configs/LDCT/LDCT_ddpm_compvis.json``
    (concatenate) and ``configs/LDCT/PixelAttention/LDCT_ddpm_attention.json``
    (cross-attention to a 4x32x32 latent) on the card against the CPU plain
    path; launches per forward (K1 64, 32 of them with FiLM; K2 1);
24. the compvis config's denoise train step through
    ``build_denoise_trainer`` at batch 1, card vs CPU (loss, every gradient,
    the FiLM projections' named, the update); 2 timed steps at its batch 8;
    its 50-step DPM++ sample in bf16 at the first ``--batches`` (steps/s,
    peak, launches);
25. DeepCache on the flagship: the splice at depths 1 and 3 against the full
    forward (f32, batch 1), bitwise, and the shallow forward's launches;
    interval 1 against the uncached engine over 5 bf16 steps, bitwise; 2
    steps under '2:1' in f32 at batch 1, card vs CPU; the 50-step DPM++ bf16
    sample at the first ``--batches`` exactly and under '3:1:adaptive',
    '3:1:uniform' and '5:1:adaptive': steps/s,
    launches per sample against the refresh mask (K1 64 per full and 10 per
    shallow step, K2 6 per full step), PSNR against the exact sample from
    the same noise;
26. the CLIs: ``python -m fmdm_tpu_torch.train`` on the compvis config over
    [22]'s root for 1 epoch, ``run_model --mode evaluate`` on its run dir
    (8 slices at batch 4, 4 steps), then with ``--deep_cache 3`` (a warning,
    and per-image metrics equal to the exact run); on [20]'s flagship run dir
    ``evaluate --deep_cache 3:1:adaptive`` and ``--deep_cache auto:0.5``
    (the resolved setting from the log);
26b. the 3D volume path of BASELINE configs[4] at ``scripts/bench_3d.py``'s
    widths (EfficientUNetND in 3-D, 64 channels x (1, 2, 4), two res blocks
    per level, FiLM, linear attention at ds 4, the middle block's softmax
    self-attention at 2048 tokens, 8 heads x 32; 8x128² volumes,
    concatenate conditioning; 42,017,537 parameters, every weight from
    ``--seed``): the forward (batch 1, f32, TF32 off) card vs CPU with its
    launches (K1 two per ResBlock, K3 once, no K2) and the middle
    attention's route ("flash", no call on ``sdpa_xla``); the first 2
    DPM++ steps through ``SamplingEngine``, card vs CPU; a DDPM train step
    at batch 1 card vs CPU as [16] holds it (K4 and K5 once each); the same
    card step under ``remat`` (K1 and K3 twice), its gradients within 1e-5
    of each tensor's largest of the step without it; K1 at the path's
    largest group (192 channels in 32 groups at 8x128²) with and without
    FiLM in f32 and bf16, each twice bitwise equal, its plan and ms against
    its bound; K3, K4 and K5 at the middle attention's bf16 shape in the
    timed step, twice bitwise equal, against their plain versions; then in
    bf16 2 timed train steps at batch 4 (ms, volumes/s, peak memory) and the
    50-step DPM++ sample at batch 8 (denoise steps/s, seconds per volume,
    peak memory);
26c. K1's backward kernels (K1B) over the calls recorded in [5], [26b] and
    [10], replayed as the train steps run them: the flagship's 64 at the
    quality recipe's batch 16 and the 3D path's 34 at batch 4 in bf16 with
    f32 weights, the VAE's 50 at batch 4 in f32, each call on inputs of its
    own, twice and bitwise equal; dx, dweight, dbias, dscale and dshift
    against the plain backward evaluated in f32 (f32 gradients within 1e-5
    of the largest magnitude, bf16 ones within one bf16 ulp of it rounded);
    the launches per variant; each step's kernel time against its bound (x
    and dy read, dx written) and the plain backward the train steps ran
    before; the split forced at the VAE's 2 MB group with FiLM; the host's
    cost per call;
27. the VQ-VAE at full width, f32, TF32 off: ``LDCT_vqvae.json`` (EMA
    codebook) and ``LDCT_vqvae_original.json`` (classic), each a reconstruct
    at batch 1 card against the CPU (at least 99.9% of the codes equal, a
    differing code's two distances within 1e-5, and with every code equal
    the output within the tolerance), its train step at batch 1 card
    against the CPU (loss, every gradient, the EMA buffers after it), 10
    timed steps at batch 4, and the nearest-code search's own time (a
    4096 x 16384 x 256 distance product and the argmin) against its bound;
    launches K1 50 per call, no K3; ``LDCT_magvit_vqvae.json`` builds and
    reconstructs once;
28. the KL-VAE's ``LDCT_autoencoder_kl_bce_focal.json`` and
    ``LDCT_fmboost_autoencoder_kl.json`` recipes, the perceptual loss on a
    surrogate VGG16 ``.npz`` drawn from ``--seed`` (``FMDM_VGG16_WEIGHTS``
    set for this phase only): the train step at batch 1 card against the
    CPU with the perceptual term non-zero, 2 timed steps at batch 4, the
    VGG's share of the step, launches K1, K3, K4, K5 per step;
29. ``run_model``'s VAE modes on [22]'s KL-VAE run dir: ``evaluate``,
    ``sample --save``, ``encode --save`` and ``debug_compare`` in
    subprocesses, ``decode`` on the latents ``encode`` wrote (a copy of the
    run dir over a LatentDataset root of them), ``evaluate`` in this process
    (K1 and K3 per model call, peak memory) and at batch 1 card against the
    CPU; the VQ-VAE (EMA) trained 1 epoch through ``python -m
    fmdm_tpu_torch.train`` on [22]'s root, its codebook's EMA buffers read
    back bitwise, and its run dir evaluated;
30. the latent chain: a run dir of the flagship config's UNet at the
    latent's shape (4 channels at 32², concatenate conditioning, weights
    from ``--seed``) over [29]'s latents times 1/std, ``evaluate
    --latent_vae '<[22]'s KL-VAE>?scale=S'`` in this process (K1 and K2 per
    UNet call, K1 and K3 per VAE decode of samples and targets), and at
    batch 1 card against the CPU with the card's draws replayed;
31. the GAN step of ``configs/ldm_autoencoder_kl.json`` with ``gan_start`` 0
    (3 channels at 256², the perceptual loss on a surrogate VGG16 from
    ``--seed``): the leak check (D's gradients in the step are those of D's
    loss alone, and a leaked ``gan_weight * g_gan`` would be far larger),
    one step at batch 1 card against the CPU (the losses ``g_gan``,
    ``d_gan``, recon, perceptual and kl, both models' gradients and their
    parameters after AdamW), a step with the gate off leaving D as it was,
    2 timed steps at batch 4 with the gate on and off (launches K1, K3, K4,
    K5 per step), ``python -m fmdm_tpu_torch.train`` for 1 epoch over
    [22]'s root (3-slice windows as the channels) and ``--resume`` for a
    second (D's parameters and AdamW in the checkpoint, its step
    continuing), and one ``LDCT_magvit_vqvae.json`` step with ``gan_weight``
    0.5;
32. int8 inference of the flagship from [20]'s run dir: calibration at batch
    1 on the card and on the CPU (the same quantized paths and int8
    weights, the activation scales), the int8 forward card vs CPU on the
    card's scales, one conv's int32 accumulators for the same int8 operands
    bitwise, 2-step DPM++ decodes at batch 4 under ``int8`` and
    ``int8+linear`` against the float decode (PSNR, K1 and K2 per model
    call), ``linear_qdq`` at (2, 1024, 512) card vs CPU, ``run_model
    evaluate --quantize int8`` on [21]'s root alone and with ``--deep_cache
    3:1:adaptive``, and the int8 forward's time at batch 4 beside bf16
    and f32, its convs split into quantize, im2col, ``_int_mm`` and
    dequantize;
33. ``ResBlockND(norm_type="rmsnorm")`` with FiLM at 256 channels, 256²,
    batch 4, card vs CPU;
34. the checkpoint backends on the flagship's train state after [17] (its
    weights, AdamW's moments, an EMA of the weights: 1.82 GB): each of
    ``torch``, ``torch_async``, ``orbax`` (``torch.distributed.checkpoint``)
    and ``orbax_async`` saved and read back, every tensor bitwise equal to
    the state at the save; under the async backends, 5 train steps that
    change every tensor in place while the write is pending, the file still
    holding the state at the call; the save's seconds and GB/s, the async
    stall and the copies' device time, the flush, the steps beside a
    pending write against 5 without, the DCP directory's size against the
    file's (the training-CLI run under ``orbax_async`` is [35a]'s);
35. data parallelism: (a) ``python -m torch.distributed.run
    --nproc_per_node 1`` (NCCL) training the flagship DDPM config over
    [22]'s root under ``orbax_async`` for 1 epoch, its loss equal to [22]'s
    run without torchrun, then ``--resume`` for a second (the optimizer's
    step and the rate continue, from a DCP directory), and ``run_model
    evaluate`` of that run dir in this process with data-parallel sampling
    on (one card: one shard) and with ``--no_dp_sampling``, equal per-image
    metrics; (b) two gloo ranks on the one card (this process rank 0, a
    child ``chip_smoke.py --dp-rank 1``): the flagship's train step at 2
    rows per rank with valid counts 2 and 1, the KL-VAE's GAN step
    (BatchNorm over the global batch, K3-K5) and the VQ-VAE's EMA step at 1
    row per rank, each against one process on the global batch of a copy
    of the same weights (f32, TF32 off; the parameters within 1e-5 of each
    tensor's largest plus what AdamW's first step makes of the gradients'
    difference, the gradients within 1e-5 of the largest, the GAN step's as
    [31] holds it against the CPU and its losses within 1e-5, the EMA
    codebook within 1e-5), the steps' seconds and launches, and the GAN
    step once more with per-rank BatchNorm statistics, a planted fault that
    tolerance must catch; (c) ``SamplingEngine`` over two shards of the card
    (a 3-step DPM++ bf16 sample at batch 4 against each shard's rows
    sampled alone) and the VAE engines' ``_make_dp_fn`` (a reconstruct at
    batch 3, edge-padded to 4, against batch 3 unsplit), their launches;
36. the rest of parallelism: (a) the flash ring in one process over two
    shards of the card at [10]'s mid-attention shape (4, 4, 1024, 64) f32:
    the forward's out and lse and the backward's dq, dk, dv against the
    unsharded K3 and K4 + K5 and against the plain versions, K3 once per
    forward hop and K4 and K5 once each per backward hop of each shard, the
    per-chunk entry points alone against their plain versions in f32 and
    bf16, the einsum ring once, the per-hop kernel times and the ring's
    against the unsharded call; (b) two gloo ranks on the one card (a child
    ``chip_smoke.py --par-rank 1``): the KL-VAE's train step under
    ``sequence_parallel: 2`` (the mid attention's all-to-all and flash
    ring), the flagship's under ``fsdp`` and under ``tensor_parallel: 2``,
    each against one process on the global batch at [35b]'s tolerances,
    with each rank's bytes of parameters and optimizer state; (c) the VAE
    engine's reconstruct and a 3-step sample over a one-process
    ``("data", "seq")`` mesh of two shards of the card against the unsplit
    engines;
37. the quality workflow (``fmdm_tpu_torch/scripts/``) on the card at the
    flagship's width: ``python -m fmdm_tpu_torch.scripts.flagship_quality_sweep``
    in a subprocess over a phantom set of 2 train and 1 test case of 4
    slices, both variants trained 1 epoch through the training CLI and
    ``flowmatch`` and ``ddpm`` evaluated at 4 steps on 4 samples, two
    subprocesses at a time (``--jobs 2``); then, on
    its flow run dir at 4 steps, ``int8_quality_eval.evaluate`` with
    ``("flowmatch", "int8", None)`` and ``deepcache_quality_frontier`` under
    ``2:1:adaptive``, side by side; every row of each table a finite PSNR
    and SSIM with its 95% CI;
38. the whole run's seconds, a ``{"kernels": [...]}`` line, then the result
    line ``{"ok": true, "device": {...}}``.

The flagship is ``model.unet`` of ``configs/LDCT/LDCT_ddpm_diffusers_nd.json``
with concatenate conditioning and random weights drawn from ``--seed`` (in
the train step every weight, the zero-initialized ones too); EfficientUNet
has every weight drawn from ``--seed``, its zero-initialized output conv
too; the
VAE is ``configs/LDCT/LDCT_autoencoder_kl.json`` at its published widths with
every weight drawn from ``--seed`` (the zero-initialized projections too, so
every gradient path carries signal). Any failed check raises, and the script
then exits non-zero without a result line; so does a machine without a CUDA
device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import csv
import functools
import json
import math
import subprocess
import sys
import tempfile
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
    "train step": {"K1": 50, "K3": 2, "K4": 2, "K5": 2},  # K1B: one backward per K1 call
}
# the flagship's denoise train step (and each DDPM step): the forward's
# kernels (K1's backward counted apart, by K1B; K2's is the autograd of its
# plain version)
DENOISE_LAUNCHES = {"K1": K1_PER_FORWARD, "K2": K2_PER_FORWARD}
# the attention-conditioned flagship: its mid block cross-attends (sdpa_xla)
# instead of self-attending, so K2 serves the other five calls
CROSS_ATTENTION_LAUNCHES = {"K1": K1_PER_FORWARD, "K2": K2_PER_FORWARD - 1}
DDPM_STEPS = 2       # card vs CPU (cut from 3 for [16b])
# [26c]: the quality recipe's batch (scripts/flagship_quality_sweep.py), at
# which K1's backward is replayed
FLOW_TRAIN_BATCH = 16
FLOW_BF16_BATCH = 2  # [16b]: the bf16 flow step, card and CPU against the CPU's f32 step
FLOW_BF16_RATIO = 2.0  # [16b]: the card's distance to f32 at most this times the CPU's
DDPM_BF16_STEPS = 5  # at the config's batch
REL_TOL = 1e-3  # card vs CPU plain path: conv algorithms and sum orders differ
# sdpa at shapes no kernel takes (q shape, Tk, dtype, what)
SDPA_PLAIN_CASES = (
    ((1, 64, 64, 8), 1024, "float32", "cross-attention, 8² to a 32² latent"),
    ((2, 8, 256, 64), 77, "bfloat16", "cross-attention to 77 tokens"),
    ((2, 4, 256, 96), 256, "float32", "self-attention, d = 96 at T = 256"),
    ((1, 2, 1024, 160), 1024, "float32", "self-attention, d = 160 at T = 1024"),
)
TRAIN_STEPS = 2   # cut from 10 to make room for [31]-[33], from 5 for [37], from 3 for [16b]
DECODE_BATCH = 4     # run_model's default --batch_size
SCHEDULER_STEPS = 25  # [19]: a whole schedule per scheduler
# [20]: inference steps per decode, cut from 25 (and from 8 to make room for
# [21], from 4 for [31]-[33], from 3 for [16b]; [19] holds the schedulers'
# higher orders over 25 steps): at batch 4 in f32 a flagship forward
# takes 0.6-1.1 s on the H100, where cuDNN runs one convolution as an
# FFT-tiled GEMM of 66,048 launches (python -m fmdm_tpu_torch.sample.decode_report)
DECODE_STEPS = 2
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
# [21]: run_model's CLI over a synthetic LDCT data root of CLI_CASES paired
# 256² volumes of CLI_SLICES slices; evaluate takes them all at run_model's
# default batch in CLI_STEPS inference steps
CLI_CASES, CLI_SLICES = 2, 4
CLI_STEPS = 4
CLI_PARITY_STEPS = 2   # card vs CPU: evaluate of one sample at batch 1, the config's DDPM (3 until [16b])
SERVE_CALLS = 3   # cut from 5 for [16b]
# [22]: training from a config over a synthetic LDCT root. Cuts: 1 + 1
# epochs of the DDPM config and 1 of the flow config (the configs say 500),
# 2 of the VAE config (100); a train split of TRAIN_CASES[0] cases and a test
# split of TRAIN_CASES[1] cases of TRAIN_SLICES slices (tens of slices, not
# thousands); the visuals' inference steps (the configs say 1000); the VAE's
# visual_samples (20 in the config, a 4x5 grid needing 20 test cases)
TRAIN_CASES, TRAIN_SLICES = (3, 4), 6
TRAIN_EPOCHS = {"ddpm": 1, "flow": 1, "vae": 1}   # the VAE's cut from 2 for [31]-[33]
TRAIN_VISUAL_STEPS = 4
VAE_VISUAL_SAMPLES = 4
# [22]: launches per call of the in-process loops; a VAE epoch's visuals
# reconstruct and decode once (the decoder's K1 and K3 again)
VAE_VISUAL_LAUNCHES = {"K1": VAE_LAUNCHES["reconstruct"]["K1"] + VAE_LAUNCHES["decode"]["K1"],
                       "K3": VAE_LAUNCHES["reconstruct"]["K3"] + VAE_LAUNCHES["decode"]["K3"]}
# [23]-[26]: EfficientUNet (the efficient_nd configs) at full width; its
# parameters per config, and its launches per forward: K1 at every
# ResBlock's two GroupNorm+SiLU (32 ResBlocks, norm2 with FiLM), K2 at the
# middle block's softmax self-attention at 8²; its linear attentions and
# cross-attentions, and the head's GroupNorm, launch no kernel
EFFICIENT_CONFIGS = {
    REPO_ROOT / "configs" / "LDCT" / "LDCT_ddpm_compvis.json": 115_641_217,
    REPO_ROOT / "configs" / "LDCT" / "PixelAttention" / "LDCT_ddpm_attention.json": 117_239_089,
}
EFFICIENT_CONFIG = next(iter(EFFICIENT_CONFIGS))
EFFICIENT_LAUNCHES = {"K1": 64, "K2": 1}
EFFICIENT_FILM = 32   # of the 64 K1 calls
# [26b]: the 3D volume path of BASELINE configs[4] at scripts/bench_3d.py's
# widths (its UNET_3D and SHAPE_SP, copied): windows of 8 slices of 128²
# as one-channel volumes, concatenate conditioning. Its middle block's
# softmax self-attention runs at (2, 32, 32) = 2048 tokens, 8 heads x 32,
# on K3 (K4 and K5 in training); its linear attentions at ds 4 and the
# attentions' own GroupNorms launch no kernel; K1 runs every ResBlock's two
# GroupNorm+SiLU (norm2 with FiLM)
UNET_3D = {"unet_impl": "efficient_nd", "spatial_dims": 3, "in_channels": 1, "out_channels": 1,
           "model_channels": 64, "num_res_blocks": 2, "channel_mult": [1, 2, 4],
           "attention_resolutions": [4], "num_heads": 8, "dim_head": 32,
           "use_scale_shift_norm": True}
SHAPE_SP = (8, 128, 128)
VOLUME_PARAMS = 42_017_537
# scripts/bench_3d.py's training: DDPM over 1000 steps, AdamW at 1e-4 with
# 100 warm-up steps and no weight decay, bf16 at batch 4; its sample: 50
# DPM++ steps in bf16 at batch 8
VOLUME_TRAINING = {"train_batch_size": 4, "learning_rate": 1e-4, "weight_decay": 0.0,
                   "lr_warmup_steps": 100, "num_epochs": 1, "conditioning": "concatenate",
                   "channels": 1, "scheduler": "ddpm", "num_train_timesteps": 1000}
VOLUME_SAMPLE_BATCH = 8
VOLUME_DPM_STEPS = 2     # card vs CPU: the second is DPM++'s second-order update
VOLUME_REMAT_TOL = 1e-5  # remat against not, per tensor over its largest gradient
# [25]: DeepCache on the flagship. A shallow forward at depth D runs
# conv_in, down blocks 0..D-1 (2 ResBlocks each) and up blocks 6-D..5 (3
# ResBlocks each, no attention): K1 10 at depth 1, 30 at depth 3, no K2
SHALLOW_K1 = {1: 10, 3: 30}
DEEP_CACHE_STEPS = 5          # interval 1 vs the uncached engine, bf16
DEEP_CACHE_PARITY_STEPS = 2   # '2:1' (a full step, then a shallow one), card vs CPU, f32 (3 until [16b])
# the cached samples' settings, at the first --batches only (a cut of depth
# for the script's time, which the 3D phase [26b] needed; [7] samples the
# later batches exactly)
DEEP_CACHE_SETTINGS = ((3, 1, "adaptive"), (3, 1, "uniform"), (5, 1, "adaptive"))
# [27]-[30]: the rest of the VAE family. The VQ-VAE configs have the
# KL-VAE's stages and ResBlocks and no attention: K1 50 per reconstruct and
# per train step's forward, no K3
VQ_CONFIGS = {"ema": REPO_ROOT / "configs" / "LDCT" / "LDCT_vqvae.json",
              "classic": REPO_ROOT / "configs" / "LDCT" / "LDCT_vqvae_original.json"}
MAGVIT_CONFIG = REPO_ROOT / "configs" / "LDCT" / "LDCT_magvit_vqvae.json"
VQ_LAUNCHES = {"reconstruct": {"K1": 50}, "train step": {"K1": 50}}
# card vs CPU codes: a card GEMM may turn a near tie the other way
CODE_AGREEMENT = 0.999
NEAR_TIE_REL = 1e-5
LOSS_CONFIGS = (REPO_ROOT / "configs" / "LDCT" / "LDCT_autoencoder_kl_bce_focal.json",
                REPO_ROOT / "configs" / "LDCT" / "LDCT_fmboost_autoencoder_kl.json")
# the perceptual step's gradients, card vs CPU: its L1 over 0.4-3.2 million
# VGG features per image has a kink wherever r = t, and the two sides'
# roundings flip sign(r - t) at a few elements near it; each flip moves a
# gradient by about 1/sqrt(elements) of its size (its count is logged)
PERCEPTUAL_GRAD_TOL = 1e-2
VAE_CLI_SAMPLES = 8   # [29]: of [22]'s 24 test slices
# [31]: the GAN step. configs/ldm_autoencoder_kl.json is the KL-VAE's
# topology at 3 channels: its train step launches what the KL-VAE's does
# (the discriminator and the VGG launch no kernel). The CLI takes windows of
# GAN_SLICE_COUNT consecutive slices of [22]'s root as the 3 channels.
GAN_CONFIG = REPO_ROOT / "configs" / "ldm_autoencoder_kl.json"
GAN_LAUNCHES = VAE_LAUNCHES["train step"]
GAN_SLICE_COUNT = 3
# [32]: int8 inference of the flagship. INT8_STEPS DPM++ steps per decode;
# an int8 decode at least INT8_FLOOR_DB from the float one, and the
# card's int8 forward from the CPU's on the same scales; the forward timed
# at INT8_TIMED_BATCHES; int8 tensor-core peak of the data sheet (dense)
INT8_STEPS = 2   # cut from 3 for [16b]
INT8_FLOOR_DB = 20.0
INT8_TIMED_BATCHES = (4,)   # batch 8 cut for [37]
INT8_OPS_PER_S = 1979e12
# [33]: the rmsnorm ResBlock's (batch, channels, side)
RMSNORM_SHAPE = (4, 256, 256)
K2_X8_DRAWS = 4   # further draws of K2's bf16 case at logits x8
K3_F32_DRAWS = 3  # further draws of each f32 K3 case


# (phase label, host clock) at each phase's header line, for the seconds per phase
PHASE_STARTS = []


def log(msg: str = "") -> None:
    if msg.startswith("[") and "]" in msg[:6]:
        PHASE_STARTS.append((msg[:msg.index("]") + 1], time.perf_counter()))
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
    unaligned), weight, bias, and FiLM's scale and shift or None, on the
    card, drawn from ``gen`` on its device."""
    n, c = shape[:2]

    def randn(*size):
        return torch.randn(size, generator=gen, device=gen.device)

    x = randn(offset + math.prod(shape)).to("cuda", dtype)[offset:].view(shape)
    w = (1 + 0.1 * randn(c)).to("cuda", w_dtype or dtype)
    b = (0.1 * randn(c)).to("cuda", w_dtype or dtype)
    s = (0.2 * randn(n, c)).to("cuda", dtype) if film else None
    t = (0.2 * randn(n, c)).to("cuda", dtype) if film else None
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
              # the VQ-VAE's first stage: 32 channels in 32 groups, one
              # channel (256 KB in f32) per group
              ((4, 32, 256, 256), True, False, None, 0, False, own_gen),
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


# K1B: f32 gradients within this share of each one's largest magnitude of
# the plain backward evaluated in f32; bf16 ones within one bf16 ulp of it
# rounded (or this share, near zero)
K1B_F32_TOL = 1e-5
K1B_GRADS = ("dx", "dweight", "dbias", "dscale", "dshift")


def k1b_check(torch, what: str, got, truth) -> float:
    """Each gradient of one K1B call against ``truth``, the plain backward
    evaluated in f32; raises on the first outside K1B's tolerance. Returns
    dx's largest absolute error."""
    for name, g, want in zip(K1B_GRADS, got, truth):
        if want is None:
            if g is not None:
                raise AssertionError(f"K1B {what}: {name} without FiLM")
            continue
        scale = float(want.abs().max())
        if g.dtype == torch.float32:
            ok = max_err(g, want) <= K1B_F32_TOL * scale
        else:
            ref = want.to(g.dtype).float()
            ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
            ok = bool(((g.float() - ref).abs() <= ulp.clamp_min(K1B_F32_TOL * scale)).all())
        if not ok:
            raise AssertionError(f"K1B {what}: {name} disagrees with the plain backward in f32 "
                                 f"(max_abs_err {max_err(g, want)}, largest {scale})")
    return max_err(got[0], truth[0])


def k1b_path(torch, card: str, gen, what: str, calls, batch: int, dtype) -> dict:
    """K1's backward over one step's recorded K1 calls at ``batch``, x and dy
    in ``dtype``, the weights in f32, each call on inputs of its own: each
    call twice (bitwise equal) against the plain backward in f32, the
    launches per variant, the step's kernel time against its bound and the
    plain backward in the inputs' dtype (what the train steps ran before)."""
    from fmdm_tpu_torch.ops.kernels.group_norm import (
        K1B, _launch_backward, group_norm_act_backward_reference)

    def f32(t):
        return None if t is None else t.float()

    inputs = []
    for shape, groups, eps, act, film in calls:
        x, w, b, s, t = k1_inputs(torch, gen, (batch,) + shape, dtype, torch.float32, film)
        dy = torch.randn(x.shape, generator=gen, device=gen.device).to(dtype)
        inputs.append((dy, (x, w, b, s, t, groups, eps, act)))
    worst = 0.0
    K1B.reset()
    for dy, args in inputs:
        got = _launch_backward(dy, *args)
        again = _launch_backward(dy, *args)
        if not all(torch.equal(g, a) for g, a in zip(got, again) if g is not None):
            raise AssertionError(f"K1B {tuple(args[0].shape)} {dtype}: two calls differ")
        truth = group_norm_act_backward_reference(f32(dy), *map(f32, args[:5]), *args[5:])
        worst = max(worst, k1b_check(torch, f"{what} {tuple(args[0].shape)}", got, truth))
        del got, again, truth
    torch.cuda.synchronize()
    if K1B.launches != 2 * len(calls):
        raise AssertionError(f"{what}: {K1B.launches} K1B launches for {len(calls)} calls twice")
    variants = {k: v // 2 for k, v in K1B.variants.items()}

    def kernel_pass():
        for dy, args in inputs:
            _launch_backward(dy, *args)

    def plain_pass():
        for dy, args in inputs:
            group_norm_act_backward_reference(dy, *args)

    ms = time_ms(kernel_pass, iters=5, warmup=1)
    plain = time_ms(plain_pass, iters=2, warmup=1)
    bound, bound_by, term = bound_ms(sum(3 * a[0].numel() * a[0].element_size()
                                         for _, a in inputs))
    largest = max((a[0] for _, a in inputs), key=lambda x: x.numel())
    log(f"  {what}: {len(calls)} calls at batch {batch} {str(dtype)[6:]} (f32 weights, "
        f"{sum(c[4] for c in calls)} with FiLM), twice bitwise equal, within tolerance; dx "
        f"max_abs_err {worst:.3e}; kernels {ms:.4f} ms per step, bound {bound:.4f} ms "
        f"({bound / ms * 100:.1f}%), plain backward {plain:.4f} ms; launches by variant "
        f"{variants} [{card}]")
    del inputs
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by, bound_term=term,
                calls=len(calls), batch=batch, dtype=str(dtype)[6:], variants=variants,
                max_abs_err=worst, largest=list(largest.shape))


def phase_k1b(torch, card: str, seed: int, paths) -> dict:
    """[26c]: K1's backward over each (what, calls, batch, dtype) of
    ``paths``, the first the flagship's; the split forced at the VAE's 2 MB
    group with FiLM; the host's cost per call. Returns K1B's record for the
    kernels line, timed at the first path's step."""
    from fmdm_tpu_torch.ops.kernels.group_norm import (
        K1B, _launch_backward, backward_split_plan, group_norm_act_backward_reference,
        vector_aligned)

    log("[26c] K1B, K1's backward kernels, over the recorded calls of each train step, against "
        "the plain backward in f32, each call twice (bitwise equal)")
    gen = torch.Generator("cuda").manual_seed(seed + 27)
    per_step = {what: k1b_path(torch, card, gen, what, calls, batch, dtype)
                for what, calls, batch, dtype in paths}

    shape = (4, 256, 256, 256)
    x, w, b, s, t = k1_inputs(torch, gen, shape, torch.float32, film=True)
    dy = torch.randn(shape, generator=gen, device=gen.device)
    args = (x, w, b, s, t, 32, 1e-5, True)
    hw = math.prod(shape[2:])
    p = backward_split_plan(shape[1] // 32 * hw, hw, 4, vector_aligned(x, torch.empty_like(x)),
                            shape[0] * 32,
                            sm_count=torch.cuda.get_device_properties(0).multi_processor_count)
    K1B.reset()
    got = _launch_backward(dy, *args, p=p)
    again = _launch_backward(dy, *args, p=p)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"K1B split {shape}: two calls differ")
    if K1B.variants != {"single_pass": 0, "split": 2}:
        raise AssertionError(f"K1B split forced: launches by variant {K1B.variants}")
    err = k1b_check(torch, f"split {shape}", got, group_norm_act_backward_reference(dy, *args))
    split_ms = time_ms(lambda: _launch_backward(dy, *args, p=p), iters=5)
    del got, again, x, dy
    small = k1_inputs(torch, gen, (16, 512, 8, 8), torch.bfloat16, torch.float32)
    small_dy = torch.randn((16, 512, 8, 8), generator=gen, device=gen.device).to(torch.bfloat16)
    host = host_us(lambda: _launch_backward(small_dy, *small, 32, 1e-5, True))
    log(f"  split forced at {shape} f32 with FiLM ({p.ctas} blocks per group): twice bitwise "
        f"equal, within tolerance, dx max_abs_err {err:.3e}, {split_ms:.4f} ms; host "
        f"{host:.1f} us per call at (16, 512, 8, 8) bf16 [{card}]")
    torch.cuda.empty_cache()
    main = next(iter(per_step.values()))
    return dict(name=K1B.name, route="cuda", source=K1B.source, replaces=K1B.replaces,
                max_abs_err=max(r["max_abs_err"] for r in per_step.values()), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                bound_term=main["bound_term"], library_ms=None, shape=main["largest"],
                dtype=main["dtype"], per_step=per_step)


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
    """q, k, v, dout on the card, drawn from ``gen`` on its device."""
    kv_shape = q_shape[:-2] + (tk, q_shape[-1])
    return [torch.randn(s, generator=gen, device=gen.device).to("cuda", getattr(torch, dtype))
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


# the attention shapes of the MMDiT cell (SD3.5 Medium at 1024²: 4096 image
# tokens, joined by 333 text tokens in the joint attention; 24 heads x 64,
# batch 2), bf16
MMDIT_FLASH_SHAPES = ((2, 24, 4429, 64), (2, 24, 4096, 64))


def phase_mmdit_flash(torch, card: str, seed: int) -> None:
    """K3 and K4/K5 at the MMDiT's shapes against the plain versions, on
    inputs of a generator of their own (the later phases' draws are left as
    they were). Tolerance: bf16's of the other cases (one bf16 ulp of the
    output, 2^-7 relative, plus 2e-3); lse f32's."""
    from fmdm_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_reference, flash_backward, flash_backward_reference, flash_forward)

    log("[9b] K3 and K4/K5 at the MMDiT cell's shapes, bf16, vs the plain versions")
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    start = time.perf_counter()
    for shape in MMDIT_FLASH_SHAPES:
        q, k, v, dout = flash_inputs(torch, gen, shape, shape[2], "bfloat16")
        scale = shape[-1] ** -0.5
        out, lse = flash_forward(q, k, v, scale)
        grads = flash_backward(q, k, v, out, lse, dout, scale)
        torch.cuda.synchronize()
        what = f"q {shape} bfloat16"
        ref_out, ref_lse = flash_attention_reference(q, k, v, scale)
        check_close(f"K3 {what} out", out, ref_out, *TOL["bfloat16"])
        check_close(f"K3 {what} lse", lse, ref_lse, *TOL["float32"])
        del ref_out, ref_lse
        refs = flash_backward_reference(q, k, v, out, lse, dout, scale)
        for name, got, ref in zip(("K5 dq", "K4 dk", "K4 dv"), grads, refs):
            check_close(f"{name} {what}", got, ref, *TOL["bfloat16"])
        del refs, grads
        torch.cuda.empty_cache()
    log(f"  {time.perf_counter() - start:.1f} s [{card}]")


def random_weights(torch, model, gen) -> None:
    """Draw every parameter from ``gen``, in ``named_parameters`` order:
    U(±1/√fan_in) for conv and linear weights, 1±0.1 / ±0.1 for the affines
    of every GroupNorm module (EfficientUNet's head ``out.0`` too), U(±0.1)
    for other biases."""
    import math

    from fmdm_tpu_torch.nn.layers import GroupNorm

    with torch.no_grad():
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                if p.dim() >= 2:
                    bound = 1.0 / math.sqrt(math.prod(p.shape[1:]))
                    draw = torch.empty(p.shape).uniform_(-bound, bound, generator=gen)
                elif isinstance(module, GroupNorm):
                    draw = (1.0 if name == "weight" else 0.0) + 0.1 * torch.randn(
                        p.shape, generator=gen)
                else:
                    draw = torch.empty(p.shape).uniform_(-0.1, 0.1, generator=gen)
                p.copy_(draw)


def read_counts(records) -> dict:
    """Launches of ``records`` by kernel, and K1's backward's as "K1B"."""
    from fmdm_tpu_torch.ops.kernels.group_norm import K1B

    return {**{r.name.split()[0]: r.launches for r in records}, "K1B": K1B.launches}


def expect_counts(what: str, counts: dict, want: dict, calls: int = 1) -> None:
    # K1B is held only where ``want`` names it: k1_backward holds it in the
    # train phases
    got = {k: v / calls for k, v in counts.items() if k in want or (v and k != "K1B")}
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
    log(f"  {k1_backward('the VAE train step', VAE_LAUNCHES['train step']['K1'])}")
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
    backward = k1_backward("a timed VAE train step", VAE_LAUNCHES["train step"]["K1"], TRAIN_STEPS)
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError("the timed VAE train steps gave a non-finite loss")
    log(f"  batch {batch}, {TRAIN_STEPS} steps: {step_s * 1e3:.2f} ms per step, "
        f"{batch / step_s:.2f} images/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches per step {({k: v // TRAIN_STEPS for k, v in train_counts.items() if v})}, "
        f"{backward}, last loss {float(metrics['loss']):.6f} [{card}]")

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
    from fmdm_tpu_torch.ops.kernels.group_norm import K1B

    for r in records:
        r.reset()
    K1B.reset()


def k1_backward(what: str, k1_calls: int, steps: int = 1) -> str:
    """K1's backward launches since the last reset_counts: one per K1 call
    that ran under autograd, ``k1_calls`` per step; returns them for the
    phase's line."""
    from fmdm_tpu_torch.ops.kernels.group_norm import K1B

    if K1B.launches != k1_calls * steps:
        raise AssertionError(f"{what}: {K1B.launches} K1 backward launches in {steps} steps, "
                             f"expected {k1_calls} per step")
    return f"K1B {K1B.launches // steps} per step ({K1B.variants})"


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


def train_batch(torch, gen, batch: int, device: str, spatial=(256, 256)) -> dict:
    """A synthetic batch of 256² slices (or ``spatial`` volumes) in [-1, 1]
    (targets and conditioning)."""
    shape = (batch, 1) + tuple(spatial)
    return {"target": (torch.rand(shape, generator=gen) * 2 - 1).to(device),
            "image": (torch.rand(shape, generator=gen) * 2 - 1).to(device),
            "valid": torch.ones(batch, device=device)}


def train_step_parity(torch, card: str, cfg: dict, seed: int, gen, records, launches: dict,
                      spatial=(256, 256)):
    """One denoise train step (DDPM, AdamW at the cosine-warmup rate, past the
    warmup) through ``build_denoise_trainer``, f32, TF32 off, every weight
    from ``seed``, at batch 1 of ``spatial`` samples on the card against the
    CPU plain path with the same noise and t: the loss, every gradient, the
    card's update against AdamW replayed on the CPU, the launches. Returns
    the card's model, scheduler and step, the CPU model (gradients kept) and
    the step's (batch, noise, t) on the CPU."""
    from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    data = train_batch(torch, gen, 1, "cpu", spatial)
    noise = torch.randn((1, 1) + tuple(spatial), generator=gen)
    t = torch.randint(0, scheduler.num_train_timesteps, (1,), generator=gen)
    before = [p.detach().cpu().clone() for p in model.parameters()]
    reset_counts(records)
    loss_gpu, _ = step.step({k: v.cuda() for k, v in data.items()}, noise=noise.cuda(), t=t.cuda())
    torch.cuda.synchronize()
    expect_counts("the train step", read_counts(records), launches)
    log(f"  {k1_backward('the train step', launches['K1'])}")
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
        f"(largest move {moved:.3e}); launches per step {launches}; CPU step "
        f"{cpu_s:.2f} s [{card}]")
    if not (loss_rel <= REL_TOL and worst_grad <= REL_TOL and update_err <= 1e-6 and moved > 0):
        raise AssertionError(f"card train step disagrees with the CPU plain path (loss {loss_rel}, "
                             f"gradient {worst_grad} at {worst_name}, update {update_err})")
    return model, scheduler, step, cpu_model, (data, noise, t)


def vector_distance(got, ref) -> float:
    """||got - ref|| / ||ref|| of two lists of f32 tensors, each taken as one
    vector (each tensor's sum of squares in f32, their total in Python)."""
    num = sum(float((g - r).square().sum()) for g, r in zip(got, ref))
    return math.sqrt(num / sum(float(r.square().sum()) for r in ref))


def flow_bf16_parity(torch, card: str, cfg: dict, seed: int, cpu_model, records):
    """[16b]: the bf16 flow-matching train step of ``cfg`` (the quality
    recipe) through ``build_denoise_trainer``, every weight from ``seed``,
    past the warm-up, at batch FLOW_BF16_BATCH: on the card and on the CPU
    plain path (``cpu_model``, the same UNet, weights loaded), each against
    the same step in f32 on the CPU, with the same noise and t. Both bf16
    steps round; neither is the other's yardstick, so each is measured
    against f32, by its loss, its whole gradient and its whole update, and
    the card's distance may be at most FLOW_BF16_RATIO times the CPU's. The
    same card step on a flow target planted without its (1 - t) factor must
    fail that check. The CPU's two steps run side by side in two threads,
    the f32 one on a copy of ``cpu_model``. Returns the card's model,
    scheduler and step."""
    from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step
    from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer

    training = cfg["training"]
    warmup = int(training["lr_warmup_steps"])
    model, scheduler, step = build_denoise_trainer(
        cfg, variant="flow_matching", num_samples=int(training["train_batch_size"]),
        device="cuda")
    if step.compute_dtype != torch.bfloat16:
        raise AssertionError(f"the recipe's step computes in {step.compute_dtype}")
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    start = {name: p.detach().cpu().clone() for name, p in model.named_parameters()}
    cpu_steps = {}
    for what, dtype, module in (("CPU bf16", torch.bfloat16, cpu_model),
                                ("CPU f32", torch.float32, copy.deepcopy(cpu_model))):
        optimizer, _ = make_adamw(module.parameters(), float(training["learning_rate"]),
                                  float(training["weight_decay"]), warmup, 1)
        cpu_steps[what] = (dtype, make_denoise_train_step(
            module, scheduler, optimizer, step.lr_schedule, variant="flow_matching",
            conditioning_mode=step.conditioning_mode, latent_norm=step.latent_norm,
            compute_dtype=dtype, device="cpu"))
    gen = torch.Generator().manual_seed(seed + 16)   # the later phases' draws stay as they were
    batch = FLOW_BF16_BATCH
    data = train_batch(torch, gen, batch, "cpu")
    noise = torch.randn((batch, 1, 256, 256), generator=gen)
    t = torch.rand((batch,), generator=gen)

    def planted_chunk_loss(x0, cond, valid, noise, t):
        """``DenoiseTrainStep.chunk_loss`` of a concatenated flow step, with
        the noisy input planted without its (1 - t) factor."""
        tb = t.reshape((-1,) + (1,) * (x0.dim() - 1))
        noisy = x0 + tb * noise
        model_t = (t * (step.scheduler.num_train_timesteps - 1)).to(torch.int32)
        model_input = torch.cat([noisy, cond], dim=1).to(step.compute_dtype)
        pred = step.model(model_input, model_t).float()
        per_sample = torch.square(pred - (noise - x0)).mean(dim=tuple(range(1, x0.dim())))
        loss_sum = (per_sample * valid).sum()
        count = valid.sum()
        return loss_sum / torch.clamp(count, min=1.0), loss_sum, count

    def run(what, trainer, dtype, planted=False):
        """One step from ``start`` in ``dtype``: (loss, gradients, update)."""
        module, device = trainer.model, trainer.device
        module.load_state_dict(start, strict=False)
        trainer.optimizer.state.clear()
        trainer.compute_dtype, trainer.global_step = dtype, warmup
        if planted:
            trainer.chunk_loss = planted_chunk_loss
        if device.type == "cuda":
            reset_counts(records)
        begin = time.perf_counter()
        try:
            loss_sum, count = trainer.step({k: v.to(device) for k, v in data.items()},
                                           noise=noise.to(device), t=t.to(device))
            loss = float(loss_sum) / float(count)
        finally:
            trainer.__dict__.pop("chunk_loss", None)
        secs = time.perf_counter() - begin
        if device.type == "cuda":
            expect_counts(f"[16b] {what}", read_counts(records), DENOISE_LAUNCHES)
            log(f"  [16b] {what}: {k1_backward(what, DENOISE_LAUNCHES['K1'])}")
        grads = [p.grad.detach().cpu() for p in module.parameters()]
        update = [p.detach().cpu() - start[name] for name, p in module.named_parameters()]
        return {"loss": loss, "grads": grads, "update": update, "seconds": secs}

    lr = step.lr_schedule(warmup)
    card_runs = {"card bf16": run("card bf16", step, torch.bfloat16),
                 "card bf16, planted fault": run("planted", step, torch.bfloat16, planted=True)}
    begin = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cpu_runs = {what: pool.submit(run, what, trainer, dtype)
                    for what, (dtype, trainer) in cpu_steps.items()}
        cpu_runs = {what: f.result() for what, f in cpu_runs.items()}
    cpu_s = time.perf_counter() - begin
    runs = {"card bf16": card_runs["card bf16"], **cpu_runs,
            "card bf16, planted fault": card_runs["card bf16, planted fault"]}
    ref = runs["CPU f32"]
    dist = {what: {"loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                   "gradient": vector_distance(r["grads"], ref["grads"]),
                   "update": vector_distance(r["update"], ref["update"])}
            for what, r in runs.items() if what != "CPU f32"}

    def holds(d):
        return all(math.isfinite(d[k]) and d[k] <= FLOW_BF16_RATIO * dist["CPU bf16"][k] for k in d)

    log(f"  t = {[round(float(v), 4) for v in t]}, rate {lr:g}; mean loss: "
        + ", ".join(f"{what} {r['loss']:.6f} ({r['seconds']:.2f} s)" for what, r in runs.items())
        + f"; the CPU's two steps side by side in {cpu_s:.2f} s")
    for what, d in dist.items():
        log(f"  {what} vs CPU f32: loss {d['loss']:.3e}, gradient {d['gradient']:.3e}, update "
            f"{d['update']:.3e} (||x - f32|| / ||f32||); within {FLOW_BF16_RATIO:g}x the CPU's: "
            f"{holds(d)} [{card}]")
    log(f"  launches per card step {DENOISE_LAUNCHES}")
    if not holds(dist["CPU bf16"]):
        raise AssertionError(f"[16b] the CPU's bf16 step is not finite: {dist['CPU bf16']}")
    if not holds(dist["card bf16"]):
        raise AssertionError(f"[16b] the card's bf16 flow step is farther from f32 than "
                             f"{FLOW_BF16_RATIO:g}x the CPU's: {dist}")
    if holds(dist["card bf16, planted fault"]):
        raise AssertionError(f"[16b] the check passed a planted flow-target fault: {dist}")
    return model, scheduler, step


def timed_train_steps(torch, card: str, step, data: dict, noise_gen, records, launches: dict,
                      what: str) -> dict:
    """TRAIN_STEPS timed train steps after a warm-up: ms per step, images/s,
    peak memory; returns the launches of the timed steps."""
    batch = int(data["valid"].shape[0])
    step.step(data, generator=noise_gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(records)
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        loss_sum, count = step.step(data, generator=noise_gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - start) / TRAIN_STEPS
    counts = read_counts(records)
    expect_counts(f"a timed {what} train step", counts, launches, TRAIN_STEPS)
    backward = k1_backward(f"a timed {what} train step", launches["K1"], TRAIN_STEPS)
    if not (bool(torch.isfinite(loss_sum)) and float(count) == batch):
        raise AssertionError(f"the timed train steps gave loss {float(loss_sum)}, count {float(count)}")
    log(f"  batch {batch}, {TRAIN_STEPS} steps: {step_s * 1e3:.2f} ms per step, "
        f"{batch / step_s:.2f} images/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches per step {({k: v // TRAIN_STEPS for k, v in counts.items() if v})}, "
        f"{backward}, last mean loss {float(loss_sum) / batch:.6f} [{card}]")
    return counts


def phase_denoise(torch, card: str, seed: int, gen, records):
    """Phases [16]-[18]: the flagship's denoise train step and DDPM sampling;
    returns the launch counts of the timed train steps."""
    from fmdm_tpu_torch.sample.engine import SamplingEngine
    from fmdm_tpu_torch.schedulers import build_scheduler

    log("[16] flagship denoise train step (DDPM, AdamW at the cosine-warmup rate), f32, TF32 off: "
        "batch 1 card vs CPU plain path, same noise and t")
    cfg = json.loads(CONFIG.read_text())
    training = cfg["training"]
    batch = int(training["train_batch_size"])
    warmup = int(training["lr_warmup_steps"])
    model, scheduler, step, cpu_model, _ = train_step_parity(torch, card, cfg, seed, gen, records,
                                                             DENOISE_LAUNCHES)

    log(f"[16b] the quality recipe's flow-matching train step in bf16 (AdamW past the warm-up): "
        f"batch {FLOW_BF16_BATCH}, card bf16 and CPU bf16 each against the CPU f32 step, same "
        f"noise and t; the same card step on a planted flow-target fault")
    flow_cfg = json.loads(FLOW_CONFIG.read_text())
    # flagship_quality_sweep.write_config's recipe trains the flow flagship in bf16
    flow_cfg["training"]["mixed_precision"] = "bf16"
    _, flow_sched, flow_step = flow_bf16_parity(torch, card, flow_cfg, seed, cpu_model, records)

    log(f"[17] flagship denoise train step, {TRAIN_STEPS} timed steps at the config's batch "
        f"{batch}, f32, TF32 off; one flow-matching step")
    data = train_batch(torch, gen, batch, "cuda")
    noise_gen = torch.Generator("cuda").manual_seed(seed)
    train_counts = timed_train_steps(torch, card, step, data, noise_gen, records,
                                     DENOISE_LAUNCHES, "flagship")
    # [16b]'s trainer in the flow config's own f32 (mixed_precision "no")
    flow_step.compute_dtype = torch.float32
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
    return {"counts": train_counts, "model": model, "step": step, "data": data,
            "noise_gen": noise_gen}


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


def phase_decode(torch, card: str, seed: int, gen, records, work: Path) -> dict:
    """[20]: decode the flagship from a trained run dir under every scheduler;
    the run dirs stay under ``work`` (``ddpm``, ``flow``) for [21]. Returns
    the K1 and K2 launches of the timed decodes."""
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
    run_dir, flow_dir = work / "ddpm", work / "flow"
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


def write_ldct_root(root: Path, seed: int, cases=(CLI_CASES, CLI_CASES),
                    slices: int = CLI_SLICES) -> int:
    """A synthetic LDCT data root: paired volumes of ``slices`` 256² slices
    in HU (a body ellipse of soft tissue with a bone ring in air; the
    low-dose volume adds noise of 60 HU), headerless split files with case
    ids 001, 002, ... (``cases`` = (train, test) counts: both splits hold the
    same cases when they are equal, else the test cases follow the train
    cases), and a dataset.json naming the LDCT class with the config's HU
    window and the tensor cache on. Returns the number of test samples."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "vol").mkdir(parents=True)
    yy, xx = np.mgrid[-1:1:256j, -1:1:256j]
    lines = []
    shared = cases[0] == cases[1]
    for c in range(cases[0] if shared else sum(cases)):
        case = f"{c + 1:03d}"
        sdct = np.full((slices, 256, 256), -1000.0)
        for z in range(slices):
            a, b = 0.8 + 0.05 * rng.standard_normal(), 0.6 + 0.05 * rng.standard_normal()
            r = (xx / a) ** 2 + (yy / b) ** 2
            sdct[z][r < 1] = 40 + 20 * rng.standard_normal()
            sdct[z][(r > 0.55) & (r < 0.65)] = 700 + 100 * rng.standard_normal()
        sdct += rng.normal(0, 10, sdct.shape)
        ldct = sdct + rng.normal(0, 60, sdct.shape)
        np.save(root / "vol" / f"sdct_{case}.npy", sdct.astype(np.float32))
        np.save(root / "vol" / f"ldct_{case}.npy", ldct.astype(np.float32))
        lines.append(f"{case}\tvol/sdct_{case}.npy\tvol/ldct_{case}.npy")
    splits = {"train.txt": lines[:cases[0]], "test.txt": lines if shared else lines[cases[0]:]}
    for split, rows in splits.items():
        (root / split).write_text("\n".join(rows) + "\n")
    (root / "dataset.json").write_text(json.dumps({
        "dataset_class": "datasets.ldct:LDCTDataset",
        "preprocess_kwargs": {"MIN_B": -1024, "MAX_B": 3072, "slope": 1.0, "intersept": -1024},
        "save_tensor_cache": True}))
    return cases[1] * slices


def run_cli(card: str, run: Path, mode: str, *flags, process: bool = False):
    """``fmdm_tpu_torch.run_model``'s CLI on the card, with ``process`` in a
    subprocess (``python -m``), else through its ``main`` in this process
    (:func:`in_process`): its standard output followed by its log and its
    wall seconds; a non-zero exit or an error fails the run."""
    from fmdm_tpu_torch import run_model

    argv = ["--ckpt_dir", str(run), "--mode", mode, *map(str, flags)]
    if process:
        text, secs = in_subprocess("fmdm_tpu_torch.run_model", argv, f"run_model --mode {mode}")
    else:
        text, secs = in_process(run_model.main, argv)
    log(f"  CLI {mode} on {run.name} {' '.join(map(str, flags))}: "
        f"{'exit 0' if process else 'in process'}, wall {secs:.2f} s [{card}]")
    return text, secs


def in_subprocess(module: str, argv, what: str):
    """``python -m module argv`` on the card: its output then its log, and
    its wall seconds; a non-zero exit fails the run."""
    start = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - start
    if out.returncode != 0:
        log(out.stdout[-2000:])
        log(out.stderr[-6000:])
        raise AssertionError(f"python -m {module} ({what}) exited {out.returncode}")
    return out.stdout + out.stderr, secs


def in_process(main, argv):
    """A CLI's ``main(argv)`` in this process, as a new process would run it
    (PyTorch's default TF32 flags, the default checkpoint backend), with its
    standard output, standard error and log captured: (text, wall seconds).
    A cut of the subprocesses' start (7-8 s each on the card's host)."""
    import io
    import logging

    import torch

    from fmdm_tpu_torch.sample import diffusion_utils
    from fmdm_tpu_torch.utils import checkpoint as ckpt_utils

    buf = io.StringIO()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            main(list(argv))
    except BaseException:
        log(buf.getvalue()[-6000:])
        raise
    finally:
        root.handlers, root.level = saved[0], saved[1]
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[2:]
        # the settings a CLI leaves behind, back at a new process's
        ckpt_utils.set_checkpoint_backend("torch")
        diffusion_utils.set_deep_cache(None)
        diffusion_utils.set_quantize(None)
        diffusion_utils.set_use_ema(False)
        diffusion_utils.set_dp_sampling(True)
    return buf.getvalue(), time.perf_counter() - start


def read_csv_rows(path: Path) -> list:
    with path.open(newline="") as fh:
        return list(csv.DictReader(fh))


def check_evaluate(out_dir: Path, samples: int) -> dict:
    """The one experiment dir evaluate wrote under ``out_dir``: its summary
    row, after checking the per-image rows (one per sample, finite metrics)."""
    (exp,) = list(out_dir.iterdir())
    (row,) = read_csv_rows(exp / "eval_metrics.csv")
    per_image = read_csv_rows(exp / "eval_metrics_per_image.csv")
    metrics = [float(r[k]) for r in per_image for k in ("mse", "psnr", "ssim")]
    metrics += [float(row[k]) for k in ("mse", "psnr", "ssim", "model_seconds")]
    if len(per_image) != samples or int(row["samples"]) != samples or \
            not all(math.isfinite(v) for v in metrics):
        raise AssertionError(f"evaluate in {exp}: {len(per_image)} rows for {samples} samples, "
                             f"or metrics not finite: {row}")
    row["per_image"] = per_image
    row["dir"] = exp
    return row


def compare_saved(card_root: Path, cpu_root: Path) -> float:
    """The same files under both roots; tensors (.npy) within REL_TOL of the
    CPU's relative to its largest value, quantized images (PNG, DICOM)
    within one level. Returns the tensors' largest relative difference."""
    import numpy as np

    from fmdm_tpu_torch.data.io import load_image

    card = sorted(p.relative_to(card_root) for p in card_root.rglob("*") if p.is_file())
    cpu = sorted(p.relative_to(cpu_root) for p in cpu_root.rglob("*") if p.is_file())
    if card != cpu or not card:
        raise AssertionError(f"saved predictions differ in their files: {card} vs {cpu}")
    worst = 0.0
    for rel in card:
        a = np.asarray(load_image(card_root / rel)["Image"], np.float64)
        b = np.asarray(load_image(cpu_root / rel)["Image"], np.float64)
        if rel.suffix == ".npy":
            err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            worst = max(worst, err)
            ok = err <= REL_TOL
        else:
            ok = float(np.abs(a - b).max()) <= 1
        if a.shape != b.shape or not ok:
            raise AssertionError(f"saved prediction {rel} differs between the card and the CPU")
    return worst


def phase_run_model(torch, card: str, seed: int, records, work: Path) -> dict:
    """[21]: run_model's CLI on [20]'s run dirs over a synthetic LDCT data
    root; returns the K1 and K2 launches of the in-process runs."""
    from fmdm_tpu_torch import run_model
    from fmdm_tpu_torch.sample import diffusion_like, diffusion_utils
    from fmdm_tpu_torch.schedulers import build_scheduler

    runs = {"ddpm": work / "ddpm", "flow": work / "flow"}
    root = work / "ldct"
    samples = write_ldct_root(root, seed)
    log(f"[21] python -m fmdm_tpu_torch.run_model on [20]'s run dirs over a synthetic LDCT root "
        f"({CLI_CASES} cases x {CLI_SLICES} slices of 256², HU), batch {DECODE_BATCH}, "
        f"{CLI_STEPS} inference steps")
    for run in runs.values():
        cfg_path = run / "train_config.json"
        cfg = json.loads(cfg_path.read_text())
        cfg["training"]["data_root"] = str(root)
        cfg_path.write_text(json.dumps(cfg, indent=2))
    diffusion_utils._ENGINE_CACHE.clear()   # [20]'s engines hold their models on the card
    torch.cuda.empty_cache()

    run_cli(card, runs["ddpm"], "build_tensor_cache")
    cached = sorted((root / "cache_eval").rglob("*.pt"))
    log(f"  tensor cache: {len(cached)} files under {root.name}/cache_eval")
    if len(cached) != 2 * samples:
        raise AssertionError(f"build_tensor_cache wrote {len(cached)} files for {samples} samples")

    subset = ("--num_samples", samples, "--batch_size", DECODE_BATCH,
              "--num_inference_steps", CLI_STEPS)
    batches = -(-samples // DECODE_BATCH)
    cli = {}
    for label, extra in (("ddpm", ()), ("unipc", ("--scheduler", "unipc"))):
        out_dir = work / "cli" / f"evaluate_{label}"
        stdout, secs = run_cli(card, runs["ddpm"], "evaluate", *subset, "--output_dir", out_dir,
                               *extra, process=not extra)
        row = check_evaluate(out_dir, samples)
        calls, model_s = int(row["model_calls"]), float(row["model_seconds"])
        throughput = next(line for line in stdout.splitlines() if line.startswith("Model throughput"))
        log(f"  evaluate {label}: {throughput}; {samples * calls / batches / model_s:.2f} denoise "
            f"steps/s over {calls} model calls; MSE {row['mse']} PSNR {row['psnr']} SSIM "
            f"{row['ssim']}; CLI wall {secs:.2f} s [{card}]")
        cli[label] = secs
        if calls != batches * CLI_STEPS:
            raise AssertionError(f"evaluate {label}: {calls} model calls")

    out_dir = work / "cli" / "decode"
    run_cli(card, runs["ddpm"], "decode", "--save", "--start_step", 700, *subset,
            "--output_dir", out_dir)
    stems = {p.stem for p in (out_dir / "predicted").rglob("*") if p.is_file()}
    out_dir = work / "cli" / "encode"
    run_cli(card, runs["flow"], "encode", "--save", "--timestep", 500, *subset[:4],
            "--output_dir", out_dir)
    encoded = {p.stem for p in out_dir.rglob("*") if p.is_file()}
    log(f"  decode --save --start_step 700: {len(stems)} predictions; encode --save: "
        f"{len(encoded)} noised slices")
    if len(stems) != samples or len(encoded) != samples:
        raise AssertionError(f"decode saved {len(stems)} and encode {len(encoded)} of {samples}")
    out_dir = work / "cli" / "debug_compare"
    run_cli(card, runs["flow"], "debug_compare", "--num_inference_steps", CLI_STEPS,
            "--output_dir", out_dir)
    stats = json.loads((out_dir / "stats.json").read_text())
    probes = [stats[k] for k in ("generated_raw", "generated_raw_no_cond")]
    log(f"  debug_compare: {stats['timing']['model_calls']} model calls; generated "
        f"[{probes[0]['min']:.4f}, {probes[0]['max']:.4f}], no-cond probe "
        f"[{probes[1]['min']:.4f}, {probes[1]['max']:.4f}]")
    if stats["timing"]["model_calls"] != CLI_STEPS or not all(
            p["present"] and math.isfinite(p["min"]) and math.isfinite(p["max"]) for p in probes):
        raise AssertionError(f"debug_compare: {stats}")

    # the same evaluate in this process, under PyTorch's default TF32 flags
    # as in the CLI's process: launches per model call, peak memory, and the
    # wall split into the dataset's build (split file, volume windows), the
    # model's build and load, the decode calls (model time, the engine's
    # set-up) and the rest (sample reads, batch stacking and copies,
    # metrics, CSVs)
    torch.backends.cudnn.allow_tf32 = True
    spent = {"dataset": 0.0, "build": 0.0, "decode": 0.0}

    def timed(fn, key):
        def call(*args, **kw):
            start = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - start
            return out
        return call

    real = {k: getattr(diffusion_like, k) for k in
            ("build_sampling_dataset", "build_diffusion_model", "decode_diffusion_batch")}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(records)
    try:
        for (name, fn), key in zip(real.items(), spent):
            setattr(diffusion_like, name, timed(fn, key))
        start = time.perf_counter()
        run_model.main(["--ckpt_dir", str(runs["ddpm"]), "--mode", "evaluate", *map(str, subset),
                        "--output_dir", str(work / "inproc")])
        wall = time.perf_counter() - start
    finally:
        for name, fn in real.items():
            setattr(diffusion_like, name, fn)
    counts = read_counts(records)
    row = check_evaluate(work / "inproc", samples)
    calls, model_s = int(row["model_calls"]), float(row["model_seconds"])
    expect_counts("run_model evaluate", counts, DENOISE_LAUNCHES, calls)
    peak = torch.cuda.max_memory_allocated()
    host = wall - sum(spent.values())
    real_decode = real["decode_diffusion_batch"]
    log(f"  in process: evaluate {calls} model calls in {model_s:.4f} s, "
        f"{samples * calls / batches / model_s:.2f} denoise steps/s, wall {wall:.2f} s: dataset "
        f"{spent['dataset']:.2f} s, model build and load {spent['build']:.2f} s, decode calls {spent['decode']:.2f} s "
        f"({(spent['decode'] - model_s) / batches * 1e3:.1f} ms per batch outside the step "
        f"loop), the rest {host:.2f} s ({host / batches * 1e3:.1f} ms per batch of "
        f"{DECODE_BATCH}); launches K1 {counts['K1']} K2 {counts['K2']}; peak "
        f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} "
        f"held before) [{card}]")
    totals = {k: counts[k] for k in ("K1", "K2")}

    # card vs CPU: one sample at batch 1 with the card's draws replayed
    torch.backends.cudnn.allow_tf32 = False
    training = json.loads((runs["ddpm"] / "train_config.json").read_text())
    scheduler, _ = build_scheduler(training["model"]["scheduler"], training["training"])
    draws, outs = [], {}

    def record(*args, generator=None, **kw):
        shape, device = args[3], kw["device"]
        init = torch.randn(shape, generator=generator, device=device)
        steps = ([torch.randn(shape, generator=generator, device=device)
                  for _ in range(CLI_PARITY_STEPS)] if scheduler.needs_noise else None)
        draws.append((init.cpu(), None if steps is None else [s.cpu() for s in steps]))
        out = real_decode(*args, init_noise=init, step_noise=steps, **kw)
        outs["cuda"] = out.cpu()
        return out

    def replay(*args, generator=None, **kw):
        init, steps = draws.pop(0)
        out = real_decode(*args, init_noise=init, step_noise=steps, **kw)
        outs["cpu"] = out.cpu()
        return out

    parity = dict(ckpt_dir=runs["ddpm"], model_type="diffusion", num_samples=1, batch_size=1,
                  num_inference_steps=CLI_PARITY_STEPS, save=True, seed=seed)
    try:
        diffusion_like.decode_diffusion_batch = record
        reset_counts(records)
        diffusion_like._run_evaluate(device="cuda", output_dir=str(work / "parity_cuda"), **parity)
        counts = read_counts(records)
        expect_counts("run_model evaluate, batch 1", counts, DENOISE_LAUNCHES, CLI_PARITY_STEPS)
        totals = {k: totals[k] + counts[k] for k in totals}
        diffusion_like.decode_diffusion_batch = replay
        diffusion_like._run_evaluate(device="cpu", output_dir=str(work / "parity_cpu"), **parity)
    finally:
        diffusion_like.decode_diffusion_batch = real_decode
    card_row = check_evaluate(work / "parity_cuda", 1)
    cpu_row = check_evaluate(work / "parity_cpu", 1)
    mse = [float(r["per_image"][0]["mse"]) for r in (card_row, cpu_row)]
    mse_rel = abs(mse[0] - mse[1]) / max(abs(mse[1]), 1e-12)
    out_rel = rel_err(outs["cuda"], outs["cpu"])
    saved_rel = compare_saved(card_row["dir"] / "samples", cpu_row["dir"] / "samples")
    log(f"  card vs CPU, evaluate of sample {card_row['per_image'][0]['img_id']} at batch 1, "
        f"{CLI_PARITY_STEPS} DDPM calls, the card's draws replayed: per-image MSE {mse[0]:.8f} vs "
        f"{mse[1]:.8f} (rel {mse_rel:.3e}), decoded max|gpu-cpu|/max|cpu| {out_rel:.3e}, saved "
        f"tensors {saved_rel:.3e} (tolerance {REL_TOL:g})")
    if not (mse_rel <= REL_TOL and out_rel <= REL_TOL):
        raise AssertionError(f"run_model evaluate: card disagrees with the CPU (MSE rel {mse_rel}, "
                             f"output rel {out_rel})")
    return totals


def run_train_cli(card: str, what: str, *flags, process: bool = False):
    """``fmdm_tpu_torch.train``'s CLI on the card, with ``process`` in a
    subprocess, else through its ``main`` in this process: its log and wall
    seconds; a non-zero exit or an error fails the run."""
    from fmdm_tpu_torch.train import __main__ as train_main

    if process:
        return in_subprocess("fmdm_tpu_torch.train", list(map(str, flags)), what)
    return in_process(train_main.main, list(map(str, flags)))


def loop_log(text: str) -> dict:
    """What a training run logged: the model's build seconds, and per epoch
    the samples/s, steps and their seconds, the data wait, the validation,
    checkpoint and visual seconds and the optimizer's step."""
    import re

    build = re.search(r"Built the \S+ (?:model )?on \S+ in ([0-9.]+) s", text)
    rates = [float(m) for m in re.findall(r"Epoch \d+ \| loss [^|]*\| ([0-9.]+) samples/s", text)]
    timing = re.findall(
        r"Epoch (\d+) timing \| (\d+) steps in ([0-9.]+) s \(([0-9.]+) s waiting for data\) \| "
        r"(?:validation ([0-9.]+) s \| )?checkpoint ([0-9.]+) s \| visuals ([0-9.]+) s \| "
        r"optimizer step (\d+)", text)
    epochs = [{"epoch": int(e), "steps": int(n), "steps_s": float(t), "data_wait_s": float(w),
               "validation_s": float(v or 0.0), "checkpoint_s": float(c), "visuals_s": float(vi),
               "optimizer_step": int(k), "samples_per_s": rate}
              for (e, n, t, w, v, c, vi, k), rate in zip(timing, rates)]
    if build is None or not epochs or len(rates) != len(timing):
        raise AssertionError(f"the training log lacks its build or epoch lines:\n{text[-3000:]}")
    return {"build_s": float(build.group(1)), "epochs": epochs}


def describe_run(card: str, what: str, logged: dict, wall: float) -> None:
    log(f"  CLI {what}: wall {wall:.2f} s, model build {logged['build_s']:.3f} s [{card}]")
    for e in logged["epochs"]:
        log(f"    epoch {e['epoch']}: {e['steps']} steps in {e['steps_s']:.3f} s "
            f"({e['samples_per_s']:.3f} samples/s, {e['data_wait_s']:.3f} s waiting for data), "
            f"validation {e['validation_s']:.3f} s, checkpoint write {e['checkpoint_s']:.3f} s, "
            f"visuals {e['visuals_s']:.3f} s, optimizer step {e['optimizer_step']}")


def check_run_dir(run: Path, epochs: list, files: list) -> list:
    """The run dir's metrics.csv rows (epochs ``epochs``, finite values) and
    its files (an image may be a PNG or, without Pillow, a .npy)."""
    rows = read_csv_rows(run / "metrics.csv")
    values = [float(v) for r in rows for k, v in r.items() if k != "epoch"]
    if [int(r["epoch"]) for r in rows] != epochs or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{run.name}/metrics.csv: {rows}")
    for name in files:
        path = run / name
        if not (path.exists() or (path.suffix == ".png" and path.with_suffix(".npy").exists())):
            raise AssertionError(f"{run.name} has no {name}")
    return rows


def train_config(path: Path, root: Path, out: Path, **training) -> dict:
    """A config of the repo with its data root, output dir, epochs and the
    visuals' inference steps cut for [22]."""
    cfg = json.loads(path.read_text())
    cfg["training"].update(data_root=str(root), output_dir=str(out), **training)
    if "scheduler" in cfg["model"]:
        cfg["training"]["num_inference_steps"] = TRAIN_VISUAL_STEPS
        cfg["model"]["scheduler"]["num_inference_steps"] = TRAIN_VISUAL_STEPS
    return cfg


def write_config(path: Path, cfg: dict) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg, indent=2))
    return path


def ddpm_rate(cfg: dict, epochs: int):
    """The DDPM config's rate per optimizer step over ``epochs`` of [22]'s
    train split."""
    from fmdm_tpu_torch.train import common

    batch = int(cfg["training"]["train_batch_size"])
    return common.cosine_warmup_schedule(
        float(cfg["training"]["learning_rate"]), int(cfg["training"]["lr_warmup_steps"]),
        epochs * -(-TRAIN_CASES[0] * TRAIN_SLICES // batch))


def phase_train(torch, card: str, seed: int, records, work: Path) -> dict:
    """[22]: training from a config through the CLI and in process; returns
    the launches of the in-process loops."""
    from fmdm_tpu_torch.data.dataset_utils import build_train_val_datasets
    from fmdm_tpu_torch.sample import diffusion_utils
    from fmdm_tpu_torch.train import common, denoise_lib, vae_impl
    from fmdm_tpu_torch.utils import checkpoint as ckpt_utils
    from fmdm_tpu_torch.utils.config import load_json_config

    root = work / "train_ldct"
    val_samples = write_ldct_root(root, seed, TRAIN_CASES, TRAIN_SLICES)
    train_samples = TRAIN_CASES[0] * TRAIN_SLICES
    batch = int(json.loads(CONFIG.read_text())["training"]["train_batch_size"])
    per_epoch = -(-train_samples // batch)
    log(f"[22] python -m fmdm_tpu_torch.train over a synthetic LDCT root: {train_samples} train "
        f"slices ({TRAIN_CASES[0]} cases), {val_samples} test slices ({TRAIN_CASES[1]} cases), "
        f"256²; cuts: epochs {TRAIN_EPOCHS}, {TRAIN_VISUAL_STEPS} inference steps in the visuals, "
        f"VAE visual_samples {VAE_VISUAL_SAMPLES}; PyTorch's default flags in the CLI "
        f"(cudnn.allow_tf32 True) [{card}]")
    base = work / "train"
    runs = {"ddpm": base / "ddpm_run1", "flow": base / "flow_run1", "vae": base / "vae_run1"}

    # the flagship DDPM config, 1 epoch ([35a] resumes the same run under
    # torchrun for a second)
    epochs = TRAIN_EPOCHS["ddpm"]
    cfg = train_config(CONFIG, root, base / "ddpm", num_epochs=epochs)
    text, wall = run_train_cli(card, "ddpm", "--config", write_config(work / "cfg" / "ddpm.json", cfg),
                               process=True)
    first = loop_log(text)
    describe_run(card, f"DDPM, {epochs} epochs at batch {batch}", first, wall)
    check_run_dir(runs["ddpm"], list(range(1, epochs + 1)),
                  ["diff_last.pt", "diff_best.pt", f"epochs/epoch{epochs:04d}/epoch.pt",
                   *(f"visuals/epoch{epochs:04d}_{k}.png" for k in ("input", "output", "target"))])
    payload = ckpt_utils.load_checkpoint(runs["ddpm"] / "diff_last.pt")
    steps = int(payload["optimizer"]["state"][0]["step"])
    lr = payload["optimizer"]["param_groups"][0]["lr"]
    if steps != epochs * per_epoch or lr != ddpm_rate(cfg, epochs)(steps - 1):
        raise AssertionError(f"DDPM run: optimizer step {steps}, rate {lr}")

    # flow matching, 1 epoch
    flow = train_config(FLOW_CONFIG, root, base / "flow", num_epochs=TRAIN_EPOCHS["flow"])
    text, wall = run_train_cli(card, "flow", "--config", write_config(work / "cfg" / "flow.json", flow))
    describe_run(card, "flow matching, 1 epoch", loop_log(text), wall)
    check_run_dir(runs["flow"], [1], ["flow_last.pt", "flow_best.pt", "epochs/epoch0001/epoch.pt",
                                      "visuals/epoch0001_output.png"])

    # the KL-VAE, 2 epochs with the validation split
    vae_epochs = TRAIN_EPOCHS["vae"]
    vae = train_config(VAE_CONFIG, root, base / "vae", epochs=vae_epochs,
                       visual_samples=VAE_VISUAL_SAMPLES)
    text, wall = run_train_cli(card, "vae", "--config", write_config(work / "cfg" / "vae.json", vae))
    vae_logged = loop_log(text)
    describe_run(card, f"KL-VAE, {vae_epochs} epochs at batch {vae['training']['batch_size']}",
                 vae_logged, wall)
    rows = check_run_dir(runs["vae"], list(range(1, vae_epochs + 1)),
                         ["vae_last.pt", "vae_best.pt", f"epochs/epoch{vae_epochs:04d}/epoch.pt",
                          *(f"epochs/epoch{vae_epochs:04d}/{k}.png" for k in ("input", "recon", "gen"))])
    if list(rows[0]) != ["epoch", "loss", "recon", "kl", "vq"] or \
            any(e["validation_s"] <= 0 for e in vae_logged["epochs"]):
        raise AssertionError(f"vae metrics.csv columns {list(rows[0])}, or no validation")
    log(f"  VAE metrics.csv: {list(rows[0])}; {rows}")

    # the train loop's visuals from a checkpoint
    out_dir = work / "debug_visual"
    text, wall = run_train_cli(card, "debug_visual_only", "--config", work / "cfg" / "ddpm.json",
                               "--debug_visual_only", "--ckpt", runs["ddpm"] / "diff_best.pt",
                               "--visual_samples", 2, "--output_dir", out_dir)
    written = sorted(str(p.relative_to(out_dir)) for p in out_dir.rglob("*") if p.is_file())
    log(f"  CLI --debug_visual_only: wall {wall:.2f} s, {len(written)} files [{card}]")
    if not any(f.startswith("grid_output") for f in written) or \
            not any(f.startswith("generated") for f in written):
        raise AssertionError(f"--debug_visual_only wrote {written}")

    # the DDPM and VAE loops in this process, under the CLI's flags
    torch.backends.cudnn.allow_tf32 = True
    totals = {}

    def counted(what, fn, want, calls=lambda kw: 1):
        def call(*args, **kw):
            before = read_counts(records)
            out = fn(*args, **kw)
            after = read_counts(records)
            delta = {k: after[k] - before[k] for k in after}
            expect_counts(f"[22] {what}", delta, want, calls(kw))
            for k, v in delta.items():
                totals[k] = totals.get(k, 0) + v
            return out
        return call

    saves = []

    def checked_save(state, primary, mirrors=(), backend=None):
        live = {k: v.detach().cpu().clone() for k, v in state["model"].items()}
        real_save(state, primary, mirrors, backend)
        stored = ckpt_utils.load_checkpoint(primary)["model"]
        same = stored.keys() == live.keys() and all(torch.equal(stored[k], live[k]) for k in live)
        saves.append(same)
        if not same:
            raise AssertionError(f"{primary} read back differs from the weights it saved")

    timing = {}

    def visual_decode(*args, **kw):
        timing.clear()
        return real_decode(*args, timing=timing, **kw)

    real_save = ckpt_utils.save_checkpoint_with_mirrors
    real_decode = denoise_lib.decode_diffusion_batch
    patched = [
        (common.DenoiseTrainStep, "step", counted("flagship train step", common.DenoiseTrainStep.step,
                                                 DENOISE_LAUNCHES)),
        (common.DenoiseTrainStep, "trial", counted("flagship start-up trial",
                                                  common.DenoiseTrainStep.trial, DENOISE_LAUNCHES)),
        (vae_impl.KLTrainStep, "step", counted("VAE train step", vae_impl.KLTrainStep.step,
                                               VAE_LAUNCHES["train step"])),
        (vae_impl.KLTrainStep, "trial", counted("VAE start-up trial", vae_impl.KLTrainStep.trial,
                                                VAE_LAUNCHES["train step"])),
        (vae_impl.KLTrainStep, "eval", counted("VAE validation call", vae_impl.KLTrainStep.eval,
                                               VAE_LAUNCHES["reconstruct"])),
        (denoise_lib, "decode_diffusion_batch",
         counted("flagship visual model call", visual_decode, DENOISE_LAUNCHES,
                 calls=lambda kw: timing["model_calls"])),
        (ckpt_utils, "save_checkpoint_with_mirrors", checked_save),
    ]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    measured = {}
    # what launches outside the counted calls: nothing in the DDPM loop; the
    # VAE's visuals (one reconstruct and one decode) in its
    uncounted = {"ddpm": {}, "vae": VAE_VISUAL_LAUNCHES}
    try:
        for obj, name, fn in patched:
            setattr(obj, name, fn)
        for label, path, lib, kw in (
                ("ddpm", CONFIG, denoise_lib, {"variant": "diffusion"}),
                ("vae", VAE_CONFIG, vae_impl, {})):
            key = "num_epochs" if label == "ddpm" else "epochs"
            cfg = train_config(path, root, work / "inproc" / label, **{key: 1},
                               **({"visual_samples": VAE_VISUAL_SAMPLES} if label == "vae" else {}))
            cfg_path = write_config(work / "cfg" / f"inproc_{label}.json", cfg)
            train_ds, val_ds = build_train_val_datasets(load_json_config(cfg_path))
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            counted_before, all_before = dict(totals), read_counts(records)
            start = time.perf_counter()
            lib.train(train_ds, cfg_path, val_dataset=val_ds, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = {k: v - all_before[k] for k, v in read_counts(records).items()}
            rest = {k: v - (totals.get(k, 0) - counted_before.get(k, 0)) for k, v in launches.items()}
            expect_counts(f"[22] {label} launches outside the counted calls", rest, uncounted[label])
            for k, v in rest.items():
                totals[k] = totals.get(k, 0) + v
            measured[label] = {"wall": wall, "peak": torch.cuda.max_memory_allocated(),
                               "held": held, "launches": launches}
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    diffusion_utils._ENGINE_CACHE.clear()  # the visuals' engines hold the loop's model
    torch.cuda.empty_cache()
    for label, m in measured.items():
        log(f"  in process, {label} 1 epoch: wall {m['wall']:.2f} s, launches {m['launches']}, "
            f"peak {m['peak'] / 2**30:.2f} GiB ({(m['peak'] - m['held']) / 2**30:.2f} above the "
            f"{m['held'] / 2**30:.2f} held before), cudnn.allow_tf32 "
            f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32} [{card}]")
    log(f"  launches per call held: flagship train step and trial {DENOISE_LAUNCHES}, per visual "
        f"model call {DENOISE_LAUNCHES}; VAE train step and trial {VAE_LAUNCHES['train step']}, "
        f"validation call {VAE_LAUNCHES['reconstruct']}, visuals {VAE_VISUAL_LAUNCHES}; "
        f"{len(saves)} checkpoints read back bitwise equal to the weights they saved")
    if not saves or not all(saves):
        raise AssertionError("no checkpoint was written in process")
    return totals


def sample_once(torch, engine, batch: int, seed: int, records, spatial=(256, 256)):
    """One sample of ``engine``'s steps at (batch, 1, 256, 256) (or
    ``spatial`` volumes) from a CUDA generator seeded ``seed``, the
    concatenated conditioning 0.5 everywhere: the output, the seconds of the
    step loop, the launches and the peak memory."""
    shape = (batch, 1) + tuple(spatial)
    cond = torch.full(shape, 0.5, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(records)
    timing = {}
    out = engine(shape, torch.Generator("cuda").manual_seed(seed), conditioning_batch=cond,
                 timing=timing)
    counts = read_counts(records)
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sample batch {batch}: shape {tuple(out.shape)} or non-finite values")
    return out, timing["model_seconds"], counts, torch.cuda.max_memory_allocated()


def phase_efficient_forward(torch, card: str, seed: int, gen, records) -> None:
    """[23]: both EfficientUNet configs' forwards at full width, card vs CPU."""
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
    from fmdm_tpu_torch.models.unet_efficient import EfficientUNetND
    from fmdm_tpu_torch.sample.engine import normalize_latent_conditioning, prepare_attention_context

    log("[23] full-width EfficientUNet forwards (K1 with FiLM, K2): card vs CPU plain path, batch 1, "
        "f32, TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for path, want_params in EFFICIENT_CONFIGS.items():
        cfg = json.loads(path.read_text())
        conditioning = cfg["training"]["conditioning"]
        model = DiffusionUNetFactory().build(cfg["model"]["unet"], conditioning=conditioning,
                                             channels=1, device="cuda")
        random_weights(torch, model, torch.Generator().manual_seed(seed))
        model.eval()
        n_params = sum(p.numel() for p in model.parameters())
        if not isinstance(model, EfficientUNetND) or n_params != want_params:
            raise AssertionError(f"{path.name}: {type(model).__name__} of {n_params} parameters")
        cpu_model = copy.deepcopy(model).cpu()
        x = torch.randn((1, model.in_channels, 256, 256), generator=gen)
        ctx = None
        if conditioning == "attention":
            # a KL-VAE latent of a 256² slice, standardized per sample
            latent = torch.randn((1, 4, 32, 32), generator=gen)
            ctx = prepare_attention_context(
                normalize_latent_conditioning(latent, cfg["training"]["latent_norm"]))
        t = torch.tensor([500])
        card_ctx = None if ctx is None else ctx.cuda()
        with torch.no_grad():
            model(x.cuda(), t.cuda(), context_ca=card_ctx)  # warm-up
            torch.cuda.synchronize()
            reset_counts(records)
            with recording_k1() as calls:
                start = time.perf_counter()
                y = model(x.cuda(), t.cuda(), context_ca=card_ctx)
                torch.cuda.synchronize()
                fwd_s = time.perf_counter() - start
            counts = read_counts(records)
            start = time.perf_counter()
            y_cpu = cpu_model(x, t, context_ca=ctx)
            cpu_s = time.perf_counter() - start
        expect_counts(f"the {path.name} forward", counts, EFFICIENT_LAUNCHES)
        film = sum(call[4] for call in calls)
        if film != EFFICIENT_FILM:
            raise AssertionError(f"{path.name}: {film} of {len(calls)} K1 calls with FiLM")
        rel = rel_err(y.cpu(), y_cpu)
        log(f"  {path.name} ({conditioning}): {n_params} parameters; output {tuple(y.shape)}; "
            f"max|gpu-cpu|/max|cpu| = {rel:.3e} (tolerance {REL_TOL:g}); launches per forward "
            f"{({k: v for k, v in counts.items() if v})}, {film} K1 calls with FiLM; forward "
            f"{fwd_s * 1e3:.2f} ms on the card, {cpu_s:.2f} s on the CPU [{card}]")
        if not (torch.isfinite(y).all() and rel <= REL_TOL):
            raise AssertionError(f"{path.name}: card forward disagrees with the CPU plain path ({rel})")
        del model, cpu_model


def phase_efficient_train(torch, card: str, seed: int, gen, records, sample_batch: int,
                          scheduler, timesteps) -> dict:
    """[24]: the compvis config's train step (card vs CPU at batch 1, then
    timed at its batch) and its 50-step bf16 sample at ``sample_batch`` (the
    first --batches; the later ones cut for [26b]); returns the launches of
    the timed train steps and of the sample."""
    from fmdm_tpu_torch.sample.engine import SamplingEngine

    cfg = json.loads(EFFICIENT_CONFIG.read_text())
    batch = int(cfg["training"]["train_batch_size"])
    log(f"[24] {EFFICIENT_CONFIG.name}: denoise train step at batch 1, card vs CPU plain path; "
        f"{TRAIN_STEPS} timed steps at batch {batch}, f32, TF32 off; the {NUM_STEPS}-step DPM++ "
        f"sample in bf16")
    model, _, step, cpu_model, _ = train_step_parity(torch, card, cfg, seed, gen, records,
                                                     EFFICIENT_LAUNCHES)
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    film = [(max_err(p.grad.cpu(), cpu_grads[n]) / float(cpu_grads[n].abs().max()), n)
            for n, p in model.named_parameters() if "emb_layers" in n]
    worst = max(film)
    log(f"  the {len(film)} FiLM projections' gradients (emb_layers, through K1's plain "
        f"backward into scale and shift): worst max|gpu-cpu|/max|cpu| {worst[0]:.3e} ({worst[1]}), "
        f"smallest largest gradient {min(float(cpu_grads[n].abs().max()) for _, n in film):.3e}")
    if worst[0] > REL_TOL or any(float(cpu_grads[n].abs().max()) == 0 for _, n in film):
        raise AssertionError(f"FiLM gradients: {worst}")
    del cpu_model, cpu_grads
    data = train_batch(torch, gen, batch, "cuda")
    train_counts = timed_train_steps(torch, card, step, data, torch.Generator("cuda").manual_seed(seed),
                                     records, EFFICIENT_LAUNCHES, "compvis")
    del step, data

    model.eval()
    engine = SamplingEngine(model, scheduler, timesteps, conditioning_mode="concatenate",
                            compute_dtype=torch.bfloat16, device="cuda")
    b = sample_batch
    sample_once(torch, engine, b, seed + b, records)  # warm-up
    out, secs, sample_counts, peak = sample_once(torch, engine, b, seed + b, records)
    expect_counts(f"compvis sample batch {b}", sample_counts, EFFICIENT_LAUNCHES, NUM_STEPS)
    log(f"  sample batch {b}: {secs:.4f} s, {b * NUM_STEPS / secs:.2f} denoise steps/s, peak "
        f"{peak / 2**30:.2f} GiB, launches K1 {sample_counts['K1']} K2 {sample_counts['K2']}, "
        f"output mean {float(out.mean()):.4f} std {float(out.std()):.4f} [{card}]")
    del engine, model
    return {"train": train_counts, "sample": sample_counts}


def phase_deep_cache(torch, card: str, seed: int, gen, records, model, scheduler, timesteps,
                     batch: int, exact_rate: float) -> dict:
    """[25]: DeepCache on the flagship ``model`` (f32 on the card): the
    splice, interval 1, card vs CPU, and cached 50-step samples at ``batch``
    (the first --batches; the later ones cut for [26b], [7] sampling them
    exactly), ``exact_rate`` being [7]'s exact denoise steps/s there;
    returns the launches of the '3:1:adaptive' sample."""
    from fmdm_tpu_torch.sample.engine import SamplingEngine, deep_cache_refresh_mask
    from fmdm_tpu_torch.utils.evaluation import psnr_from_mse

    log("[25] DeepCache on the flagship: the splice at depths 1 and 3, interval 1 vs the uncached "
        "engine, '2:1' card vs CPU, cached 50-step DPM++ samples")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn((1, 2, 256, 256), generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    with torch.no_grad():
        full = model(x, t)
        for depth, shallow_k1 in SHALLOW_K1.items():
            out, feature = model(x, t, cache_depth=depth, return_deep_feature=True)
            reset_counts(records)
            spliced = model(x, t, deep_cache=feature, cache_depth=depth)
            torch.cuda.synchronize()
            counts = read_counts(records)
            expect_counts(f"a shallow forward at depth {depth}", counts, {"K1": shallow_k1})
            rel = max(rel_err(out, full), rel_err(spliced, full))
            same = torch.equal(out, full) and torch.equal(spliced, full)
            log(f"  depth {depth}: feature {tuple(feature.shape)}; capturing and spliced forward "
                f"vs the full forward: bitwise equal {same}, max|diff|/max|full| {rel:.3e}; "
                f"shallow forward launches {counts}")
            if not same:
                raise AssertionError(f"the depth-{depth} splice differs from the full forward ({rel})")

    def engine(steps, dtype=None, deep_cache=None, m=model, device="cuda"):
        return SamplingEngine(m, scheduler, steps, conditioning_mode="concatenate",
                              compute_dtype=dtype, deep_cache=deep_cache, device=device)

    shape = (batch, 1, 256, 256)
    init = torch.randn(shape, generator=gen).cuda()
    cond = torch.full(shape, 0.5, device="cuda")
    outs = [engine(timesteps[:DEEP_CACHE_STEPS], torch.bfloat16, dc)(
        shape, conditioning_batch=cond, init_sample=init) for dc in (None, (1, 1))]
    log(f"  interval 1 vs the uncached engine, {DEEP_CACHE_STEPS} bf16 steps at batch {batch}: "
        f"bitwise equal {torch.equal(*outs)}")
    if not torch.equal(*outs):
        raise AssertionError(f"interval 1 differs from the uncached engine by {max_err(*outs)}")

    one = (1, 1, 256, 256)
    init = torch.randn(one, generator=gen)
    cond = torch.rand(one, generator=gen) * 2 - 1
    cpu_model = copy.deepcopy(model).cpu()
    steps = timesteps[:DEEP_CACHE_PARITY_STEPS]
    mask = deep_cache_refresh_mask(len(steps), 2)
    short = [engine(steps, deep_cache=(2, 1), m=m, device=d)(
        one, conditioning_batch=cond, init_sample=init).cpu()
        for m, d in ((model, "cuda"), (cpu_model, "cpu"))]
    rel = rel_err(*short)
    log(f"  '2:1' over {len(steps)} f32 steps at batch 1 (refresh mask {mask.astype(int).tolist()}): "
        f"max|gpu-cpu|/max|cpu| = {rel:.3e} (tolerance {REL_TOL:g})")
    if not (torch.isfinite(short[0]).all() and rel <= REL_TOL):
        raise AssertionError(f"the cached steps disagree with the CPU plain path ({rel})")
    del cpu_model

    exact, exact_s, _, _ = sample_once(torch, engine(timesteps, torch.bfloat16), batch,
                                       seed + batch, records)
    log(f"  batch {batch}: exact {batch * NUM_STEPS / exact_s:.2f} denoise steps/s here, "
        f"{exact_rate:.2f} in [7] [{card}]")
    main_counts = None
    for setting in DEEP_CACHE_SETTINGS:
        mask = deep_cache_refresh_mask(len(timesteps), setting[0], setting[2])
        full = int(mask.sum())
        shallow = len(mask) - full
        out, secs, counts, peak = sample_once(torch, engine(timesteps, torch.bfloat16, setting),
                                              batch, seed + batch, records)
        want = {"K1": K1_PER_FORWARD * full + SHALLOW_K1[1] * shallow,
                "K2": K2_PER_FORWARD * full}
        expect_counts(f"'{':'.join(map(str, setting))}' sample batch {batch}", counts, want)
        mse = float(((image_range(out) - image_range(exact)) ** 2).mean())
        log(f"  batch {batch} '{':'.join(map(str, setting))}': {full} full + {shallow} shallow "
            f"steps in {secs:.4f} s, {batch * NUM_STEPS / secs:.2f} denoise steps/s "
            f"({exact_s / secs:.3f}x the exact sample), peak {peak / 2**30:.2f} GiB, launches "
            f"K1 {counts['K1']} K2 {counts['K2']}; PSNR against the exact sample from the same "
            f"noise {psnr_from_mse(mse):.2f} dB [{card}]")
        main_counts = main_counts or counts
    return main_counts


def phase_clis(card: str, work: Path) -> None:
    """[26]: the compvis config through the training and run_model CLIs, and
    ``--deep_cache`` through run_model on [20]'s flagship run dir."""
    import re

    log(f"[26] the CLIs: {EFFICIENT_CONFIG.name} trained 1 epoch over [22]'s synthetic root and "
        f"evaluated; --deep_cache on [20]'s flagship run dir and on the compvis run dir")
    cfg = train_config(EFFICIENT_CONFIG, work / "train_ldct", work / "train" / "compvis",
                       num_epochs=1)
    text, wall = run_train_cli(card, "compvis", "--config",
                               write_config(work / "cfg" / "compvis.json", cfg))
    describe_run(card, "compvis DDPM, 1 epoch", loop_log(text), wall)
    run = work / "train" / "compvis_run1"
    check_run_dir(run, [1], ["diff_last.pt", "diff_best.pt", "epochs/epoch0001/epoch.pt",
                             "visuals/epoch0001_output.png"])

    subset = ("--num_samples", 8, "--batch_size", DECODE_BATCH, "--num_inference_steps", CLI_STEPS)
    rows = {}
    for label, ckpt_dir, flags in (
            ("compvis", run, ()),
            ("compvis --deep_cache 3", run, ("--deep_cache", 3)),
            ("flagship --deep_cache 3:1:adaptive", work / "ddpm", ("--deep_cache", "3:1:adaptive")),
            ("flagship --deep_cache auto:0.5", work / "ddpm", ("--deep_cache", "auto:0.5"))):
        out_dir = work / "cli26" / label.replace(" ", "_").replace(":", "-")
        text, secs = run_cli(card, ckpt_dir, "evaluate", *subset, "--output_dir", out_dir, *flags)
        rows[label] = check_evaluate(out_dir, 8)
        throughput = next(line for line in text.splitlines() if line.startswith("Model throughput"))
        chosen = re.search(r"deep_cache auto:\S+ (resolved to [^(]+|— no candidate within budget)",
                           text)
        ignored = "has no deep/shallow split; ignoring" in text
        log(f"  evaluate {label}: {throughput}; MSE {rows[label]['mse']} PSNR "
            f"{rows[label]['psnr']}; {rows[label]['model_calls']} model calls"
            f"{'; ' + chosen.group(1).strip() if chosen else ''}"
            f"{'; DeepCache ignored with a warning' if ignored else ''}; CLI wall {secs:.2f} s [{card}]")
        if label.startswith("compvis --deep_cache") != ignored or \
                label.endswith("auto:0.5") != bool(chosen):
            raise AssertionError(f"evaluate {label}: the warning or the auto resolution is missing")
    exact = [{k: r[k] for k in ("mse", "psnr", "ssim")} for r in rows["compvis"]["per_image"]]
    ignored = [{k: r[k] for k in ("mse", "psnr", "ssim")}
               for r in rows["compvis --deep_cache 3"]["per_image"]]
    log(f"  compvis with --deep_cache 3 equals the exact run per image: {ignored == exact}")
    if ignored != exact:
        raise AssertionError("--deep_cache on EfficientUNet changed the result")


@contextlib.contextmanager
def recording_routes():
    """Record ``kernel_route``'s answer for every CUDA ``sdpa`` call, and
    the shape of every CUDA call that reaches ``sdpa_xla``."""
    from fmdm_tpu_torch.ops import attention

    routes, plain = [], []
    route, xla = attention.kernel_route, attention.sdpa_xla

    def record_route(q, k, v):
        routes.append((tuple(q.shape), str(q.dtype)[6:], route(q, k, v)))
        return routes[-1][2]

    def record_xla(q, k, v, **kw):
        if q.device.type == "cuda":
            plain.append(tuple(q.shape))
        return xla(q, k, v, **kw)

    attention.kernel_route, attention.sdpa_xla = record_route, record_xla
    try:
        yield routes, plain
    finally:
        attention.kernel_route, attention.sdpa_xla = route, xla


def volume_k1(torch, card: str, gen, calls) -> None:
    """K1 at the 3D path's largest group (of the recorded calls: the up
    path's first norm1, 192 channels in 32 groups at 8x128²) at batch 2,
    with FiLM and without, f32 and bf16, each case twice and bitwise equal,
    against its plain version; the plan this card takes; the kernel's ms
    against its bytes bound."""
    from fmdm_tpu_torch.ops.kernels.group_norm import (
        K1, _device_plan, group_norm_act, group_norm_act_reference, vector_aligned)

    shape, groups, eps, _, _ = max(calls, key=lambda c: math.prod(c[0]) // c[1])
    group = math.prod(shape) // groups
    log(f"  K1 at the path's largest group: {shape} in {groups} groups, {group} elements each")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for film in (True, False):
            x, w, b, s, t = k1_inputs(torch, gen, (2,) + shape, dtype, film=film)
            kw = dict(num_groups=groups, eps=eps, act=True, scale=s, shift=t)
            before = dict(K1.variants)
            got = group_norm_act(x, w, b, **kw)
            again = group_norm_act(x, w, b, **kw)
            torch.cuda.synchronize()
            variant = next(k for k in K1.variants if K1.variants[k] != before[k])
            if not torch.equal(got, again):
                raise AssertionError(f"K1 {shape} {name}: two calls on the same inputs differ")
            check_close(f"(2, {', '.join(map(str, shape))}) G={groups} {name} film={film} "
                        f"[{variant.replace('_', ' ')}]", got, group_norm_act_reference(x, w, b, **kw),
                        *TOL[name])
        p = _device_plan(0, group, x.element_size(), vector_aligned(x, got), 2 * groups,
                         dtype == torch.bfloat16, dtype == torch.bfloat16)
        ms = time_ms(lambda: group_norm_act(x, w, b, **kw))
        bound, bound_by, _ = k1_bound(x, w)
        log(f"  {name}: {group * x.element_size() / 2**20:.2f} MiB per group, plan "
            f"{'single pass on clusters' if p.single_pass else 'split'} of {p.ctas} CTAs, "
            f"{p.chunk * x.element_size() / 1024:.0f} KiB each; kernel {ms:.4f} ms at batch 2, "
            f"bound {bound:.4f} ms ({bound_by}) [{card}]")


def volume_flash(torch, gen) -> None:
    """K3, K4 and K5 at the 3D middle attention's bf16 shape in the timed
    train step (batch 4, 8 heads, 2048 tokens, d = 32) against their plain
    versions, each twice and bitwise equal."""
    from fmdm_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_reference, flash_backward_dkv, flash_backward_dq,
        flash_backward_reference, flash_forward)

    tokens = math.prod(s // 4 for s in SHAPE_SP)
    q_shape = (VOLUME_TRAINING["train_batch_size"], UNET_3D["num_heads"], tokens,
               UNET_3D["dim_head"])
    q, k, v, dout = flash_inputs(torch, gen, q_shape, tokens, "bfloat16")
    scale = q_shape[-1] ** -0.5

    def run():
        out, lse = flash_forward(q, k, v, scale)
        delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
        return (out, lse, *flash_backward_dkv(q, k, v, dout, lse, delta, scale),
                flash_backward_dq(q, k, v, dout, lse, delta, scale))

    got, again = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K3-K5 {q_shape} bf16: two calls on the same inputs differ")
    out, lse, dk, dv, dq = got
    ref_out, ref_lse = flash_attention_reference(q, k, v, scale)
    ref_dq, ref_dk, ref_dv = flash_backward_reference(q, k, v, out, lse, dout, scale)
    what = f"q {q_shape} bfloat16, twice bitwise equal"
    check_close(f"K3 {what} out", out, ref_out, *TOL["bfloat16"])
    check_close(f"K3 {what} lse", lse, ref_lse, *TOL["float32"])
    for label, got_t, ref in (("K4 dk", dk, ref_dk), ("K4 dv", dv, ref_dv), ("K5 dq", dq, ref_dq)):
        check_close(f"{label} {what}", got_t, ref, *TOL["bfloat16"])


def phase_volumes(torch, card: str, seed: int, records, scheduler, timesteps) -> dict:
    """[26b]: the 3D volume path at scripts/bench_3d.py's widths (see
    UNET_3D); returns the launches of the timed train steps and of the
    sample."""
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
    from fmdm_tpu_torch.nn.blocks import ResBlockND
    from fmdm_tpu_torch.sample.engine import SamplingEngine

    log(f"[26b] the 3D volume path (scripts/bench_3d.py's EfficientUNetND on {SHAPE_SP} volumes, "
        f"concatenate): forward, {VOLUME_DPM_STEPS} DPM++ steps and a DDPM train step card vs CPU "
        f"(f32, TF32 off, batch 1), the step under remat, K1 at its largest group, K3-K5 at its "
        f"bf16 attention; bf16 train steps and a {NUM_STEPS}-step sample timed")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed + 26)   # the later phases' draws stay as they were
    model = DiffusionUNetFactory().build(UNET_3D, conditioning="concatenate", channels=1,
                                         device="cuda")
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    blocks = [m for m in model.modules() if isinstance(m, ResBlockND)]
    forward_launches = {"K1": 2 * len(blocks), "K3": 1}
    film = sum(m.use_scale_shift_norm for m in blocks)
    if n_params != VOLUME_PARAMS:
        raise AssertionError(f"the 3D EfficientUNet has {n_params} parameters")
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.randn((1, model.in_channels) + SHAPE_SP, generator=gen)
    t = torch.tensor([500])
    with torch.no_grad():
        model(x.cuda(), t.cuda())  # warm-up
        torch.cuda.synchronize()
        reset_counts(records)
        with recording_k1() as calls, recording_routes() as (routes, plain):
            start = time.perf_counter()
            y = model(x.cuda(), t.cuda())
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - start
        counts = read_counts(records)
        start = time.perf_counter()
        y_cpu = cpu_model(x, t)
        cpu_s = time.perf_counter() - start
    rel = rel_err(y.cpu(), y_cpu)
    log(f"  {n_params} parameters, {len(blocks)} ResBlocks; output {tuple(y.shape)}; "
        f"max|gpu-cpu|/max|cpu| = {rel:.3e} (tolerance {REL_TOL:g}); launches per forward "
        f"{({k: v for k, v in counts.items() if v})}, {sum(c[4] for c in calls)} K1 calls with "
        f"FiLM; sdpa routes {routes}, sdpa_xla calls {len(plain)}; forward {fwd_s * 1e3:.2f} ms "
        f"on the card, {cpu_s:.2f} s on the CPU [{card}]")
    expect_counts("the 3D forward", counts, forward_launches)
    if [r[2] for r in routes] != ["flash"] or plain:
        raise AssertionError(f"the 3D middle attention's routes {routes}, sdpa_xla calls {plain}")
    if sum(c[4] for c in calls) != film:
        raise AssertionError(f"{sum(c[4] for c in calls)} of {len(calls)} K1 calls with FiLM")
    if not (torch.isfinite(y).all() and rel <= REL_TOL):
        raise AssertionError(f"the 3D forward disagrees with the CPU plain path ({rel})")

    shape = (1, 1) + SHAPE_SP
    init = torch.randn(shape, generator=gen)
    cond = torch.rand(shape, generator=gen) * 2 - 1
    short = [SamplingEngine(m, scheduler, timesteps[:VOLUME_DPM_STEPS],
                            conditioning_mode="concatenate", device=d)(
        shape, conditioning_batch=cond, init_sample=init).cpu()
        for m, d in ((model, "cuda"), (cpu_model, "cpu"))]
    rel = rel_err(*short)
    log(f"  {VOLUME_DPM_STEPS} DPM++ steps at {shape}: max|gpu-cpu|/max|cpu| = {rel:.3e} "
        f"(tolerance {REL_TOL:g})")
    if not (torch.isfinite(short[0]).all() and rel <= REL_TOL):
        raise AssertionError(f"the 3D DPM++ steps disagree with the CPU plain path ({rel})")
    del model, cpu_model, y, y_cpu

    train_launches = {**forward_launches, "K4": 1, "K5": 1}
    cfg = {"model": {"unet": dict(UNET_3D), "model_type": "diffusion",
                     "scheduler": {"name": "ddpm", "num_train_timesteps": 1000,
                                   "params": {"beta_start": 0.0001, "beta_end": 0.02}}},
           "training": dict(VOLUME_TRAINING)}
    model, _, step, cpu_model, (data, noise, t) = train_step_parity(
        torch, card, cfg, seed, gen, records, train_launches, SHAPE_SP)
    del cpu_model
    grads = [p.grad.detach().clone() for p in model.parameters()]
    # the same step from the same weights under training.remat: the forward
    # again in the backward (K1 and K3 twice), then K4 and K5 once
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    step.optimizer.state.clear()
    step.global_step, step.remat = int(cfg["training"]["lr_warmup_steps"]), True
    reset_counts(records)
    step.step({k: v.cuda() for k, v in data.items()}, noise=noise.cuda(), t=t.cuda())
    torch.cuda.synchronize()
    counts = read_counts(records)
    step.remat = False
    worst = max((max_err(p.grad, g) / float(g.abs().max()), name)
                for (name, p), g in zip(model.named_parameters(), grads))
    log(f"  remat: gradients against the step without it, worst max|diff|/max|grad| "
        f"{worst[0]:.3e} ({worst[1]}; tolerance {VOLUME_REMAT_TOL:g}); launches per step "
        f"{({k: v for k, v in counts.items() if v})}")
    expect_counts("the 3D train step under remat", counts,
                  {"K1": 2 * forward_launches["K1"], "K3": 2, "K4": 1, "K5": 1})
    log(f"  remat: {k1_backward('the 3D train step under remat', forward_launches['K1'])}")
    if not worst[0] <= VOLUME_REMAT_TOL:
        raise AssertionError(f"the remat step's gradients differ: {worst}")
    del grads

    card_gen = torch.Generator("cuda").manual_seed(seed + 26)
    volume_k1(torch, card, card_gen, calls)
    volume_flash(torch, card_gen)

    # bf16, as scripts/bench_3d.py trains and samples
    step.compute_dtype = torch.bfloat16
    batch = int(cfg["training"]["train_batch_size"])
    train_counts = timed_train_steps(torch, card, step,
                                     train_batch(torch, gen, batch, "cuda", SHAPE_SP),
                                     torch.Generator("cuda").manual_seed(seed), records,
                                     train_launches, "3D volume")
    del step
    model.eval()
    engine = SamplingEngine(model, scheduler, timesteps, conditioning_mode="concatenate",
                            compute_dtype=torch.bfloat16, device="cuda")
    b = VOLUME_SAMPLE_BATCH
    sample_once(torch, engine, b, seed + b, records, SHAPE_SP)  # warm-up
    out, secs, sample_counts, peak = sample_once(torch, engine, b, seed + b, records, SHAPE_SP)
    expect_counts(f"3D sample batch {b}", sample_counts, forward_launches, NUM_STEPS)
    log(f"  sample batch {b}: {secs:.4f} s, {b * NUM_STEPS / secs:.2f} denoise steps/s, "
        f"{secs / b:.4f} s per volume, peak {peak / 2**30:.2f} GiB, launches "
        f"{({k: v for k, v in sample_counts.items() if v})}, output mean {float(out.mean()):.4f} "
        f"std {float(out.std()):.4f} [{card}]")
    return {"train": train_counts, "sample": sample_counts, "k1_calls": calls}


def vae_grad_errors(model, cpu_model):
    """The worst gradient of the card against the CPU: per tensor,
    max|gpu-cpu| over the CPU's largest element, except for a tensor whose
    CPU gradient is rounding noise (below 1e-6 of the model's largest, as
    the biases before a GroupNorm of one channel per group, 0 in exact
    arithmetic): held to 1e-5 of the model's largest. Returns (worst, name,
    how many tensors were noise)."""
    pairs = [(n, pg.grad.detach().cpu().float(), pc.grad.detach().float())
             for (n, pg), pc in zip(model.named_parameters(), cpu_model.parameters())
             if pg.grad is not None]
    return worst_grad(pairs, norm=False)[:3]


def worst_grad(pairs, norm: bool):
    """The worst of (name, got, want) gradient pairs as :func:`vae_grad_errors`
    (``norm`` False) and :func:`disc_grad_errors` (``norm`` True) hold them:
    (worst, its name, the noise tensors' count, the worst max|got-want|/max|want|
    of the others)."""
    top = max(float(c.abs().max()) for _, _, c in pairs)
    worst, worst_name, noise, worst_max = 0.0, "", 0, 0.0
    for name, g, c in pairs:
        scale = float(c.abs().max())
        if scale < 1e-6 * top:
            # rounding noise (0 in exact arithmetic, as a bias before a
            # norm of one channel per group): held to 1e-5 of the largest
            noise += 1
            err = float((g - c).abs().max()) / (1e-2 * top)
        else:
            rel_max = float((g - c).abs().max()) / scale
            worst_max = max(worst_max, rel_max)
            err = float((g - c).norm() / c.norm()) if norm else rel_max
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, noise, worst_max


def disc_grad_errors(disc, cpu_disc):
    """The discriminator's gradients, card against CPU: per tensor,
    ‖gpu-cpu‖/‖cpu‖ over its elements. Its LeakyReLUs and hinge losses have
    kinks: where the two sides round a pre-activation to the other side of
    0, an element's slope changes (1 or 0.2, 1 or 0), and a bias gradient
    summing 16384 such elements moves by a share of its largest element;
    the norm over the tensor bounds the change. A tensor whose CPU gradient
    is rounding noise (below 1e-6 of D's largest) is held to 1e-5 of the
    largest. Returns (worst, name, the worst max|gpu-cpu|/max|cpu| of the
    other tensors, for the log)."""
    pairs = [(name, pg.grad.detach().cpu().double(), pc.grad.detach().double())
             for (name, pg), pc in zip(disc.named_parameters(), cpu_disc.parameters())
             if pg.grad is not None]
    worst, worst_name, _, worst_max = worst_grad(pairs, norm=True)
    return worst, worst_name, worst_max


def code_agreement(torch, what: str, card_codes, cpu_codes, z_cpu, embedding_cpu) -> dict:
    """The card's nearest codes against the CPU's: at least CODE_AGREEMENT of
    them equal, and at every code that differs the two codes' distances
    from the (CPU's) latent, in float64, within NEAR_TIE_REL of each other:
    a near tie that a GEMM's rounding may turn either way."""
    card_codes, cpu_codes = card_codes.cpu().reshape(-1), cpu_codes.cpu().reshape(-1)
    differ = (card_codes != cpu_codes).nonzero().reshape(-1)
    rows = torch.movedim(z_cpu, 1, -1).reshape(-1, z_cpu.shape[1]).double()
    emb = embedding_cpu.double()
    worst = 0.0
    for i in differ.tolist():
        d = [float(((rows[i] - emb[c]) ** 2).sum()) for c in (card_codes[i], cpu_codes[i])]
        worst = max(worst, abs(d[0] - d[1]) / max(d))
    frac = 1.0 - len(differ) / card_codes.numel()
    log(f"  {what}: {card_codes.numel() - len(differ)} of {card_codes.numel()} codes equal "
        f"({frac:.6f}); {len(differ)} differ, their distances within {worst:.3e} relative "
        f"(near ties allowed to {NEAR_TIE_REL:g})")
    if frac < CODE_AGREEMENT or worst > NEAR_TIE_REL:
        raise AssertionError(f"{what}: the card's codes disagree with the CPU's beyond near ties")
    return {"equal": frac, "differ": len(differ)}


def timed_vae_steps(torch, card: str, trainer, raw, valid, records, want: dict, what: str,
                    **step_kwargs):
    """TRAIN_STEPS timed steps of ``trainer`` on (raw, valid) drawing from a
    CUDA generator: ms per step, images/s, peak memory, launches per step."""
    gen = torch.Generator("cuda").manual_seed(0)
    trainer.step(raw, valid, generator=gen, **step_kwargs)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(records)
    start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics, _ = trainer.step(raw, valid, generator=gen, **step_kwargs)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - start) / TRAIN_STEPS
    counts = read_counts(records)
    expect_counts(f"a timed {what} train step", counts, want, TRAIN_STEPS)
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError(f"the timed {what} train steps gave a non-finite loss")
    batch = raw.shape[0]
    log(f"  {what}: batch {batch}, {TRAIN_STEPS} steps: {step_s * 1e3:.2f} ms per step, "
        f"{batch / step_s:.2f} images/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches per step {({k: v // TRAIN_STEPS for k, v in counts.items() if v})}, "
        f"last loss {float(metrics['loss']):.6f} [{card}]")
    return step_s * 1e3, counts


def vae_step_parity(torch, what: str, model, cpu_model, training: dict, raw, noise, records,
                    want: dict, grad_tol: float = REL_TOL):
    """One VAETrainStep at batch 1 on the card and on the CPU (the same
    input and posterior noise): the loss, every gradient (:func:`vae_grad_errors`,
    to ``grad_tol``) and, for an EMA codebook, its buffers after the step.
    Returns both trainers and the card's metrics."""
    from fmdm_tpu_torch.train.vae_impl import VAETrainStep

    trainers = [VAETrainStep(m, training) for m in (model, cpu_model)]
    valid = torch.ones(raw.shape[0])
    reset_counts(records)
    m_gpu, _ = trainers[0].step(raw.cuda(), valid.cuda(),
                                noise=None if noise is None else noise.cuda())
    torch.cuda.synchronize()
    expect_counts(f"the {what} train step", read_counts(records), want)
    start = time.perf_counter()
    m_cpu, _ = trainers[1].step(raw, valid, noise=noise)
    cpu_s = time.perf_counter() - start
    loss_rel = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    worst, worst_name, noise_tensors = vae_grad_errors(model, cpu_model)
    buffers = {k: rel_err(b.cpu(), dict(cpu_model.named_buffers())[k])
               for k, b in model.named_buffers()}
    terms = ", ".join(f"{k} {float(m_gpu[k]):.6f}/{float(m_cpu[k]):.6f}"
                      for k in ("recon", "kl", "vq", "perceptual"))
    log(f"  {what}: loss card {float(m_gpu['loss']):.6f} CPU {float(m_cpu['loss']):.6f} (rel "
        f"{loss_rel:.3e}; card/CPU {terms}); worst gradient {worst:.3e} ({worst_name}; "
        f"{noise_tensors} tensors of rounding-noise gradient held to 1e-5 of the largest)"
        f"{'; EMA buffers after the step ' + str({k: f'{v:.3e}' for k, v in buffers.items()}) if buffers else ''}"
        f"; CPU step {cpu_s:.2f} s (tolerance {REL_TOL:g}, gradients {grad_tol:g})")
    if not (loss_rel <= REL_TOL and worst <= grad_tol and
            all(v <= REL_TOL for v in buffers.values())):
        raise AssertionError(f"{what} train step: card disagrees with the CPU (loss {loss_rel}, "
                             f"gradient {worst} at {worst_name}, buffers {buffers})")
    return trainers, m_gpu


def perceptual_sign_flips(torch, losses, recon, target) -> list:
    """For each layer of the perceptual loss, (elements whose sign(r - t)
    differs between the card's VGG and the CPU's on the same images,
    elements): ``losses`` is (card's, CPU's) ``PerceptualLoss``."""
    from fmdm_tpu_torch.ops.resample import resize_bilinear

    signs = []
    for loss in losses:
        device = next(loss.features.parameters()).device
        r, t = (resize_bilinear(x.to(device).repeat(1, 3, 1, 1), (224, 224))
                for x in (recon, target))
        layers = []
        with torch.no_grad():
            for idx, layer in enumerate(loss.features):
                r, t = layer(r), layer(t)
                if idx in loss.layer_indices:
                    layers.append(torch.sign(r - t).cpu())
        signs.append(layers)
    return [(int((a != b).sum()), a.numel()) for a, b in zip(*signs)]


def phase_vq(torch, card: str, seed: int, gen, records) -> dict:
    """[27]: the VQ-VAE configs at full width; returns the launches of the
    timed EMA train steps."""
    from fmdm_tpu_torch.nn.vae_modules import _nearest_codes
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model
    from fmdm_tpu_torch.train.vae_impl import VAETrainStep

    log("[27] VQ-VAE (LDCT_vqvae EMA, LDCT_vqvae_original classic) at full width, f32, TF32 off: "
        "reconstruct and train step at batch 1 card vs CPU plain path, timed steps, the "
        "nearest-code search")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for quantizer, path in VQ_CONFIGS.items():
        cfg = json.loads(path.read_text())
        start = time.perf_counter()
        model = build_vae_model(cfg, generator=torch.Generator().manual_seed(seed), device="cuda")
        build_s = time.perf_counter() - start
        random_weights(torch, model, torch.Generator().manual_seed(seed))
        cpu_model = copy.deepcopy(model).cpu()
        n_params = sum(p.numel() for p in model.parameters())
        side = int(cfg["model"]["resolution"])
        raw = torch.rand((1, 1, side, side), generator=gen)
        inputs = model.image_to_model_range(raw)
        with torch.no_grad():
            model(inputs.cuda())  # warm-up
            torch.cuda.synchronize()
            reset_counts(records)
            start = time.perf_counter()
            rec, aux = model(inputs.cuda())
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - start
            counts = read_counts(records)
            rec_cpu, aux_cpu = cpu_model(inputs)
            z_cpu = cpu_model.encode(inputs)
        expect_counts(f"the {quantizer} VQ-VAE reconstruct", counts, VQ_LAUNCHES["reconstruct"])
        log(f"  {path.name}: {n_params} parameters, codebook {tuple(model.codebook.embedding.shape)} "
            f"({quantizer}); built in {build_s:.2f} s; reconstruct {fwd_s * 1e3:.2f} ms on the card, "
            f"launches {({k: v for k, v in counts.items() if v})} [{card}]")
        agree = code_agreement(torch, f"{quantizer} reconstruct, batch 1", aux["codes"],
                               aux_cpu["codes"], z_cpu, cpu_model.codebook.embedding.detach())
        if agree["differ"] == 0:
            errs = (rel_err(rec.cpu(), rec_cpu),
                    abs(float(aux["perplexity"]) - float(aux_cpu["perplexity"]))
                    / float(aux_cpu["perplexity"]))
            log(f"  every code equal: reconstruction max|gpu-cpu|/max|cpu| {errs[0]:.3e}, "
                f"perplexity rel {errs[1]:.3e} (tolerance {REL_TOL:g})")
            if not (bool(torch.isfinite(rec).all()) and max(errs) <= REL_TOL):
                raise AssertionError(f"{quantizer} VQ reconstruct disagrees with the CPU ({errs})")
            # the step quantizes the same latent, so its codes agree too
            vae_step_parity(torch, f"{quantizer} VQ", model, cpu_model, cfg["training"], raw, None,
                            records, VQ_LAUNCHES["train step"])
        else:
            log(f"  a near tie flipped a code: the output and train-step comparisons, which "
                f"need every code equal, are left out for {quantizer}")
        del cpu_model
        trainer = VAETrainStep(model, cfg["training"])
        batch = int(cfg["training"]["batch_size"])
        raw4 = torch.rand((batch, 1, side, side), generator=gen).cuda()
        step_ms, counts = timed_vae_steps(torch, card, trainer, raw4, torch.ones(batch, device="cuda"),
                                          records, VQ_LAUNCHES["train step"], f"{quantizer} VQ-VAE")
        with torch.no_grad():
            z = model.encode(model.image_to_model_range(raw4))
        flat = torch.movedim(z, 1, -1).reshape(-1, z.shape[1]).contiguous()
        emb = model.codebook.embedding.detach()
        search_ms = time_ms(lambda: _nearest_codes(flat, emb), iters=10)
        ops = 2.0 * flat.shape[0] * emb.shape[0] * emb.shape[1]
        bound, bound_by, term = bound_ms(4 * (flat.numel() + emb.numel()) + 8 * flat.shape[0],
                                         **product_seconds(ops, "float32"))
        log(f"  nearest-code search ({flat.shape[0]} x {emb.shape[0]} x {emb.shape[1]} distance "
            f"product, TF32 off, and the argmin): {search_ms:.4f} ms, bound {bound:.4f} ms "
            f"({term}), {search_ms / step_ms * 100:.1f}% of the {step_ms:.2f} ms step [{card}]")
        if quantizer == "ema":
            out = counts
        del model, trainer
        torch.cuda.empty_cache()

    cfg = json.loads(MAGVIT_CONFIG.read_text())
    model = build_vae_model(cfg, generator=torch.Generator().manual_seed(seed), device="cuda")
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        reset_counts(records)
        side = int(cfg["model"]["resolution"])
        rec, aux = model(model.image_to_model_range(torch.rand((1, 1, side, side), generator=gen)).cuda())
        torch.cuda.synchronize()
    expect_counts("the magvit VQ-VAE reconstruct", read_counts(records), VQ_LAUNCHES["reconstruct"])
    log(f"  {MAGVIT_CONFIG.name}: reconstruct {tuple(rec.shape)} finite "
        f"{bool(torch.isfinite(rec).all())}, codes {tuple(aux['codes'].shape)}, perplexity "
        f"{float(aux['perplexity']):.3f}")
    if not bool(torch.isfinite(rec).all()):
        raise AssertionError("the magvit VQ-VAE reconstruct is not finite")
    del model
    torch.cuda.empty_cache()
    return out


def phase_losses(torch, card: str, seed: int, gen, records) -> dict:
    """[28]: the bce_focal and perceptual KL-VAE recipes at full width, the
    perceptual one on a surrogate VGG16 drawn from ``seed``; returns the
    launches of the timed perceptual steps."""
    import os

    from fmdm_tpu_torch.nn.losses import write_surrogate_vgg16
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model
    from fmdm_tpu_torch.train.vae_impl import VAETrainStep
    from fmdm_tpu_torch.utils.evaluation import latent_shape

    log("[28] the KL-VAE's bce_focal and perceptual recipes at full width, f32, TF32 off: train "
        "step at batch 1 card vs CPU plain path, timed steps at batch 4, the VGG's share")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["FMDM_VGG16_WEIGHTS"] = write_surrogate_vgg16(Path(tmp) / "vgg16.npz", seed)
        try:
            for path in LOSS_CONFIGS:
                cfg = json.loads(path.read_text())
                training = cfg["training"]
                model = build_vae_model(cfg, generator=torch.Generator().manual_seed(seed),
                                        device="cuda")
                random_weights(torch, model, torch.Generator().manual_seed(seed))
                cpu_model = copy.deepcopy(model).cpu()
                side = int(cfg["model"]["resolution"])
                raw = torch.rand((1, 1, side, side), generator=gen)
                noise = torch.randn((1, *latent_shape(cfg["model"])), generator=gen)
                perceptual = float(training.get("perceptual_weight", 0)) > 0
                trainers, metrics = vae_step_parity(
                    torch, path.name, model, cpu_model, training, raw, noise, records,
                    VAE_LAUNCHES["train step"], PERCEPTUAL_GRAD_TOL if perceptual else REL_TOL)
                if perceptual:
                    if not float(metrics["perceptual"]) > 0:
                        raise AssertionError(f"{path.name}: the perceptual term is 0")
                    flips = perceptual_sign_flips(
                        torch, [t.perceptual for t in trainers], raw,
                        torch.rand((1, 1, side, side), generator=gen))
                    log(f"  sign(r - t) differing between the card's and the CPU's VGG on the "
                        f"same images, per layer {sorted(trainers[0].perceptual.layer_indices)}: "
                        f"{[f'{n} of {m}' for n, m in flips]}")
                del cpu_model, trainers
                trainer = VAETrainStep(model, training)
                batch = int(training["batch_size"])
                raw4 = torch.rand((batch, 1, side, side), generator=gen).cuda()
                step_ms, counts = timed_vae_steps(torch, card, trainer, raw4,
                                                  torch.ones(batch, device="cuda"), records,
                                                  VAE_LAUNCHES["train step"], path.name)
                if trainer.perceptual is not None:
                    rec = torch.rand((batch, 1, side, side), device="cuda", requires_grad=True)

                    def vgg():
                        trainer.perceptual(rec, raw4).backward()

                    vgg_ms = time_ms(vgg, iters=5, warmup=1)
                    log(f"  the perceptual loss (224² resize, VGG16 to layer 22) forward and "
                        f"backward at batch {batch}: {vgg_ms:.2f} ms, {vgg_ms / step_ms * 100:.1f}% "
                        f"of the {step_ms:.2f} ms step [{card}]")
                    out = counts
                del model, trainer
                torch.cuda.empty_cache()
        finally:
            del os.environ["FMDM_VGG16_WEIGHTS"]
    return out


def write_latent_root(root: Path, latents: list, scale: float, seed: int) -> Path:
    """A LatentDataset root (header split files, one ``.npy`` per row, the
    same rows in train and test) of ``latents`` times ``scale``, each with a
    conditioning column of the latent plus noise of 0.1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True)
    rows = []
    for i, z in enumerate(latents):
        z = np.asarray(z, np.float32) * scale
        np.save(root / "data" / f"t{i}.npy", z)
        np.save(root / "data" / f"c{i}.npy", (z + 0.1 * rng.standard_normal(z.shape)).astype(np.float32))
        rows.append(f"C{i:03d}\tdata/t{i}.npy\tdata/c{i}.npy")
    for split in ("train.txt", "test.txt"):
        (root / split).write_text("Case\ttarget\tconditioning\n" + "\n".join(rows) + "\n")
    (root / "dataset.json").write_text(json.dumps(
        {"dataset_class": "fmdm_tpu.data.latent:LatentDataset", "use_tensor_cache": False}))
    return root


def phase_vae_clis(torch, card: str, seed: int, records, work: Path) -> dict:
    """[29]: run_model's VAE modes on [22]'s KL-VAE run dir, in subprocesses
    and in process, and a VQ-VAE trained and evaluated through the CLIs;
    returns the launches of the in-process evaluate and the encoded latents."""
    import numpy as np

    from fmdm_tpu_torch import run_model
    from fmdm_tpu_torch.data.io import load_image
    from fmdm_tpu_torch.sample import autoencoder_like
    from fmdm_tpu_torch.sample.sampling_utils import load_run_config
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model
    from fmdm_tpu_torch.utils import checkpoint as ckpt_utils
    from fmdm_tpu_torch.utils.evaluation import latent_shape

    run = work / "train" / "vae_run1"
    subset = ("--num_samples", VAE_CLI_SAMPLES, "--batch_size", DECODE_BATCH)
    log(f"[29] run_model's VAE modes on [22]'s KL-VAE run dir over its synthetic root: "
        f"{VAE_CLI_SAMPLES} samples at batch {DECODE_BATCH}")
    out_dir = work / "cli29" / "evaluate"
    text, _ = run_cli(card, run, "evaluate", *subset, "--output_dir", out_dir)
    row = check_evaluate(out_dir, VAE_CLI_SAMPLES)
    throughput = next(line for line in text.splitlines() if line.startswith("Model throughput"))
    log(f"  evaluate: {throughput}; {row['model_calls']} model calls; MSE {row['mse']} PSNR "
        f"{row['psnr']} SSIM {row['ssim']}")
    run_cli(card, run, "sample", "--save", *subset, "--output_dir", work / "cli29" / "sample")
    out_dir = work / "cli29" / "encode"
    run_cli(card, run, "encode", "--save", *subset, "--output_dir", out_dir)
    # the LDCT writer saves a (C, H, W) latent as C slices in a directory of its own
    latents = [np.stack([np.load(f) for f in sorted(d.glob("slice_*.npy"))])
               for d in sorted({p.parent for p in out_dir.rglob("slice_*.npy")})]
    run_cli(card, run, "debug_compare", "--output_dir", work / "cli29" / "debug_compare")
    stats = json.loads((work / "cli29" / "debug_compare" / "stats.json").read_text())
    predicted = list((work / "cli29" / "sample" / "predicted").rglob("*.npy"))
    shapes = {tuple(z.shape) for z in latents}
    run_cfg = json.loads((run / "train_config.json").read_text())
    side = int(run_cfg["training"]["img_size"])
    log(f"  sample --save: {len(predicted)} predictions; encode --save: {len(latents)} latents of "
        f"{shapes}; debug_compare: recon [{stats['recon_min']:.4f}, {stats['recon_max']:.4f}]")
    if len(predicted) != VAE_CLI_SAMPLES or len(latents) != VAE_CLI_SAMPLES or \
            shapes != {latent_shape(run_cfg["model"])} or not math.isfinite(stats["recon_mean"]):
        raise AssertionError(f"VAE CLIs: {len(predicted)} predictions, latents {shapes}, {stats}")

    # decode: a copy of the run dir over a latent root of encode's output
    latent_run = work / "vae_latents_run"
    latent_run.mkdir()
    cfg = json.loads((run / "train_config.json").read_text())
    cfg["training"]["data_root"] = str(write_latent_root(work / "latents_x1", latents, 1.0, seed))
    (latent_run / "train_config.json").write_text(json.dumps(cfg, indent=2))
    (latent_run / "vae_last.pt").hardlink_to(run / "vae_last.pt")
    run_cli(card, latent_run, "decode", "--save", *subset, "--output_dir", work / "cli29" / "decode")
    decoded = [np.asarray(load_image(p)["Image"], np.float32)
               for p in (work / "cli29" / "decode" / "predicted").rglob("*") if p.is_file()]
    log(f"  decode --save on encode's latents: {len(decoded)} images of "
        f"{ {d.shape for d in decoded} }")
    if len(decoded) != VAE_CLI_SAMPLES or {d.size for d in decoded} != {side * side} or \
            not all(np.isfinite(d).all() for d in decoded):
        raise AssertionError(f"decode wrote {len(decoded)} images")

    # evaluate in process: launches per model call and peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(records)
    start = time.perf_counter()
    run_model.main(["--ckpt_dir", str(run), "--mode", "evaluate", *map(str, subset),
                    "--output_dir", str(work / "cli29" / "inproc")])
    wall = time.perf_counter() - start
    counts = read_counts(records)
    row = check_evaluate(work / "cli29" / "inproc", VAE_CLI_SAMPLES)
    calls = int(row["model_calls"])
    expect_counts("VAE evaluate in process", counts, VAE_LAUNCHES["reconstruct"], calls)
    log(f"  in process: {calls} model calls in {float(row['model_seconds']):.4f} s "
        f"({float(row['model_samples_per_second']):.2f} images/s), wall {wall:.2f} s, launches "
        f"{({k: v for k, v in counts.items() if v})}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    totals = dict(counts)

    # card vs CPU: evaluate of one sample at batch 1 (no draws: the posterior's mode)
    torch.backends.cudnn.allow_tf32 = False
    parity = dict(ckpt_dir=run, num_samples=1, batch_size=1, save=True, seed=seed)
    autoencoder_like.evaluate(device="cuda", output_dir=str(work / "cli29" / "parity_cuda"), **parity)
    autoencoder_like.evaluate(device="cpu", output_dir=str(work / "cli29" / "parity_cpu"), **parity)
    rows = [check_evaluate(work / "cli29" / f"parity_{d}", 1) for d in ("cuda", "cpu")]
    mse = [float(r["per_image"][0]["mse"]) for r in rows]
    mse_rel = abs(mse[0] - mse[1]) / max(abs(mse[1]), 1e-12)
    saved_rel = compare_saved(rows[0]["dir"] / "samples", rows[1]["dir"] / "samples")
    log(f"  card vs CPU, evaluate at batch 1: per-image MSE {mse[0]:.8f} vs {mse[1]:.8f} (rel "
        f"{mse_rel:.3e}), saved tensors {saved_rel:.3e} (tolerance {REL_TOL:g})")
    if mse_rel > REL_TOL:
        raise AssertionError(f"VAE evaluate: card disagrees with the CPU (MSE rel {mse_rel})")

    # the VQ-VAE (EMA) through the training CLI for one epoch, then evaluated
    vq = train_config(VQ_CONFIGS["ema"], work / "train_ldct", work / "train" / "vq", epochs=1,
                      visual_samples=VAE_VISUAL_SAMPLES)
    text, wall = run_train_cli(card, "vq", "--config", write_config(work / "cfg" / "vq.json", vq))
    describe_run(card, "VQ-VAE (EMA), 1 epoch", loop_log(text), wall)
    vq_run = work / "train" / "vq_run1"
    rows = check_run_dir(vq_run, [1], ["vae_last.pt", "vae_best.pt", "epochs/epoch0001/recon.png"])
    if list(rows[0]) != ["epoch", "loss", "recon", "vq"]:
        raise AssertionError(f"VQ metrics.csv columns {list(rows[0])}")
    stored = ckpt_utils.load_checkpoint(vq_run / "vae_last.pt")["model"]
    loaded = build_vae_model(load_run_config(vq_run), device="cuda",
                             ckpt_path=vq_run / "vae_last.pt")
    names = ("embedding", "ema_cluster_size", "ema_w")
    same = all(torch.equal(getattr(loaded.codebook, k).cpu(), stored[f"codebook.{k}"]) for k in names)
    used = int((stored["codebook.ema_cluster_size"] > 1e-3).sum())
    log(f"  VQ run: metrics {rows}; the codebook's EMA buffers read back bitwise: {same}; "
        f"{used} of {stored['codebook.ema_cluster_size'].numel()} codes with an EMA count above 1e-3")
    if not same or used == 0:
        raise AssertionError("the VQ checkpoint's EMA buffers did not read back or never moved")
    del loaded
    out_dir = work / "cli29" / "vq_evaluate"
    text, _ = run_cli(card, vq_run, "evaluate", *subset, "--output_dir", out_dir)
    row = check_evaluate(out_dir, VAE_CLI_SAMPLES)
    throughput = next(line for line in text.splitlines() if line.startswith("Model throughput"))
    log(f"  VQ evaluate: {throughput}; MSE {row['mse']} PSNR {row['psnr']}")
    return {"launches": totals, "latents": latents, "run": run}


def phase_latent_chain(torch, card: str, seed: int, records, work: Path, vae_run: Path,
                       latents: list) -> dict:
    """[30]: a latent-diffusion run dir over [29]'s encoded latents, scored
    in pixels through ``--latent_vae``; returns the launches of the counted
    evaluate."""
    import numpy as np

    from fmdm_tpu_torch import run_model
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
    from fmdm_tpu_torch.nn.layers import init_weights
    from fmdm_tpu_torch.sample import diffusion_like, diffusion_utils
    from fmdm_tpu_torch.schedulers import build_scheduler
    from fmdm_tpu_torch.utils.checkpoint import save_checkpoint

    scale = float(1.0 / np.std(np.stack(latents)))
    root = write_latent_root(work / "latents_scaled", latents, scale, seed)
    channels, side = latents[0].shape[0], latents[0].shape[-1]
    cfg = json.loads(CONFIG.read_text())
    cfg["model"]["unet"].update(sample_size=side, in_channels=channels, out_channels=channels)
    cfg["training"].update(data_root=str(root), channels=channels, img_size=side,
                           num_inference_steps=CLI_STEPS)
    run = work / "latent_ddpm"
    run.mkdir()
    (run / "train_config.json").write_text(json.dumps(cfg, indent=2))
    model = DiffusionUNetFactory().build(cfg["model"]["unet"], conditioning="concatenate",
                                         channels=channels, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    save_checkpoint({"model": model, "epoch": 1}, run / "diff_last.pt")
    latent_vae = f"{vae_run}?scale={scale}"
    samples = len(latents)
    batches = -(-samples // DECODE_BATCH)
    log(f"[30] the latent chain: {CONFIG.name}'s UNet at the latent's shape ({channels} channels, "
        f"{side}², concatenate conditioning) over {samples} encoded latents times {scale:.6f} "
        f"(1/std); evaluate --latent_vae '<[22]'s KL-VAE>?scale=S', {CLI_STEPS} steps, batch "
        f"{DECODE_BATCH}")
    torch.backends.cudnn.allow_tf32 = True
    diffusion_utils._ENGINE_CACHE.clear()
    reset_counts(records)
    start = time.perf_counter()
    run_model.main(["--ckpt_dir", str(run), "--mode", "evaluate", "--num_samples", str(samples),
                    "--batch_size", str(DECODE_BATCH), "--num_inference_steps", str(CLI_STEPS),
                    "--latent_vae", latent_vae, "--output_dir", str(work / "chain" / "evaluate")])
    wall = time.perf_counter() - start
    counts = read_counts(records)
    row = check_evaluate(work / "chain" / "evaluate", samples)
    # per batch: CLI_STEPS UNet calls, then the VAE decode of the samples and of the targets
    want = {"K1": batches * (CLI_STEPS * K1_PER_FORWARD + 2 * VAE_LAUNCHES["decode"]["K1"]),
            "K2": batches * CLI_STEPS * K2_PER_FORWARD,
            "K3": batches * 2 * VAE_LAUNCHES["decode"]["K3"]}
    expect_counts("the latent chain's evaluate", counts, want)
    log(f"  evaluate --latent_vae: {row['model_calls']} UNet calls in "
        f"{float(row['model_seconds']):.4f} s, wall {wall:.2f} s, launches "
        f"{({k: v for k, v in counts.items() if v})} (per batch {CLI_STEPS} UNet calls and 2 VAE "
        f"decodes); pixel MSE {row['mse']} PSNR {row['psnr']} SSIM {row['ssim']} [{card}]")

    # card vs CPU: one sample at batch 1 with the card's draws replayed
    torch.backends.cudnn.allow_tf32 = False
    scheduler, _ = build_scheduler(cfg["model"]["scheduler"], cfg["training"])
    real_decode = diffusion_like.decode_diffusion_batch
    draws = []

    def record(*args, generator=None, **kw):
        shape, device = args[3], kw["device"]
        init = torch.randn(shape, generator=generator, device=device)
        steps = ([torch.randn(shape, generator=generator, device=device)
                  for _ in range(CLI_PARITY_STEPS)] if scheduler.needs_noise else None)
        draws.append((init.cpu(), None if steps is None else [s.cpu() for s in steps]))
        return real_decode(*args, init_noise=init, step_noise=steps, **kw)

    def replay(*args, generator=None, **kw):
        init, steps = draws.pop(0)
        return real_decode(*args, init_noise=init, step_noise=steps, **kw)

    parity = dict(ckpt_dir=run, model_type="diffusion", num_samples=1, batch_size=1,
                  num_inference_steps=CLI_PARITY_STEPS, save=True, seed=seed,
                  latent_vae=latent_vae)
    try:
        diffusion_like.decode_diffusion_batch = record
        diffusion_like._run_evaluate(device="cuda", output_dir=str(work / "chain" / "parity_cuda"),
                                     **parity)
        diffusion_like.decode_diffusion_batch = replay
        diffusion_like._run_evaluate(device="cpu", output_dir=str(work / "chain" / "parity_cpu"),
                                     **parity)
    finally:
        diffusion_like.decode_diffusion_batch = real_decode
    rows = [check_evaluate(work / "chain" / f"parity_{d}", 1) for d in ("cuda", "cpu")]
    mse = [float(r["per_image"][0]["mse"]) for r in rows]
    mse_rel = abs(mse[0] - mse[1]) / max(abs(mse[1]), 1e-12)
    saved_rel = compare_saved(rows[0]["dir"] / "samples", rows[1]["dir"] / "samples")
    log(f"  card vs CPU, evaluate --latent_vae at batch 1, {CLI_PARITY_STEPS} DDPM calls, the "
        f"card's draws replayed: per-image pixel MSE {mse[0]:.8f} vs {mse[1]:.8f} (rel "
        f"{mse_rel:.3e}), saved images {saved_rel:.3e} (tolerance {REL_TOL:g})")
    if mse_rel > REL_TOL:
        raise AssertionError(f"the latent chain: card disagrees with the CPU (MSE rel {mse_rel})")
    diffusion_utils._ENGINE_CACHE.clear()
    return counts


def phase_gan(torch, card: str, seed: int, gen, records, work: Path) -> dict:
    """[31]: the GAN step of ``configs/ldm_autoencoder_kl.json`` (``gan_start``
    0) at full width on a surrogate VGG16 drawn from ``seed``; returns the
    launches of the timed GAN steps."""
    import os

    from fmdm_tpu_torch.nn.losses import generator_hinge_loss, write_surrogate_vgg16
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model
    from fmdm_tpu_torch.train.vae_impl import VAETrainStep
    from fmdm_tpu_torch.utils import checkpoint as ckpt_utils
    from fmdm_tpu_torch.utils.evaluation import latent_shape

    log(f"[31] the GAN step of {GAN_CONFIG.name} (gan_start 0) at full width, f32, TF32 off: "
        f"batch 1 card vs CPU plain path, the leak check, the gate, timed steps at batch 4, "
        f"the training CLI and its resume, a MAGVIT discriminator's step")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = json.loads(GAN_CONFIG.read_text())
    training = dict(cfg["training"], gan_start=0)
    chans, side = int(cfg["model"]["in_channels"]), int(cfg["model"]["resolution"])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["FMDM_VGG16_WEIGHTS"] = write_surrogate_vgg16(Path(tmp) / "vgg16.npz", seed)
        try:
            model = build_vae_model(cfg, generator=torch.Generator().manual_seed(seed),
                                    device="cuda")
            random_weights(torch, model, torch.Generator().manual_seed(seed))
            cpu_model = copy.deepcopy(model).cpu()
            trainers = [VAETrainStep(m, training) for m in (model, cpu_model)]
            disc, cpu_disc = (t.discriminator for t in trainers)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(disc.state_dict().values(),
                                                                cpu_disc.state_dict().values())):
                raise AssertionError("the two sides' discriminators differ before the step")
            raw = torch.rand((1, chans, side, side), generator=gen)
            noise = torch.randn((1, *latent_shape(cfg["model"])), generator=gen)
            valid = torch.ones(1)
            kl = float(training["kl_weight"])
            n_disc = sum(p.numel() for p in disc.parameters())
            log(f"  {sum(p.numel() for p in model.parameters())} VAE parameters, "
                f"{type(disc).__name__} of {n_disc} ({len(trainers[0]._disc_trainable)} trained "
                f"tensors, {sum(1 for _ in disc.parameters()) - len(trainers[0]._disc_trainable)} "
                f"running statistics); disc_lr {trainers[0].disc_optimizer.param_groups[0]['lr']}")

            # the leak check, on the card before any update
            trainer = trainers[0]
            trainer._accumulate(raw.cuda(), valid.cuda(), noise.cuda(), None, kl, True)
            in_step = [p.grad.clone() for p in trainer._disc_trainable]
            trainer.optimizer.zero_grad(set_to_none=True)
            trainer.disc_optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                rec, _ = model(model.image_to_model_range(raw.cuda()), noise=noise.cuda())
            rec_img = model.raw_output_to_image(rec)
            trainer.disc_loss(rec_img, raw.cuda()).backward()
            alone = [p.grad.clone() for p in trainer._disc_trainable]
            trainer.disc_optimizer.zero_grad(set_to_none=True)
            (trainer.gan_weight * generator_hinge_loss(disc(rec_img, train=True))).backward()
            leak = [p.grad.clone() for p in trainer._disc_trainable]
            trainer.disc_optimizer.zero_grad(set_to_none=True)
            top = max(float(g.abs().max()) for g in alone)
            diff = max(float((a - b).abs().max()) for a, b in zip(in_step, alone)) / top
            leak_size = max(float(g.abs().max()) for g in leak) / top
            log(f"  leak check: D's gradients in the step against those of D's loss alone "
                f"{diff:.3e} of the largest; a leaked gan_weight * g_gan would add "
                f"{leak_size:.3e} of it (tolerance 1e-4)")
            if not (diff <= 1e-4 and leak_size >= 100 * max(diff, 1e-6)):
                raise AssertionError(f"the generator's GAN gradient reaches D ({diff}, "
                                     f"leak size {leak_size})")

            # one step, card against the CPU, from the same weights and batch
            before = [[p.detach().cpu().clone() for p in m.parameters()] for m in (model, disc)]
            reset_counts(records)
            m_gpu, _ = trainers[0].step(raw.cuda(), valid.cuda(), noise=noise.cuda(),
                                        disc_active=True)
            torch.cuda.synchronize()
            expect_counts("the GAN train step", read_counts(records), GAN_LAUNCHES)
            start = time.perf_counter()
            m_cpu, _ = trainers[1].step(raw, valid, noise=noise, disc_active=True)
            cpu_s = time.perf_counter() - start
            losses = {k: abs(float(m_gpu[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-12)
                      for k in ("loss", "recon", "perceptual", "kl", "g_gan", "d_gan")}
            gen_worst = vae_grad_errors(model, cpu_model)
            disc_worst = disc_grad_errors(disc, cpu_disc)
            moved = {}
            for what, pair, lr in (("VAE", (model, cpu_model), training["learning_rate"]),
                                   ("D", (disc, cpu_disc),
                                    trainers[0].disc_optimizer.param_groups[0]["lr"])):
                gaps = [float((a.detach().cpu() - b.detach()).abs().max())
                        for a, b in zip(*(m.parameters() for m in pair))]
                moved[what] = (max(gaps), lr)
            log(f"  losses card/CPU: " + ", ".join(
                f"{k} {float(m_gpu[k]):.6f}/{float(m_cpu[k]):.6f} ({v:.2e})"
                for k, v in losses.items()) + f"; CPU step {cpu_s:.2f} s (tolerance 1e-4)")
            log(f"  worst gradient: VAE {gen_worst[0]:.3e} ({gen_worst[1]}; {gen_worst[2]} "
                f"rounding-noise tensors), D ‖gpu-cpu‖/‖cpu‖ {disc_worst[0]:.3e} "
                f"({disc_worst[1]}; max|gpu-cpu|/max|cpu| at most {disc_worst[2]:.3e}) "
                f"(tolerance {PERCEPTUAL_GRAD_TOL:g}); "
                f"parameters after AdamW at most " + ", ".join(
                    f"{k} {v[0]:.3e} apart (2 x lr = {2 * v[1]:g})" for k, v in moved.items()))
            if not (max(losses.values()) <= 1e-4 and gen_worst[0] <= PERCEPTUAL_GRAD_TOL
                    and disc_worst[0] <= PERCEPTUAL_GRAD_TOL
                    and all(gap <= 2 * lr * (1 + 1e-3) for gap, lr in moved.values())):
                raise AssertionError(f"GAN step: card disagrees with the CPU ({losses}, "
                                     f"{gen_worst}, {disc_worst}, {moved})")
            if any(torch.equal(b, a.detach().cpu()) for b, a in zip(before[1], disc.parameters())
                   if a.dim() > 1):
                raise AssertionError("a discriminator conv's weight did not move in the step")
            del cpu_model, trainers[1], cpu_disc

            # the gate off: D is left as it was
            held = {k: v.clone() for k, v in disc.state_dict().items()}
            m_off, _ = trainer.step(raw.cuda(), valid.cuda(), noise=noise.cuda(),
                                    disc_active=False)
            if not all(torch.equal(v, held[k]) for k, v in disc.state_dict().items()) or \
                    any(p.grad is not None for p in disc.parameters()) or \
                    float(m_off["g_gan"]) != 0 or float(m_off["d_gan"]) != 0:
                raise AssertionError("a step with the gate off changed the discriminator")
            log("  gate off: the discriminator's parameters and statistics unchanged, no D "
                "gradient, g_gan = d_gan = 0")

            batch = int(training["batch_size"])
            raw4 = torch.rand((batch, chans, side, side), generator=gen).cuda()
            valid4 = torch.ones(batch, device="cuda")
            on_ms, out = timed_vae_steps(torch, card, trainer, raw4, valid4, records,
                                         GAN_LAUNCHES, "GAN on", disc_active=True)
            off_ms, _ = timed_vae_steps(torch, card, trainer, raw4, valid4, records,
                                        GAN_LAUNCHES, "GAN off", disc_active=False)
            log(f"  the GAN step at batch {batch}: {on_ms:.2f} ms with the gate on, "
                f"{off_ms:.2f} ms off ({on_ms / off_ms:.3f}x) [{card}]")
            del model, trainer, trainers, disc
            torch.cuda.empty_cache()

            # the training CLI: one epoch over [22]'s root, then a resumed second
            root = work / "train_ldct"
            run = work / "train" / "gan_run1"
            per_epoch = -(-TRAIN_CASES[0] * (TRAIN_SLICES - GAN_SLICE_COUNT + 1) // batch)
            for epochs, flags in ((1, ()), (2, ("--resume", run / "vae_last.pt"))):
                # a tensor cache of its own: the root's holds [22]'s one-slice windows
                cli = train_config(GAN_CONFIG, root, run if flags else work / "train" / "gan",
                                   epochs=epochs, gan_start=0, slice_count=GAN_SLICE_COUNT,
                                   visual_samples=VAE_VISUAL_SAMPLES,
                                   tensor_cache_subdir=f"cache_window{GAN_SLICE_COUNT}")
                text, wall = run_train_cli(card, f"gan {epochs}", "--config", write_config(
                    work / "cfg" / f"gan{epochs}.json", cli), *flags)
                describe_run(card, f"{GAN_CONFIG.name} (GAN on), epoch {epochs} at batch {batch}"
                             f"{' resumed' if flags else ''}", loop_log(text), wall)
                rows = check_run_dir(run, list(range(1, epochs + 1)),
                                     ["vae_last.pt", f"epochs/epoch{epochs:04d}/recon.png"])
                payload = ckpt_utils.load_checkpoint(run / "vae_last.pt")
                steps = {int(s["step"]) for s in payload["disc_optimizer"]["state"].values()}
                names = list(payload["extra_state"]["disc_params"])
                resumed = f"Resumed the discriminator and its optimizer (step {per_epoch})"
                if list(rows[0])[-2:] != ["g_gan", "d_gan"] or steps != {epochs * per_epoch} \
                        or not names or float(rows[-1]["g_gan"]) == 0 or \
                        (flags and resumed not in text):
                    raise AssertionError(f"GAN CLI epoch {epochs}: columns {list(rows[0])}, "
                                         f"D steps {steps}, {len(names)} D tensors saved")
                log(f"  metrics.csv {rows}; the checkpoint holds D's {len(names)} tensors and "
                    f"its AdamW at step {epochs * per_epoch}"
                    f"{'; the log: ' + resumed if flags else ''}")

            # the other discriminator: a MAGVIT VQ-VAE step with the GAN on
            vq_cfg = json.loads(MAGVIT_CONFIG.read_text())
            vq_training = dict(vq_cfg["training"], gan_weight=0.5, gan_start=0)
            vq = build_vae_model(vq_cfg, generator=torch.Generator().manual_seed(seed),
                                 device="cuda")
            random_weights(torch, vq, torch.Generator().manual_seed(seed))
            vq_trainer = VAETrainStep(vq, vq_training)
            vq_chans, vq_side = (int(vq_cfg["model"][k]) for k in ("in_channels", "resolution"))
            vq_raw = torch.rand((int(vq_training["batch_size"]), vq_chans, vq_side, vq_side),
                                generator=gen).cuda()
            m_vq, count = vq_trainer.step(vq_raw, torch.ones(vq_raw.shape[0], device="cuda"),
                                          generator=torch.Generator("cuda").manual_seed(seed),
                                          disc_active=True)
            pred = vq_trainer.discriminator(vq_raw, train=False)
            finite = all(math.isfinite(float(v)) for v in m_vq.values())
            log(f"  {MAGVIT_CONFIG.name} with gan_weight 0.5: {type(vq_trainer.discriminator).__name__}"
                f", patch logits {tuple(pred.shape)}, losses " + ", ".join(
                    f"{k} {float(v) / float(count):.5f}" for k, v in m_vq.items()))
            if not finite or tuple(pred.shape[:2]) != (vq_raw.shape[0], 1) or \
                    type(vq_trainer.discriminator).__name__ != "MagvitDiscriminatorND" or \
                    float(m_vq["d_gan"]) <= 0:
                raise AssertionError("the MAGVIT GAN step: non-finite losses or wrong shapes")
            del vq, vq_trainer
            torch.cuda.empty_cache()
        finally:
            del os.environ["FMDM_VGG16_WEIGHTS"]
    return out


def phase_int8(torch, card: str, seed: int, gen, records, work: Path) -> dict:
    """[32]: int8 inference of the flagship from [20]'s run dir: the card's
    calibration against the CPU's, int8 forwards and accumulators card vs
    CPU, decodes against the float decode, ``linear_qdq``, the CLI, and the
    int8 forward's time split. Returns the K1 and K2 launches of the timed
    int8 decode."""
    from fmdm_tpu_torch.ops import quant
    from fmdm_tpu_torch.sample import diffusion_utils as du
    from fmdm_tpu_torch.sample.sampling_utils import load_run_config, resolve_checkpoint
    from fmdm_tpu_torch.sample.engine import select_timesteps
    from fmdm_tpu_torch.schedulers import build_scheduler, resolve_scheduler_override
    from fmdm_tpu_torch.utils.evaluation import psnr_from_mse

    log(f"[32] int8 (W8A8) decode of the flagship from [20]'s run dir: calibration card vs CPU, "
        f"int8 forward card vs CPU, {INT8_STEPS}-step DPM++ decodes against the float one, "
        f"linear_qdq, the CLI, the int8 forward's time split; f32, TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run_dir = work / "ddpm"
    run_cfg = load_run_config(run_dir)
    training, model_cfg = run_cfg["training"], run_cfg["model"]
    ckpt = resolve_checkpoint(run_dir, model_cfg["model_type"])
    model = du.build_diffusion_model(run_cfg, ckpt, device="cuda")
    cpu_model = du.build_diffusion_model(run_cfg, ckpt, device="cpu")
    du._ENGINE_CACHE.clear()
    du._QUANT_CACHE.clear()
    scheduler, _ = build_scheduler(resolve_scheduler_override("dpmsolver++"), training)
    timesteps = select_timesteps(scheduler.set_timesteps(INT8_STEPS))
    mode = du.resolve_conditioning_mode(training.get("conditioning"))
    side = int(model_cfg["unet"]["sample_size"])
    one = (1, 1, side, side)
    cond1 = torch.rand(one, generator=gen) * 2 - 1

    du.set_quantize("int8")
    try:
        start = time.perf_counter()
        qmodel = du._quantized_model_for(model, scheduler, timesteps, one, cond1.cuda(), mode,
                                         None, torch.device("cuda", 0))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - start
        start = time.perf_counter()
        cpu_q = du._quantized_model_for(cpu_model, scheduler, timesteps, one, cond1, mode, None,
                                        torch.device("cpu"))
        cpu_s = time.perf_counter() - start
    finally:
        du.set_quantize(None)
    paths, cpu_paths = quant.quantized_paths(qmodel), quant.quantized_paths(cpu_q)
    scales = [abs(float(qmodel.get_submodule(p).act_scale) - float(cpu_q.get_submodule(p).act_scale))
              / float(cpu_q.get_submodule(p).act_scale) for p in paths]
    weights_equal = all(torch.equal(qmodel.get_submodule(p).qweight.cpu(),
                                    cpu_q.get_submodule(p).qweight) for p in paths)
    n_convs = sum(1 for m in model.modules() if type(m).__name__ == "Conv")
    log(f"  calibration (3 probe forwards at batch 1): {len(paths)} of {n_convs} convs "
        f"quantized on the card in {card_s:.2f} s, {len(cpu_paths)} on the CPU in {cpu_s:.2f} s; "
        f"same paths: {paths == cpu_paths}; int8 weights bitwise equal: {weights_equal}; "
        f"activation scales within {max(scales):.3e} relative [{card}]")
    if paths != cpu_paths or not weights_equal or max(scales) > 1e-4:
        raise AssertionError("the card's calibration picks other paths or scales than the CPU's")

    # the card's scales on both sides. Each int8 conv of one forward, card
    # against CPU on the card's own float input: the quantized operands and
    # the int32 accumulators bitwise. End to end, the two forwards' float
    # inputs differ by rounding (1e-6), and a value near a half step rounds
    # to the other int8 value: such flips, amplified through 48 int8 convs
    # of random weights, set the card-vs-CPU distance (JAX's own jitted
    # int8 forward is ~38 dB from its eager one); logged, held above
    # INT8_FLOOR_DB
    shared = copy.deepcopy(qmodel).cpu()
    x = torch.cat([torch.randn(one, generator=gen), cond1], dim=1)
    t = torch.tensor([500])
    seen = {"card": [], "cpu": []}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, side=side_name: seen[side].append((m, a[0].detach())))
        for side_name, net in (("card", qmodel), ("cpu", shared)) for m in net.modules()
        if isinstance(getattr(m, "weight", None), quant.QuantizedConvWeight)]
    with torch.no_grad():
        reset_counts(records)
        y_card = qmodel(x.cuda(), t.cuda()).cpu()
        counts = read_counts(records)
        y_cpu = shared(x, t)
        y_float = model(x.cuda(), t.cuda()).cpu()
    for h in hooks:
        h.remove()
    expect_counts("an int8 flagship forward", counts, DENOISE_LAUNCHES)
    snr = lambda ref, out: float(10 * torch.log10((ref.double() ** 2).mean()
                                                  / ((out.double() - ref.double()) ** 2).mean()))
    card_cpu, int8_float = snr(y_cpu, y_card), snr(y_float, y_card)
    pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)
    operands_equal = accumulators_equal = True
    geometries = set()   # the accumulators once per geometry: the CPU's GEMMs take ~0.5 s each
    for m, xc in seen["card"]:
        w = m.weight
        kw = dict(stride=pair(m.stride), padding=pair(m.padding), dilation=(1, 1))
        xq = quant.quantize_activation(xc, w.act_scale)
        operands_equal &= torch.equal(xq.cpu(), quant.quantize_activation(
            xc.cpu(), w.act_scale.cpu()))
        geometry = (tuple(xc.shape), tuple(w.qweight.shape), kw["stride"])
        if geometry not in geometries:
            geometries.add(geometry)
            accumulators_equal &= torch.equal(
                quant.int8_conv_accumulate(xq, w.qweight, **kw).cpu(),
                quant.int8_conv_accumulate(xq.cpu(), w.qweight.cpu(), **kw))
    (m0, x0_card), (_, x0_cpu) = seen["card"][0], seen["cpu"][0]
    flips = float((quant.quantize_activation(x0_card, m0.weight.act_scale).cpu()
                   != quant.quantize_activation(x0_cpu, m0.weight.act_scale.cpu())).float().mean())
    log(f"  the {len(seen['card'])} int8 convs of one batch-1 forward on the card's inputs: int8 "
        f"operands card vs CPU bitwise equal: {operands_equal}; int32 accumulators of one conv "
        f"per geometry ({len(geometries)}) bitwise equal: {accumulators_equal}; launches K1 "
        f"{counts['K1']}, K2 {counts['K2']}")
    log(f"  end to end: card vs CPU int8 forward SNR {card_cpu:.2f} dB (max|gpu-cpu|/max|cpu| "
        f"{rel_err(y_card, y_cpu):.3e}), int8 vs float on the card {int8_float:.2f} dB; at the "
        f"first int8 conv {flips:.3e} of the int8 inputs differ (a rounding-level float "
        f"difference across a half step) [{card}]")
    if not (operands_equal and accumulators_equal and card_cpu >= INT8_FLOOR_DB):
        raise AssertionError(f"int8 card vs CPU: operands {operands_equal}, accumulators "
                             f"{accumulators_equal}, SNR {card_cpu} dB")
    del shared, cpu_q, cpu_model

    # decodes at batch 4 against the float decode from the same noise
    shape = (DECODE_BATCH, 1, side, side)
    cond = torch.rand(shape, generator=gen) * 2 - 1
    decoded, launches = {}, {}
    for label in ("float", "int8", "int8+linear"):
        du.set_quantize(None if label == "float" else label)
        try:
            kw = dict(generator=torch.Generator("cuda").manual_seed(seed),
                      num_inference_steps=INT8_STEPS, scheduler_override="dpmsolver++",
                      device="cuda")
            if label != "float":   # calibrates: its forwards stay out of the counts
                du.decode_diffusion_batch(model, training, model_cfg, shape, cond.cuda(), **kw)
                kw["generator"].manual_seed(seed)
            reset_counts(records)
            timing = {}
            decoded[label] = du.decode_diffusion_batch(model, training, model_cfg, shape,
                                                       cond.cuda(), timing=timing, **kw).cpu()
            launches[label] = read_counts(records)
            expect_counts(f"the {label} decode", launches[label], DENOISE_LAUNCHES,
                          timing["model_calls"])
        finally:
            du.set_quantize(None)
        mse = float(((image_range(decoded[label]) - image_range(decoded["float"])) ** 2).mean())
        psnr = psnr_from_mse(mse) if mse > 0 else float("inf")
        log(f"  {label} decode, {timing['model_calls']} model calls at batch {DECODE_BATCH}: "
            f"{timing['model_seconds']:.4f} s, PSNR against the float decode {psnr:.2f} dB "
            f"(images in [0, 1]), launches K1 {launches[label]['K1']} K2 {launches[label]['K2']} "
            f"[{card}]")
        if not bool(torch.isfinite(decoded[label]).all()) or psnr < INT8_FLOOR_DB:
            raise AssertionError(f"the {label} decode: non-finite or PSNR {psnr} dB")
    linear = [p for _, m in du._QUANT_CACHE.values() for p in quant.quantized_paths(m)
              if isinstance(m.get_submodule(p), quant.QuantizedLinearWeight)]
    log(f"  int8+linear quantized Linears on the flagship: {len(linear)} (the token gate keeps "
        f"every Linear float: the attentions at 16² and 8² carry <= 512 tokens at batch 2)")

    # linear_qdq at a shape its gate admits, card vs CPU
    xl = torch.randn((2, 1024, 512), generator=gen)
    wl = torch.randn((512, 512), generator=gen) / 512 ** 0.5
    ql = quant.make_quantized_linear(wl, float(xl.abs().max()))
    acc = [quant.int8_matmul(quant.quantize_activation(a, ql.act_scale).reshape(-1, 512),
                             ql.qweight.to(a.device).t()).cpu() for a in (xl.cuda(), xl)]
    yl = [quant.linear_qdq(a, ql if a.device.type == "cpu" else copy.deepcopy(ql).cuda()).cpu()
          for a in (xl.cuda(), xl)]
    lin_snr = snr(xl @ wl.t(), yl[0])
    log(f"  linear_qdq (2, 1024, 512) x (512, 512): int32 accumulators card vs CPU bitwise equal: "
        f"{torch.equal(*acc)}; output max|gpu-cpu|/max|cpu| {rel_err(*yl):.3e}; SNR against the "
        f"f32 product {lin_snr:.2f} dB")
    if not torch.equal(*acc) or rel_err(*yl) > 1e-6:
        raise AssertionError("linear_qdq: card disagrees with the CPU")

    # the CLI, on [21]'s root
    for label, flags in (("--quantize int8", ("--quantize", "int8")),
                         ("--quantize int8 --deep_cache 3:1:adaptive",
                          ("--quantize", "int8", "--deep_cache", "3:1:adaptive"))):
        out_dir = work / "cli32" / label.replace(" ", "_").replace(":", "-")
        text, _ = run_cli(card, run_dir, "evaluate", "--num_samples", DECODE_BATCH,
                          "--num_inference_steps", CLI_STEPS, "--output_dir", out_dir, *flags)
        row = check_evaluate(out_dir, DECODE_BATCH)
        if "continuing with float weights" in text:
            raise AssertionError(f"{label}: the CLI decoded in float")
        log(f"  {label}: eval mse {float(row['mse']):.6f}, psnr {float(row['psnr']):.3f}, ssim "
            f"{float(row['ssim']):.5f}, model seconds {float(row['model_seconds']):.3f} [{card}]")

    # the int8 forward's time at INT8_TIMED_BATCHES beside bf16 and f32, and its split
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    timed = {}
    for batch in INT8_TIMED_BATCHES:
        xb = torch.randn((batch, 2, side, side), generator=gen).cuda()
        tb = torch.full((batch,), 500, device="cuda")
        with torch.no_grad():
            times = {"int8": time_ms(lambda: qmodel(xb, tb), iters=3, warmup=1),
                     "bf16": time_ms(lambda: bf16(xb.bfloat16(), tb), iters=3, warmup=1),
                     "f32": time_ms(lambda: model(xb, tb), iters=3, warmup=1)}
        timed[batch] = times
        log(f"  forward at batch {batch}: int8 {times['int8']:.2f} ms, bf16 {times['bf16']:.2f} "
            f"ms, f32 {times['f32']:.2f} ms [{card}]")
    split = int8_split(torch, quant, qmodel, (INT8_TIMED_BATCHES[0], 2, side, side), gen)
    total = timed[INT8_TIMED_BATCHES[0]]["int8"]
    log(f"  the int8 convs of one forward at batch {INT8_TIMED_BATCHES[0]} ({split['calls']} calls), "
        f"timed apart: quantize {split['quantize']:.2f} ms, im2col {split['im2col']:.2f} ms, "
        f"_int_mm {split['int_mm']:.2f} ms, dequantize {split['dequant']:.2f} ms; sum "
        f"{sum(split[k] for k in ('quantize', 'im2col', 'int_mm', 'dequant')):.2f} ms of the "
        f"{total:.2f} ms forward; the same GEMMs' bound {split['bound_ms']:.2f} ms (int8 at "
        f"{INT8_OPS_PER_S / 1e12:g} TOP/s) [{card}]")
    del bf16, qmodel, model
    du._QUANT_CACHE.clear()
    du._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    return {k: v for k, v in launches["int8"].items()}


def int8_split(torch, quant, qmodel, shape, gen) -> dict:
    """Record the int8 convs of one forward of ``shape`` and time their parts
    apart on their recorded inputs: the activation's quantization, im2col,
    ``torch._int_mm`` and the dequantization (summed over the calls, ms)."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, a: calls.append((m, a[0].detach())))
             for m in qmodel.modules()
             if isinstance(getattr(m, "weight", None), quant.QuantizedConvWeight)]
    with torch.no_grad():
        qmodel(torch.randn(shape, generator=gen).cuda(),
               torch.full(shape[:1], 500, device="cuda"))
    for h in hooks:
        h.remove()
    prepared = []
    for m, x in calls:
        w = m.weight
        pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)
        geometry = (tuple(w.qweight.shape[2:]), pair(m.stride), pair(m.padding), (1, 1))
        xq = quant.quantize_activation(x, w.act_scale)
        cols, _ = quant.im2col_int8(xq, *geometry)
        b_t = w.qweight.reshape(w.qweight.shape[0], -1).t()
        prepared.append((x, w, geometry, xq, cols, b_t, quant.int8_matmul(cols, b_t)))
    parts = {
        "quantize": time_ms(lambda: [quant.quantize_activation(x, w.act_scale)
                                     for x, w, *_ in prepared], 3, 1),
        "im2col": time_ms(lambda: [quant.im2col_int8(xq, *g) for _, _, g, xq, *_ in prepared],
                          3, 1),
        "int_mm": time_ms(lambda: [quant.int8_matmul(c, b) for *_, c, b, _ in prepared], 3, 1),
        "dequant": time_ms(lambda: [(acc.float() * (w.wscale * w.act_scale)).to(x.dtype)
                                    for x, w, *_, acc in prepared], 3, 1),
        "bound_ms": sum(2 * c.shape[0] * c.shape[1] * b.shape[1] for *_, c, b, _ in prepared)
        / INT8_OPS_PER_S * 1e3,
    }
    parts["calls"] = len(calls)
    return parts


def phase_rmsnorm(torch, card: str, gen) -> None:
    """[33]: ``ResBlockND(norm_type="rmsnorm")`` with FiLM at the given
    width, card against the CPU plain path (no kernel: RMSNorm is plain
    PyTorch, as it is plain XLA in JAX)."""
    from fmdm_tpu_torch.nn.blocks import ResBlockND

    batch, channels, side = RMSNORM_SHAPE
    log(f"[33] ResBlockND(norm_type='rmsnorm') with FiLM at {channels} channels, {side}², batch "
        f"{batch}: card vs CPU plain path, f32, TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    block = ResBlockND(channels, 512, 0.0, use_scale_shift_norm=True, norm_type="rmsnorm",
                       device="cuda")
    random_weights(torch, block, torch.Generator().manual_seed(7))
    with torch.no_grad():
        block.norm1.weight.uniform_(0.5, 1.5)
        block.norm2.weight.uniform_(0.5, 1.5)
    cpu_block = copy.deepcopy(block).cpu()
    x = torch.randn((batch, channels, side, side), generator=gen)
    emb = torch.randn((batch, 512), generator=gen)
    xc, embc = x.cuda(), emb.cuda()
    with torch.no_grad():
        y = block(xc, embc).cpu()
        ms = time_ms(lambda: block(xc, embc), iters=3, warmup=1)
        start = time.perf_counter()
        y_cpu = cpu_block(x, emb)
        cpu_s = time.perf_counter() - start
    rel = rel_err(y, y_cpu)
    log(f"  output {tuple(y.shape)}: max|gpu-cpu|/max|cpu| = {rel:.3e} (tolerance {REL_TOL:g}); "
        f"{ms:.2f} ms on the card, {cpu_s:.2f} s on the CPU [{card}]")
    if not (torch.isfinite(y).all() and rel <= REL_TOL):
        raise AssertionError(f"the rmsnorm ResBlock disagrees with the CPU (rel {rel})")


# ---------------------------------------------------------------------------
# [34] checkpoint backends, [35] data parallelism
# ---------------------------------------------------------------------------

def state_tensors(torch, state: dict) -> dict:
    """Every tensor of a train state by a path name, copied to the host."""
    out = {}
    for key, value in state.items():
        if isinstance(value, torch.nn.Module):
            value = value.state_dict()
        elif isinstance(value, torch.optim.Optimizer):
            value = value.state_dict()["state"]
        if isinstance(value, dict):
            for name, v in value.items():
                items = v.items() if isinstance(v, dict) else [("", v)]
                for sub, t in items:
                    if isinstance(t, torch.Tensor):
                        out[f"{key}/{name}/{sub}"] = t.detach().cpu().clone()
    return out


def loaded_tensors(torch, payload: dict) -> dict:
    """The same paths of a loaded checkpoint."""
    out = {}
    for key in ("model", "ema"):
        out.update({f"{key}/{n}/": t for n, t in payload[key].items()})
    for i, st in payload["optimizer"]["state"].items():
        out.update({f"optimizer/{i}/{k}": t for k, t in st.items()})
    out["rng_state/state/"] = payload["rng_state"]["state"]
    return out


def tree_bytes(torch, tensors: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


def phase_checkpoints(torch, card: str, seed: int, records, train: dict, work: Path) -> dict:
    """[34]: the four checkpoint backends on the flagship's train state after
    [17]'s steps (the model, AdamW and an EMA of the weights); returns the
    launches of the train steps that ran while an async write was pending."""
    from fmdm_tpu_torch.train.common import generator_state
    from fmdm_tpu_torch.utils import checkpoint as ckpt_utils

    log("[34] checkpoint backends on the flagship's train state after [17] (model, AdamW, EMA): "
        "each saved and read back bitwise, the async snapshot against in-place updates, the "
        "stall, the flush and the steps under a pending write")
    model, step, data, noise_gen = (train[k] for k in ("model", "step", "data", "noise_gen"))
    torch.backends.cudnn.allow_tf32 = False
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = {"model": model, "optimizer": step.optimizer, "ema": ema,
             "lr_scheduler": {"last_epoch": 1}, "scaler": None, "epoch": 1, "best_metric": 0.5,
             "rng_state": generator_state(noise_gen)}
    root = work / "backends"
    batch = int(data["valid"].shape[0])
    out = {}

    @functools.lru_cache(maxsize=None)
    def quiet_steps() -> float:
        """Seconds per step of TRAIN_STEPS train steps with no write pending (once)."""
        start = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            step.step(data, generator=noise_gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) / TRAIN_STEPS

    for backend in ckpt_utils.BACKENDS:
        want = state_tensors(torch, state)
        gb = tree_bytes(torch, want) / 1e9
        path = root / backend / "diff_last.pt"
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        ckpt_utils.save_checkpoint(state, path, backend=backend)
        t1 = time.perf_counter()
        line = f"  {backend}: {gb:.3f} GB, "
        if backend.endswith("_async"):
            # an event after the return completes after the snapshot's copies
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            e1.synchronize()
            copied_s = time.perf_counter() - t0
            copy_s = e0.elapsed_time(e1) / 1e3
            # train steps while the write is pending: they change every
            # tensor of the state in place
            reset_counts(records)
            t2 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                step.step(data, generator=noise_gen)
            torch.cuda.synchronize()
            pending_s = (time.perf_counter() - t2) / TRAIN_STEPS
            out = read_counts(records)
            expect_counts("a train step beside a pending write", out, DENOISE_LAUNCHES, TRAIN_STEPS)
            t3 = time.perf_counter()
            ckpt_utils.flush_checkpoint_writes()
            flush_s = time.perf_counter() - t3
            quiet_s = quiet_steps()
            moved = max(float((p.detach().cpu() - want[f"model/{n}/"]).abs().max())
                        for n, p in model.named_parameters())
            line += (f"save_checkpoint returned after {t1 - t0:.3f} s (the stall); the "
                     f"device-to-host copies into pinned memory {copy_s:.3f} s on the card, done "
                     f"{copied_s:.3f} s after the call; flush {flush_s:.3f} s; {TRAIN_STEPS} train steps "
                     f"at batch {batch} {pending_s * 1e3:.2f} ms per step with the write pending, "
                     f"{quiet_s * 1e3:.2f} without; the live weights moved {moved:.3e} after the "
                     f"enqueue")
            if not moved > 0:
                raise AssertionError(f"{backend}: the steps under the pending write moved nothing")
        else:
            line += f"save {t1 - t0:.3f} s ({gb / (t1 - t0):.3f} GB/s)"
        t5 = time.perf_counter()
        got = loaded_tensors(torch, ckpt_utils.load_checkpoint(path))
        load_s = time.perf_counter() - t5
        same = got.keys() == want.keys() and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
        size = (sum(p.stat().st_size for p in path.rglob("*") if p.is_file()) if path.is_dir()
                else path.stat().st_size)
        log(line + f"; read back {load_s:.3f} s, {len(want)} tensors bitwise equal to the state at "
            f"the save: {same}; {'directory' if path.is_dir() else 'file'} of {size / 1e9:.4f} GB "
            f"[{card}]")
        if not same:
            raise AssertionError(f"{backend}: the checkpoint does not hold the state at the save")
    torch_size = (root / "torch" / "diff_last.pt").stat().st_size
    dcp_size = sum(p.stat().st_size for p in (root / "orbax" / "diff_last.pt").rglob("*")
                   if p.is_file())
    log(f"  the DCP directory {dcp_size} bytes against the .pt file's {torch_size} "
        f"({dcp_size / torch_size:.4f}x)")
    return out


DP_LAUNCHES = {"flagship": DENOISE_LAUNCHES, "KL-VAE GAN": VAE_LAUNCHES["train step"],
               "VQ-VAE EMA": VQ_LAUNCHES["train step"]}
DP_TOL = 1e-5          # [35b]: f32, TF32 off
# [35b]'s GAN step: the losses at tests/test_torch_gan.py's 1e-5; the
# gradients per tensor as [31] holds the card against the CPU (1e-2), since
# batch 1 and batch 2 round apart under D's BatchNorm over near-constant
# reconstructions. Read beside: the elementwise excess over that file's
# gradient tolerance (rtol, and the larger of a share of the tensor's
# largest and of the model's), and a planted fault (per-rank BatchNorm
# statistics) the 1e-2 must catch.
DP_GAN_GRAD_TOL = (1e-3, 5e-4, 1e-5)
DP_GAN_LOSS_TOL = 1e-5
DP_RANKS = 2
DP_TIMEOUT_S = 300


def adam_first_update(torch, g, lr: float):
    """AdamW's first step on ``g`` (bias-corrected moments g and g²) without
    the decay: lr g / (|g| + eps)."""
    g = g.double()
    return lr * g / (g.abs() + 1e-8)


def dp_vae_configs():
    """[35b]'s VAE steps: (what, config, training section)."""
    vae = json.loads(VAE_CONFIG.read_text())
    vq = json.loads(VQ_CONFIGS["ema"].read_text())
    return (("KL-VAE GAN", vae, dict(vae["training"], gan_weight=0.5, gan_start=0)),
            ("VQ-VAE EMA", vq, dict(vq["training"])))


def one_process(step):
    """A copy of a train step over a mesh as one process's step: its model,
    optimizers and discriminator copied, no reduction over ranks."""
    ref = copy.deepcopy(step)
    ref.mesh = None
    for module in [ref.model] + ([ref.discriminator] if getattr(ref, "discriminator", None)
                                 is not None else []):
        for m in module.modules():
            if hasattr(m, "mesh"):
                m.mesh = None
    return ref


def per_rank_batch_norm(step):
    """A copy of a GAN train step over the ranks whose discriminator's
    BatchNorms take this rank's batch statistics, not the global batch's:
    the planted fault [35b]'s tolerance must catch."""
    from fmdm_tpu_torch.nn.layers import BatchNorm

    ctl = copy.deepcopy(step)
    for m in ctl.discriminator.modules():
        if isinstance(m, BatchNorm):
            m.mesh = None
    return ctl


def host_state(torch, module) -> dict:
    return {n: t.detach().cpu().clone() for n, t in module.state_dict().items()}


def host_grads(torch, module) -> dict:
    return {n: p.grad.detach().cpu().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def dp_steps(torch, seed: int, mesh, rank: int):
    """[35b]'s three train steps over ``mesh`` (every rank builds the same
    weights from ``seed``), each as (what, step, run(step, rows) -> outputs,
    the global batch's rows of this rank, the rate): the flagship's at 2 rows
    per rank (valid 1, 1 on rank 0 and 1, 0 on rank 1), the KL-VAE's GAN
    step and the VQ-VAE's EMA step at 1 row per rank."""
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model
    from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer
    from fmdm_tpu_torch.train.vae_impl import VAETrainStep

    cfg = json.loads(CONFIG.read_text())
    warmup = int(cfg["training"]["lr_warmup_steps"])
    model, _, step = build_denoise_trainer(cfg, variant="diffusion", num_samples=8,
                                           device="cuda", mesh=mesh)
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    step.global_step = warmup
    data = train_batch(torch, torch.Generator().manual_seed(seed + 5), 2 * DP_RANKS, "cuda")
    data["valid"] = torch.tensor([1.0, 1.0, 1.0, 0.0], device="cuda")

    def denoise(st, rows):
        gen = torch.Generator("cuda").manual_seed(seed + 7)
        return st.step({k: v[rows] for k, v in data.items()}, generator=gen)

    yield "flagship", step, denoise, slice(2 * rank, 2 * rank + 2), step.lr_schedule(warmup)
    del model, step
    for what, vae_cfg, training in dp_vae_configs():
        model = build_vae_model(vae_cfg, generator=torch.Generator().manual_seed(seed),
                                device="cuda")
        random_weights(torch, model, torch.Generator().manual_seed(seed))
        trainer = VAETrainStep(model, training, mesh=mesh)
        raw = torch.rand((DP_RANKS, 1, 256, 256),
                         generator=torch.Generator().manual_seed(seed + 6)).cuda()

        def vae(st, rows, raw=raw):
            gen = torch.Generator("cuda").manual_seed(seed + 8)
            return st.step(raw[rows], torch.ones(raw[rows].shape[0], device="cuda"),
                           generator=gen, disc_active=st.discriminator is not None)

        yield what, trainer, vae, slice(rank, rank + 1), float(training["learning_rate"])
        del model, trainer
    torch.cuda.empty_cache()


def dp_result(torch, step, run, rows, lr: float, records=None, warm: bool = True) -> dict:
    """One train step and (``warm``) a warm one through ``run``: the model's
    (and a discriminator's) parameters and gradients after the first, its
    metrics, count and seconds, the warm step's seconds, and with
    ``records`` the first step's launches."""
    torch.cuda.synchronize()
    if records is not None:
        reset_counts(records)
    start = time.perf_counter()
    out, count = run(step, rows)
    torch.cuda.synchronize()
    res = {"secs": time.perf_counter() - start,
           "counts": read_counts(records) if records is not None else None,
           "state": host_state(torch, step.model), "grads": host_grads(torch, step.model),
           "metrics": ({k: float(v) for k, v in out.items()} if isinstance(out, dict)
                       else {"loss_sum": float(out)}),
           "count": float(count), "lr": lr}
    disc = getattr(step, "discriminator", None)
    if disc is not None:
        res["disc"] = {"state": host_state(torch, disc), "grads": host_grads(torch, disc),
                       "lr": step.disc_optimizer.param_groups[0]["lr"]}
    if warm:
        start = time.perf_counter()
        run(step, rows)
        torch.cuda.synchronize()
        res["warm_secs"] = time.perf_counter() - start
    return res


def dp_run(torch, seed: int, mesh, rank: int, records=None) -> dict:
    """[35b]'s steps over ``mesh``, every rank in lockstep; with ``records``
    (rank 0) also each step's one-process reference on the global batch,
    from a copy of the same weights taken before the step."""
    results, refs, controls = {}, {}, {}
    for what, step, run, rows, lr in dp_steps(torch, seed, mesh, rank):
        ref = one_process(step) if records is not None else None
        ctl = per_rank_batch_norm(step) if getattr(step, "discriminator", None) is not None \
            else None
        results[what] = dp_result(torch, step, run, rows, lr, records)
        if ref is not None:
            refs[what] = dp_result(torch, ref, run, slice(None), lr)
        if ctl is not None:   # every rank, after the reference: the collectives pair up
            controls[what] = dp_result(torch, ctl, run, rows, lr, warm=False)
        del ref, ctl
    return {"dp": results, "one": refs, "control": controls}


def dp_compare(torch, what: str, got: dict, want: dict, gan: str = "") -> dict:
    """The step over the ranks against one process on the global batch: the
    gradients (the model's largest difference over its largest gradient,
    within DP_TOL; a GAN step's generator and discriminator, ``gan``
    "generator" or "discriminator", per tensor as [31] holds the card
    against the CPU, within PERCEPTUAL_GRAD_TOL, and their elementwise
    excess over DP_GAN_GRAD_TOL for the log), the parameters' excess over
    DP_TOL of each tensor's largest plus what AdamW's first step makes of
    the gradients' difference, the buffers (an EMA codebook) within DP_TOL
    of their largest, the metrics within DP_TOL of the largest
    (DP_GAN_LOSS_TOL for a GAN step)."""
    g, w = got["grads"], want["grads"]
    model_max = max(float(t.abs().max()) for t in w.values())
    grad_rel = max(float((g[n] - w[n]).abs().max()) for n in w) / model_max
    excess = None
    if gan:
        rtol, share, floor = DP_GAN_GRAD_TOL
        excess = max(float(((g[n] - w[n]).abs() - rtol * w[n].abs()).max())
                     - max(share * float(w[n].abs().max()), floor * model_max) for n in w)
        grad_err = worst_grad([(n, g[n].double(), w[n].double()) for n in w],
                              norm=gan == "discriminator")[0]
        grad_tol, metric_tol = PERCEPTUAL_GRAD_TOL, DP_GAN_LOSS_TOL
    else:
        grad_err, grad_tol, metric_tol = grad_rel, DP_TOL, DP_TOL
    param_excess = max(float(((got["state"][n] - want["state"][n]).abs().double()
                              - DP_TOL * float(want["state"][n].abs().max())
                              - (adam_first_update(torch, g[n], got["lr"])
                                 - adam_first_update(torch, w[n], got["lr"])).abs()).max())
                       for n in w)
    buffers = [n for n in want["state"] if n not in w and n.startswith("codebook.")]
    buffer_rel = max((float((got["state"][n] - want["state"][n]).abs().max())
                      / max(float(want["state"][n].abs().max()), 1e-30) for n in buffers),
                     default=0.0)
    scale = max(abs(v) for v in want["metrics"].values())
    metric_rel = max(abs(got["metrics"][k] - want["metrics"][k]) for k in want["metrics"]) / scale
    ok = (param_excess <= 0 and grad_err <= grad_tol and buffer_rel <= DP_TOL
          and metric_rel <= metric_tol and got["count"] == want["count"])
    return {"grad_rel": grad_rel, "grad_err": grad_err, "grad_tol": grad_tol,
            "excess": excess, "param_excess": param_excess, "buffer_rel": buffer_rel,
            "metric_rel": metric_rel, "ok": ok}

def dp_worker(rank: int, port: int, seed: int) -> int:
    """Rank ``rank`` of [35b]'s two gloo ranks on the one card (started by
    the main run, which is rank 0)."""
    import torch
    import torch.distributed as dist

    from fmdm_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=DP_RANKS, timeout=mesh_lib.timeout())
    try:
        mesh = mesh_lib.create_data_mesh(2, "cuda")
        results = dp_run(torch, seed, mesh, rank)["dp"]
    finally:
        dist.destroy_process_group()
    print("dp rank", rank, json.dumps({k: {"secs": v["secs"], "warm_secs": v["warm_secs"],
                                           "count": v["count"]} for k, v in results.items()}))
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_torchrun(torch, card: str, seed: int, records, work: Path) -> dict:
    """[35a]: torchrun with NCCL (one rank) training the flagship over [22]'s
    root under ``orbax_async`` with a resume (also [34]'s training-CLI run),
    and ``run_model evaluate`` of that run dir with data-parallel sampling on
    and off; returns the launches of the evaluate with it on."""
    from fmdm_tpu_torch import run_model
    from fmdm_tpu_torch.utils import checkpoint as ckpt_utils

    counts = {}
    # (a) torchrun, NCCL, one rank: the flagship config over [22]'s root
    # under orbax_async (this is also [34]'s training-CLI run), then --resume
    log("[35a] data parallelism: python -m torch.distributed.run --nproc_per_node 1 (NCCL) on "
        "the flagship DDPM config over [22]'s root, checkpoint_backend orbax_async, 1 epoch and "
        "--resume, against [22]'s run without torchrun; run_model evaluate of its run dir with "
        "data-parallel sampling on and with --no_dp_sampling")
    root, base = work / "train_ldct", work / "torchrun"
    reference = work / "train" / "ddpm_run1"
    epochs = TRAIN_EPOCHS["ddpm"]
    runs = []
    for total, resume in ((epochs, None), (epochs + 1, base / "ddpm_run1" / "diff_last.pt")):
        out_dir = base / "ddpm" if resume is None else base / "ddpm_run1"
        cfg = train_config(CONFIG, root, out_dir, num_epochs=total,
                           checkpoint_backend="orbax_async")
        flags = ["--config", write_config(work / "cfg" / f"torchrun_{total}.json", cfg)]
        if resume is not None:
            flags += ["--resume", resume]
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                               "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
                               "--master_port", str(free_port()), "-m", "fmdm_tpu_torch.train",
                               *map(str, flags)], cwd=REPO_ROOT, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - start
        if proc.returncode != 0:
            log(proc.stdout[-2000:])
            log(proc.stderr[-6000:])
            raise AssertionError(f"torchrun training exited {proc.returncode}")
        text = proc.stderr + proc.stdout
        if "Process group: backend nccl, rank 0 of 1" not in text:
            log(text[-3000:])
            raise AssertionError("the torchrun run did not join an NCCL group of one rank")
        runs.append(loop_log(text))
        describe_run(card, f"torchrun, orbax_async, {'--resume, ' if resume else ''}"
                           f"epochs to {total}", runs[-1], wall)
    run = base / "ddpm_run1"
    rows = check_run_dir(run, [epochs, epochs + 1],
                         ["diff_last.pt", "diff_best.pt", f"epochs/epoch{epochs:04d}/epoch.pt",
                          f"epochs/epoch{epochs + 1:04d}/epoch.pt",
                          f"visuals/epoch{epochs + 1:04d}_output.png"])
    ref_rows = read_csv_rows(reference / "metrics.csv")
    losses = [(float(r["train_loss"]), float(w["train_loss"])) for r, w in zip(rows, ref_rows)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in losses)
    first = ckpt_utils.load_checkpoint(run / "epochs" / f"epoch{epochs:04d}" / "epoch.pt")
    payload = ckpt_utils.load_checkpoint(run / "diff_last.pt")
    steps = int(first["optimizer"]["state"][0]["step"])
    steps_after = int(payload["optimizer"]["state"][0]["step"])
    lr_after = payload["optimizer"]["param_groups"][0]["lr"]
    rate = ddpm_rate(cfg, epochs + 1)
    per_epoch = steps // epochs
    log(f"  run dir {run.name}: checkpoints are DCP directories "
        f"{(run / 'diff_last.pt' / '.metadata').is_file()}; epoch losses (torchrun, [22]'s run "
        f"without it) {losses}, rel {loss_rel:.3e}; resume: optimizer step {steps} -> "
        f"{steps_after}, last rate {lr_after:.6e} (the resumed schedule's at step "
        f"{steps_after - 1}: {rate(steps_after - 1):.6e}); epoch {payload['epoch']}")
    if not ((run / "diff_last.pt" / ".metadata").is_file() and len(losses) == epochs
            and loss_rel <= 1e-5 and steps_after == (epochs + 1) * per_epoch
            and lr_after == rate(steps_after - 1)
            and runs[1]["epochs"][0]["optimizer_step"] == steps_after):
        raise AssertionError(f"the torchrun run differs from the run without it ({losses}) or "
                             f"did not continue the optimizer's step {steps}: {steps_after}, "
                             f"rate {lr_after}")

    # run_model evaluate of the DCP run dir, in this process, with
    # data-parallel sampling on (one card: one shard) and off
    per_image = {}
    for flag in ((), ("--no_dp_sampling",)):
        out_dir = work / "dp_eval" / ("off" if flag else "on")
        reset_counts(records)
        in_process(run_model.main, ["--ckpt_dir", str(run), "--mode", "evaluate", "--num_samples",
                                    str(VAE_CLI_SAMPLES), "--num_inference_steps", str(CLI_STEPS),
                                    "--batch_size", str(DECODE_BATCH), "--output_dir",
                                    str(out_dir), *flag])
        torch.cuda.synchronize()
        if not flag:
            counts["evaluate"] = read_counts(records)
            calls = -(-VAE_CLI_SAMPLES // DECODE_BATCH) * CLI_STEPS
            expect_counts("[35a] evaluate", counts["evaluate"], DENOISE_LAUNCHES, calls)
        row = check_evaluate(out_dir, VAE_CLI_SAMPLES)
        per_image[bool(flag)] = [float(r["mse"]) for r in row["per_image"]]
    log(f"  evaluate of {VAE_CLI_SAMPLES} slices (DCP run dir): per-image MSE with data-parallel "
        f"sampling {per_image[False]} equal to --no_dp_sampling: "
        f"{per_image[False] == per_image[True]}; launches {counts['evaluate']} [{card}]")
    if per_image[False] != per_image[True]:
        raise AssertionError("data-parallel sampling on one card changed the evaluation")
    return counts


def phase_gloo_ranks(torch, card: str, seed: int, records) -> dict:
    """[35b]: two gloo ranks sharing the card (this process rank 0, a child
    rank 1) against one process on the global batch; returns the launches
    of rank 0's steps."""
    import torch.distributed as dist

    from fmdm_tpu_torch.parallel import mesh as mesh_lib

    counts = {}
    log(f"[35b] {DP_RANKS} gloo ranks on the one card (this process rank 0, a child rank 1): "
        f"the flagship's train step at 2 rows per rank (valid 1, 1 and 1, 0), the KL-VAE's GAN "
        f"step and the VQ-VAE's EMA step at 1 row per rank, each against one process on the "
        f"global batch, f32, TF32 off; the GAN step also with per-rank "
        f"BatchNorm statistics (a planted fault the tolerance must catch)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    port = free_port()
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank", "1",
                              "--dp-port", str(port), "--seed", str(seed)], cwd=REPO_ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                world_size=DP_RANKS, timeout=mesh_lib.timeout())
        try:
            mesh = mesh_lib.create_data_mesh(2, "cuda")
            ran = dp_run(torch, seed, mesh, 0, records)
        finally:
            dist.destroy_process_group()
        child_out = child.communicate(timeout=DP_TIMEOUT_S)[0]
    except BaseException:
        if child.poll() is None:
            child.kill()
        log(child.communicate()[0][-4000:])
        raise
    if child.returncode != 0:
        log(child_out[-4000:])
        raise AssertionError(f"rank 1 exited {child.returncode}")
    log("  " + [line for line in child_out.splitlines() if line.startswith("dp rank")][-1])
    want = ran["one"]
    for what, res in ran["dp"].items():
        expect_counts(f"[35b] {what} step over the ranks", res["counts"], DP_LAUNCHES[what])
        counts[what] = res["counts"]
        gan = "disc" in res
        cmp = dp_compare(torch, what, res, want[what], "generator" if gan else "")
        line = (f"  {what}: gradients max|ranks-one|/max {cmp['grad_rel']:.3e}"
                + (f" (worst per tensor as [31] holds them {cmp['grad_err']:.3e}, tolerance "
                   f"{cmp['grad_tol']:g}; elementwise excess over tests/test_torch_gan.py's "
                   f"{DP_GAN_GRAD_TOL} {cmp['excess']:.3e})" if gan else "")
                + f", parameters' excess over the bound {cmp['param_excess']:.3e}, buffers "
                f"{cmp['buffer_rel']:.3e}, metrics {cmp['metric_rel']:.3e}, count {res['count']}"
                f"; step over the ranks {res['secs'] * 1e3:.1f} ms (warm {res['warm_secs'] * 1e3:.1f}),"
                f" one process on the global batch {want[what]['secs'] * 1e3:.1f} ms (warm "
                f"{want[what]['warm_secs'] * 1e3:.1f}); launches {res['counts']} [{card}]")
        ok = cmp["ok"]
        if gan:
            d = dp_compare(torch, what, dict(res["disc"], metrics=res["metrics"],
                                             count=res["count"]),
                           dict(want[what]["disc"], metrics=want[what]["metrics"],
                                count=want[what]["count"]), "discriminator")
            line += (f"; D: gradients ‖ranks-one‖/‖one‖ per tensor {d['grad_err']:.3e} "
                     f"(tolerance {d['grad_tol']:g}), elementwise excess {d['excess']:.3e}, "
                     f"max|ranks-one|/max {d['grad_rel']:.3e}, parameters' excess "
                     f"{d['param_excess']:.3e}")
            ok = ok and d["ok"]
        log(line)
        if not ok:
            raise AssertionError(f"[35b] {what}: the step over the ranks differs from one process")
        if gan:
            ctl = ran["control"][what]
            c_g = dp_compare(torch, what, ctl, want[what], "generator")
            c_d = dp_compare(torch, what, dict(ctl["disc"], metrics=ctl["metrics"],
                                               count=ctl["count"]),
                             dict(want[what]["disc"], metrics=want[what]["metrics"],
                                  count=want[what]["count"]), "discriminator")
            log(f"  {what} with per-rank BatchNorm statistics (planted fault): G's gradients per "
                f"tensor {c_g['grad_err']:.3e} (elementwise excess {c_g['excess']:.3e}), D's "
                f"{c_d['grad_err']:.3e} ({c_d['excess']:.3e}), metrics {c_g['metric_rel']:.3e}; "
                f"caught {not (c_g['ok'] and c_d['ok'])} [{card}]")
            if c_g["ok"] and c_d["ok"]:
                raise AssertionError(f"[35b] {what}: the tolerance does not catch per-rank "
                                     f"BatchNorm statistics")
    return counts


def phase_split_engines(torch, card: str, seed: int, records) -> dict:
    """[35c]: the sampling engines split over two shards of the one card;
    returns the launches of the split sample and reconstruct."""
    from fmdm_tpu_torch.parallel import mesh as mesh_lib
    from fmdm_tpu_torch.sample import autoencoder_like
    from fmdm_tpu_torch.sample.engine import SamplingEngine
    from fmdm_tpu_torch.sample.vae_utils import reconstruct_vae_batch
    from fmdm_tpu_torch.schedulers import DPMSolverMultistepScheduler

    counts = {}
    log("[35c] SamplingEngine and the VAE engines' _make_dp_fn over the device list "
        "[cuda:0, cuda:0]: a 3-step DPM++ bf16 sample at batch 4, a reconstruct at batch 3 "
        "(ragged), against the unsplit run")
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory

    unet = DiffusionUNetFactory().build(json.loads(CONFIG.read_text())["model"]["unet"],
                                        conditioning="concatenate", channels=1, device="cuda")
    random_weights(torch, unet, torch.Generator().manual_seed(seed))
    scheduler = DPMSolverMultistepScheduler.create(
        num_train_timesteps=1000, algorithm_type="dpmsolver++", solver_order=2,
        beta_start=0.0001, beta_end=0.02)
    steps = scheduler.set_timesteps(NUM_STEPS)[:3]
    shape = (4, 1, 256, 256)
    cond = torch.full(shape, 0.5, device="cuda")
    two = mesh_lib.create_mesh(devices=["cuda:0", "cuda:0"])
    init = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).cuda()
    # the split sample, and the unsplit engine on each shard's rows alone:
    # the same forwards at batch 2 and the same elementwise scheduler steps
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        engine = SamplingEngine(unet, scheduler, steps, conditioning_mode="concatenate",
                                compute_dtype=torch.bfloat16, device="cuda")
        halves.append(engine((2, 1, 256, 256), conditioning_batch=cond[rows],
                             init_sample=init[rows] * scheduler.init_noise_scale(steps)))
    engine = SamplingEngine(unet, scheduler, steps, conditioning_mode="concatenate",
                            compute_dtype=torch.bfloat16, device="cuda", mesh=two)
    reset_counts(records)
    split = engine(shape, conditioning_batch=cond,
                   init_sample=init * scheduler.init_noise_scale(steps))
    torch.cuda.synchronize()
    counts["sample split"] = read_counts(records)
    expect_counts("[35c] the split sample", counts["sample split"],
                  {"K1": 2 * K1_PER_FORWARD, "K2": 2 * K2_PER_FORWARD}, 3)
    whole = torch.cat(halves)
    sample_rel = rel_err(split, whole)
    bitwise = bool(torch.equal(split, whole))
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model

    vae = build_vae_model(dp_vae_configs()[0][1], generator=torch.Generator().manual_seed(seed),
                          device="cuda").eval()
    images = torch.rand((3, 1, 256, 256), generator=torch.Generator().manual_seed(seed)).numpy()
    core = lambda m, x: reconstruct_vae_batch(m, x)
    rec_one = autoencoder_like._make_dp_fn(core, vae, 3, torch.device("cuda"))(images)
    reset_counts(records)
    rec_split = autoencoder_like._make_dp_fn(core, vae, 3, torch.device("cuda"), two)(images)
    torch.cuda.synchronize()
    counts["reconstruct split"] = read_counts(records)
    expect_counts("[35c] the split reconstruct", counts["reconstruct split"],
                  VAE_LAUNCHES["reconstruct"], 2)
    rec_rel = rel_err(rec_split, rec_one)
    log(f"  sample over the two shards against each shard's rows sampled alone: max|split-one|/"
        f"max|one| {sample_rel:.3e}, bitwise {bitwise} (tolerance {REL_TOL:g}), launches per step "
        f"{({k: v // 3 for k, v in counts['sample split'].items() if v})}; reconstruct "
        f"{tuple(rec_split.shape)} against batch 3 unsplit {rec_rel:.3e} (tolerance "
        f"{REL_TOL:g}), launches {({k: v for k, v in counts['reconstruct split'].items() if v})} "
        f"[{card}]")
    if not (sample_rel <= REL_TOL and rec_rel <= REL_TOL and tuple(rec_split.shape) == (3, 1, 256, 256)):
        raise AssertionError(f"[35c] the split engines differ (sample {sample_rel}, "
                             f"reconstruct {rec_rel})")
    return counts


# ---------------------------------------------------------------------------
# [36] the rest of parallelism: ring attention, FSDP, tensor parallelism
# ---------------------------------------------------------------------------

SP_RANKS = 2                    # [36]: the ring's positions and the gloo ranks
RING_SHAPE = (4, 4, 1024, 64)   # [10]'s KL-VAE mid attention (T = 32²), f32
# the ring against the unsharded kernels and the plain versions: its
# chunks are summed in another order (the logaddexp fold, dq over two hops)
RING_TOL = (1e-4, 1e-5)         # rtol, atol as a share of the reference's largest
SEQ_ENGINE_MIN_TOKENS = 64      # [36c]'s sample: the flagship's 256- and 64-token calls
# [36c], each over the unsplit engine's largest. The ring's precision is
# held in place, each mid attention of the reconstruct against the
# unsharded K3 at RING_TOL. The whole reconstruct moves ~1e-5 for any
# change in the mid attentions' roundings, however small (SEQ_PROBES read
# its response), so its limit sits between that floor and the response to
# the last probe, the control (ten times RING_TOL's share), which must
# exceed it
SEQ_SAMPLE_TOL = 1e-5
SEQ_RECON_TOL = 1e-4
SEQ_PROBES = (1e-7, 1e-6, 1e-5, 1e-4)   # each mid attention's output moved by a share


def check_ring(what: str, got, ref) -> float:
    """``got`` within RING_TOL of ``ref``: the error over ref's largest."""
    import torch

    err = max_err(got, ref)
    scale = float(ref.float().abs().max())
    ok = bool(torch.all((got.float() - ref.float()).abs()
                        <= RING_TOL[1] * scale + RING_TOL[0] * ref.float().abs()))
    log(f"  {what}: max_abs_err {err:.3e}, over the largest {err / scale:.3e} (tolerance "
        f"{RING_TOL[1]:g} of the largest + {RING_TOL[0]:g}*|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the ring disagrees (max_abs_err {err})")
    return err


def phase_ring(torch, card: str, seed: int, records) -> dict:
    """[36a]: the flash ring in one process over two shards of the card at
    the KL-VAE's mid-attention shape; returns its launches and timings."""
    from fmdm_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_reference, flash_backward, flash_backward_chunk, flash_backward_dkv,
        flash_backward_dq, flash_backward_reference, flash_forward, flash_forward_partials)
    from fmdm_tpu_torch.parallel import sequence as seq

    n, t = SP_RANKS, RING_SHAPE[2]
    log(f"[36a] ring attention over {n} shards of the card (one process, a hop is .to() to the "
        f"same card): q, k, v {RING_SHAPE} f32, T = {t} cut into {t // n}-token shards, "
        f"impl 'flash': K3 on every forward hop, K4 + K5 on every backward hop")
    gen = torch.Generator().manual_seed(seed + 36)
    q, k, v, dout = flash_inputs(torch, gen, RING_SHAPE, t, "float32")
    scale = RING_SHAPE[-1] ** -0.5
    devices = ["cuda:0"] * n
    ring = seq.DeviceRing(devices)
    cut = lambda x: [c.contiguous() for c in x.chunk(n, dim=-2)]
    out_u, lse_u = flash_forward(q, k, v, scale)
    grads_u = flash_backward(q, k, v, out_u, lse_u, dout, scale)
    ref_out, ref_lse = flash_attention_reference(q, k, v, scale)
    ref_grads = flash_backward_reference(q, k, v, ref_out, ref_lse, dout, scale)
    torch.cuda.synchronize()

    reset_counts(records)
    outs, lses = seq._ring_flash_forward(ring, cut(q), cut(k), cut(v), scale)
    torch.cuda.synchronize()
    fwd = read_counts(records)
    expect_counts("[36a] the ring's forward", fwd, {"K3": n * n})
    out_r, lse_r = torch.cat(outs, dim=-2), torch.cat(lses, dim=-2)
    worst = {"K3": max(check_ring("forward out vs unsharded K3", out_r, out_u),
                       check_ring("forward out vs plain", out_r, ref_out),
                       check_ring("forward lse vs unsharded K3", lse_r, lse_u),
                       check_ring("forward lse vs plain", lse_r, ref_lse))}

    leaves = [[c.requires_grad_() for c in cut(x)] for x in (q, k, v)]
    reset_counts(records)
    ring_out = seq.ring_attention(*leaves, devices=devices, impl="flash")
    torch.autograd.backward(ring_out, cut(dout))
    torch.cuda.synchronize()
    counts = read_counts(records)
    expect_counts("[36a] the ring's forward and backward", counts,
                  {"K3": n * n, "K4": n * n, "K5": n * n})
    grads_r = [torch.cat([c.grad for c in shards], dim=-2) for shards in leaves]
    for name, got, unsharded, plain in zip(("dq", "dk", "dv"), grads_r, grads_u, ref_grads):
        kernel = "K5" if name == "dq" else "K4"
        worst[kernel] = max(worst.get(kernel, 0.0),
                            check_ring(f"backward {name} vs unsharded K4 + K5", got, unsharded),
                            check_ring(f"backward {name} vs plain", got, plain))
    log(f"  launches per forward + backward: {counts} (per shard: K3 {n} forward hops, K4 and "
        f"K5 {n} backward hops each) [{card}]")

    hop_shape = RING_SHAPE[:2] + (t // n, RING_SHAPE[3])
    log(f"  the chunk entry points alone at the hop shape, q and k/v {hop_shape}, against their "
        f"plain versions; the backward against the global (out, lse)")
    hop = [x[..., : t // n, :].contiguous() for x in (q, k, v, dout, out_u)]
    hop_lse = lse_u[..., : t // n, :].contiguous()
    for dtype in ("float32", "bfloat16"):
        hq, hk, hv, hg, ho = (x.to(getattr(torch, dtype)) for x in hop)
        o_c, lse_c = flash_forward_partials(hq, hk, hv, scale)
        p_o, p_lse = flash_attention_reference(hq, hk, hv, scale)
        worst["K3"] = max(worst["K3"], check_close(f"flash_forward_partials {dtype} out", o_c, p_o,
                                                   *TOL[dtype]),
                          check_close(f"flash_forward_partials {dtype} lse", lse_c, p_lse,
                                      *TOL["float32"]))
        got = flash_backward_chunk(hq, hk, hv, ho, hop_lse, hg, scale)
        want = flash_backward_reference(hq, hk, hv, ho, hop_lse, hg, scale)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            kernel = "K5" if name == "dq" else "K4"
            worst[kernel] = max(worst[kernel], check_close(
                f"flash_backward_chunk {dtype} {name}", a, b, *TOL[dtype]))

    reset_counts(records)
    einsum = seq.ring_attention(cut(q), cut(k), cut(v), devices=devices, impl="einsum")
    torch.cuda.synchronize()
    expect_counts("[36a] the einsum ring", read_counts(records), {})
    check_ring("the einsum ring's out vs unsharded K3", torch.cat(einsum, dim=-2), out_u)

    hq, hk, hv, hg = hop[:4]
    h_delta = (hg * hop[4]).sum(dim=-1, keepdim=True)
    qs, ks, vs, gs = cut(q), cut(k), cut(v), cut(dout)
    ms = {"K3 hop": time_ms(lambda: flash_forward_partials(hq, hk, hv, scale)),
          "K4 hop": time_ms(lambda: flash_backward_dkv(hq, hk, hv, hg, hop_lse, h_delta, scale)),
          "K5 hop": time_ms(lambda: flash_backward_dq(hq, hk, hv, hg, hop_lse, h_delta, scale)),
          "ring forward": time_ms(lambda: seq._ring_flash_forward(ring, qs, ks, vs, scale), 10),
          "ring backward": time_ms(lambda: seq._ring_flash_backward(ring, qs, ks, vs, outs, lses,
                                                                    gs, scale), 10),
          "unsharded forward": time_ms(lambda: flash_forward(q, k, v, scale), 10),
          "unsharded backward": time_ms(lambda: flash_backward(q, k, v, out_u, lse_u, dout,
                                                               scale), 10)}
    bh, th, d = RING_SHAPE[0] * RING_SHAPE[1], t // n, RING_SHAPE[3]
    reads = 4 * hq.numel() * 4 + 2 * bh * th * 4
    hop_bounds = {
        "K3 hop": attention_bound(4 * hq.numel() * 4 + bh * th * 4, 4 * bh * th * th * d,
                                  bh * th * th, "float32"),
        "K4 hop": attention_bound(reads + 2 * hq.numel() * 4, 8 * bh * th * th * d, bh * th * th,
                                  "float32"),
        "K5 hop": attention_bound(reads + hq.numel() * 4, 6 * bh * th * th * d, bh * th * th,
                                  "float32")}
    log(f"  per hop at {hop_shape} f32: " + ", ".join(
        f"{k} {ms[k]:.4f} ms (bound {hop_bounds[k][0]:.4f}, {hop_bounds[k][2]})"
        for k in hop_bounds) + f" [{card}]")
    log(f"  T = {t}: ring forward {ms['ring forward']:.4f} ms against unsharded K3 "
        f"{ms['unsharded forward']:.4f} ms; ring backward {ms['ring backward']:.4f} ms against "
        f"unsharded K4 + K5 {ms['unsharded backward']:.4f} ms [{card}]")
    return {"counts": counts, "ms": ms, "hop_bounds": {k: b[0] for k, b in hop_bounds.items()},
            "max_abs_err": worst}


def par_cases(torch, seed: int, rank: int):
    """[36b]'s three steps on this rank, each as (what, plan, the step over
    the ranks, a one-process copy of it (rank 0) or None, run(step, rows),
    this rank's rows of the global batch, the rate, its expected launches,
    the global rows)."""
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model
    from fmdm_tpu_torch.train.common import parallel_plan
    from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer
    from fmdm_tpu_torch.train.vae_impl import VAETrainStep

    dev = torch.device("cuda", 0)
    vae_cfg = json.loads(VAE_CONFIG.read_text())
    training = dict(vae_cfg["training"], sequence_parallel=SP_RANKS)
    plan = parallel_plan(training, 1, dev, vae=True)
    model = build_vae_model(vae_cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    random_weights(torch, model, torch.Generator().manual_seed(seed))
    ref = VAETrainStep(copy.deepcopy(model), training) if rank == 0 else None
    trainer = VAETrainStep(model, training, mesh=plan.batch_mesh)
    trainer.shard(plan)
    gen = torch.Generator().manual_seed(seed + 9)
    raw = torch.rand((SP_RANKS, 1, 256, 256), generator=gen).to(dev)
    m = vae_cfg["model"]
    side = m["resolution"] // 2 ** (len(m["down_channels"]) - 1)
    latent = torch.randn((SP_RANKS, m["embed_dim"], side, side), generator=gen).to(dev)

    def vae(st, rows):
        return st.step(raw[rows], torch.ones(raw[rows].shape[0], device=dev), noise=latent[rows])

    per_call = VAE_LAUNCHES["train step"]
    yield ("KL-VAE sequence_parallel 2", plan, trainer, ref, vae, slice(rank, rank + 1),
           float(training["learning_rate"]),
           {"K1": per_call["K1"], **{k: SP_RANKS * per_call[k] for k in ("K3", "K4", "K5")}},
           SP_RANKS)
    del model, trainer, ref
    cfg = json.loads(CONFIG.read_text())
    warmup = int(cfg["training"]["lr_warmup_steps"])
    for what, flags, per_rank, rows_of in (
            ("flagship fsdp", {"fsdp": True}, 2, lambda r: slice(2 * r, 2 * r + 2)),
            ("flagship tensor_parallel 2", {"tensor_parallel": SP_RANKS}, 1, lambda r: slice(0, 1))):
        training = dict(cfg["training"], **flags)
        plan = parallel_plan(training, per_rank, dev)
        model, _, step = build_denoise_trainer(dict(cfg, training=training), variant="diffusion",
                                               num_samples=8, device=dev, mesh=plan.batch_mesh)
        random_weights(torch, model, torch.Generator().manual_seed(seed))
        step.global_step = warmup
        ref = one_process(step) if rank == 0 else None
        step.reduce_grads = plan.reduce_grads
        (step.optimizer,), (step.ema,) = plan.shard([model], [step.optimizer], [step.ema])
        rows = per_rank * plan.rows[1]
        gen = torch.Generator().manual_seed(seed + 10)
        data = train_batch(torch, gen, rows, "cuda")
        noise = torch.randn((rows, 1, 256, 256), generator=gen).cuda()
        t = torch.randint(0, 1000, (rows,), generator=gen, dtype=torch.int32).cuda()

        def denoise(st, sl, data=data, noise=noise, t=t):
            return st.step({k: v[sl] for k, v in data.items()}, noise=noise[sl], t=t[sl])

        yield (what, plan, step, ref, denoise, rows_of(plan.rows[0]), step.lr_schedule(warmup),
               DENOISE_LAUNCHES, rows)
        del model, step, ref
    torch.cuda.empty_cache()


def par_run(torch, seed: int, rank: int, records=None) -> dict:
    """[36b]'s steps on this rank, every rank in lockstep; on rank 0
    (``records``) also each one-process reference on the global batch (no
    collective, no ring), the launches and the state bytes."""
    from fmdm_tpu_torch.ops import attention as attention_ops
    from fmdm_tpu_torch.train.common import state_bytes

    out = {}
    for what, plan, step, ref, run, rows, lr, launches, global_rows in par_cases(torch, seed, rank):
        torch.cuda.synchronize()
        if records is not None:
            reset_counts(records)
        start = time.perf_counter()
        metrics, count = run(step, rows)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = read_counts(records) if records is not None else None
        model = step.model
        grads = {n: plan.whole(model, n, p.grad).detach().cpu().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        state = {k: v.detach().cpu().clone() for k, v in plan.full_model_state(model).items()}
        opts = [step.optimizer] + ([step.disc_optimizer] if getattr(step, "disc_optimizer", None)
                                   else [])
        res = {"secs": secs, "counts": counts, "grads": grads, "state": state, "lr": lr,
               "metrics": ({k: float(v) for k, v in metrics.items()} if isinstance(metrics, dict)
                           else {"loss_sum": float(metrics)}),
               "count": float(count), "bytes": state_bytes(model, *opts), "kind": plan.kind,
               "launches": launches, "rows": global_rows}
        start = time.perf_counter()
        run(step, rows)
        torch.cuda.synchronize()
        res["warm_secs"] = time.perf_counter() - start
        if ref is not None:
            with attention_ops.sequence_parallel_scope(None):
                res["one"] = dp_result(torch, ref, run, slice(None), lr)
            res["one"]["bytes"] = state_bytes(ref.model, ref.optimizer)
        attention_ops.clear_sequence_parallel()
        out[what] = res
        del step, ref
    return out


def par_worker(rank: int, port: int, seed: int) -> int:
    """Rank ``rank`` of [36b]'s gloo ranks on the one card (started by the
    main run, which is rank 0)."""
    import torch
    import torch.distributed as dist

    from fmdm_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=SP_RANKS, timeout=mesh_lib.timeout())
    try:
        results = par_run(torch, seed, rank)
    finally:
        dist.destroy_process_group()
    print("par rank", rank, json.dumps({k: {"secs": v["secs"], "warm_secs": v["warm_secs"],
                                            "bytes": v["bytes"]} for k, v in results.items()}))
    return 0


def phase_par_ranks(torch, card: str, seed: int, records) -> dict:
    """[36b]: sequence parallelism, FSDP and tensor parallelism over two
    gloo ranks sharing the card (this process rank 0, a child rank 1)
    against one process on the global batch; returns rank 0's launches."""
    import torch.distributed as dist

    from fmdm_tpu_torch.parallel import mesh as mesh_lib

    log(f"[36b] {SP_RANKS} gloo ranks on the one card (this process rank 0, a child rank 1): "
        f"the KL-VAE train step ({VAE_CONFIG.name}, full width) under sequence_parallel "
        f"{SP_RANKS} at 1 row per rank (the mid attention's all-to-all and ring), the flagship's "
        f"train step under fsdp at 2 rows per rank and under tensor_parallel {SP_RANKS} on one "
        f"shared row, each against one process on the global batch, f32, TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    port = free_port()
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--par-rank", "1",
                              "--dp-port", str(port), "--seed", str(seed)], cwd=REPO_ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                world_size=SP_RANKS, timeout=mesh_lib.timeout())
        try:
            ran = par_run(torch, seed, 0, records)
        finally:
            dist.destroy_process_group()
        child_out = child.communicate(timeout=DP_TIMEOUT_S)[0]
    except BaseException:
        if child.poll() is None:
            child.kill()
        log(child.communicate()[0][-4000:])
        raise
    if child.returncode != 0:
        log(child_out[-4000:])
        raise AssertionError(f"rank 1 exited {child.returncode}")
    log("  " + [line for line in child_out.splitlines() if line.startswith("par rank")][-1])
    counts = {}
    for what, res in ran.items():
        expect_counts(f"[36b] {what} over the ranks", res["counts"], res["launches"])
        counts[what] = res["counts"]
        one = res["one"]
        cmp = dp_compare(torch, what, res, one)
        share = res["bytes"] / one["bytes"]
        log(f"  {what} ({res['kind']}, global batch {res['rows']}): gradients max|ranks-one|/max "
            f"{cmp['grad_rel']:.3e}, parameters' excess over the bound {cmp['param_excess']:.3e}, "
            f"losses {cmp['metric_rel']:.3e} (tolerance {DP_TOL:g}), count {res['count']}; step "
            f"over the ranks {res['secs'] * 1e3:.1f} ms (warm {res['warm_secs'] * 1e3:.1f}), one "
            f"process {one['secs'] * 1e3:.1f} ms (warm {one['warm_secs'] * 1e3:.1f}); parameters "
            f"and optimizer state {res['bytes'] / 1e9:.4f} GB on rank 0 against "
            f"{one['bytes'] / 1e9:.4f} GB whole ({share:.3f}); launches {res['counts']} [{card}]")
        if not cmp["ok"]:
            for name in list(one["grads"])[:0] + sorted(
                    one["grads"], key=lambda n: -float((res["state"][n] - one["state"][n]).abs()
                                                       .max()))[:3]:
                diff = (res["state"][name] - one["state"][name]).abs()
                i = int(diff.argmax())
                log(f"    {name}: |ranks-one| {float(diff.flatten()[i]):.3e} at {i}, gradients "
                    f"{float(res['grads'][name].flatten()[i]):.3e} and "
                    f"{float(one['grads'][name].flatten()[i]):.3e}")
            raise AssertionError(f"[36b] {what}: the step over the ranks differs from one process")
        if res["kind"] in ("fsdp", "tp") and not share < 0.6:
            raise AssertionError(f"[36b] {what}: rank 0 holds {share:.3f} of the state")
    return counts


def phase_seq_engines(torch, card: str, seed: int, records) -> dict:
    """[36c]: the engines over a one-process (data, seq) mesh of two shards
    of the card; returns their launches."""
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
    from fmdm_tpu_torch.ops import attention as attention_ops
    from fmdm_tpu_torch.ops.kernels.flash_attention import flash_attention
    from fmdm_tpu_torch.parallel import mesh as mesh_lib
    from fmdm_tpu_torch.sample import autoencoder_like
    from fmdm_tpu_torch.sample.engine import SamplingEngine
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model, reconstruct_vae_batch
    from fmdm_tpu_torch.schedulers import DPMSolverMultistepScheduler

    # as from [5] on: under TF32 convolutions the reconstruct's rounding
    # noise alone reads ~2e-3, whatever moves it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.create_dp_sp_mesh(2, SP_RANKS, devices=["cuda:0"] * SP_RANKS)
    log(f"[36c] the engines over a one-process (data, seq) mesh {mesh.shape} of shards of the "
        f"card: a KL-VAE reconstruct at batch 2 (its two mid attentions at 1024 tokens through "
        f"the flash ring, min_tokens 512), and a 3-step DPM++ f32 sample of the flagship at "
        f"batch 2 with min_tokens {SEQ_ENGINE_MIN_TOKENS} (its six attentions, 64 heads x d = 8, "
        f"through the einsum ring), each against the unsplit engine")
    counts = {}
    vae = build_vae_model(json.loads(VAE_CONFIG.read_text()),
                          generator=torch.Generator().manual_seed(seed), device="cuda").eval()
    random_weights(torch, vae, torch.Generator().manual_seed(seed))
    images = torch.rand((2, 1, 256, 256), generator=torch.Generator().manual_seed(seed)).numpy()
    core = lambda m, x: reconstruct_vae_batch(m, x)
    recon = lambda mesh=None: autoencoder_like._make_dp_fn(
        core, vae, 2, torch.device("cuda"), mesh)(images)
    one = recon()
    floor = rel_err(recon(), one)   # the unsplit engine run to run
    routed = []   # (q, k, v, out) of each attention the ring takes
    reset_counts(records)
    with long_attention(lambda q, k, v, out: routed.append((q, k, v, out)) or out):
        split = recon(mesh)
    torch.cuda.synchronize()
    counts["reconstruct"] = read_counts(records)
    rec_want = dict(VAE_LAUNCHES["reconstruct"])
    rec_want["K3"] *= SP_RANKS * SP_RANKS   # per call: 2 shards x 2 hops
    expect_counts("[36c] the reconstruct over the seq mesh", counts["reconstruct"], rec_want)
    if len(routed) != VAE_LAUNCHES["reconstruct"]["K3"]:
        raise AssertionError(f"[36c] the ring took {len(routed)} attention calls of the "
                             f"reconstruct; expected {VAE_LAUNCHES['reconstruct']['K3']}")
    rec_rel = rel_err(split, one)
    # the ring in place: each routed call against the unsharded K3 on its own inputs
    ring_rel = max(check_ring(f"[36c] mid attention {i} of the reconstruct over the seq mesh vs "
                              f"the unsharded K3 on its inputs", out,
                              flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))
                   / float(out.abs().max()) for i, (q, k, v, out) in enumerate(routed))
    del routed
    # the unsplit reconstruct with each mid attention's output moved by a
    # share of its largest (uniform noise): its response to the ring's size
    # of error and above; the last share is the control the limit must catch
    moved = {}
    for share in SEQ_PROBES:
        noise = torch.Generator("cuda").manual_seed(seed + 36)
        with long_attention(lambda q, k, v, out: out + share * out.abs().max() * (
                2 * torch.rand(out.shape, generator=noise, device=out.device) - 1)):
            moved[share] = rel_err(recon(), one)
    log(f"  reconstruct {tuple(split.shape)}: max|seq-one|/max|one| {rec_rel:.3e} (limit "
        f"{SEQ_RECON_TOL:g}), bitwise {bool(torch.equal(split, one))}; unsplit run to run "
        f"{floor:.3e}; the ring in place {ring_rel:.3e} of the largest; each mid attention moved "
        f"by a share of its largest moves the output "
        f"{', '.join(f'{share:g}: {m:.3e}' for share, m in moved.items())}; launches "
        f"{counts['reconstruct']} [{card}]")
    if not moved[SEQ_PROBES[-1]] > SEQ_RECON_TOL:
        raise AssertionError(f"[36c] the control ({SEQ_PROBES[-1]:g} in each mid attention) "
                             f"moves the reconstruct {moved[SEQ_PROBES[-1]]}, within the limit "
                             f"{SEQ_RECON_TOL}")

    unet = DiffusionUNetFactory().build(json.loads(CONFIG.read_text())["model"]["unet"],
                                        conditioning="concatenate", channels=1, device="cuda")
    random_weights(torch, unet, torch.Generator().manual_seed(seed))
    scheduler = DPMSolverMultistepScheduler.create(
        num_train_timesteps=1000, algorithm_type="dpmsolver++", solver_order=2,
        beta_start=0.0001, beta_end=0.02)
    steps = scheduler.set_timesteps(NUM_STEPS)[:3]
    shape = (2, 1, 256, 256)
    cond = torch.full(shape, 0.5, device="cuda")
    init = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).cuda()
    single = SamplingEngine(unet, scheduler, steps, conditioning_mode="concatenate",
                            device="cuda")(shape, conditioning_batch=cond, init_sample=init)
    attention_ops.set_sequence_parallel(mesh, "seq", min_tokens=SEQ_ENGINE_MIN_TOKENS)
    try:
        engine = SamplingEngine(unet, scheduler, steps, conditioning_mode="concatenate",
                                device="cuda", mesh=mesh)
        reset_counts(records)
        sample = engine(shape, conditioning_batch=cond, init_sample=init)
        torch.cuda.synchronize()
    finally:
        attention_ops.clear_sequence_parallel()
    counts["sample"] = read_counts(records)
    expect_counts("[36c] the sample over the seq mesh", counts["sample"],
                  {"K1": K1_PER_FORWARD, "K2": 0}, 3)
    sample_rel = rel_err(sample, single)
    log(f"  sample: max|seq-one|/max|one| {sample_rel:.3e} (limit {SEQ_SAMPLE_TOL:g}), bitwise "
        f"{bool(torch.equal(sample, single))}, launches per step "
        f"{({k: v // 3 for k, v in counts['sample'].items() if v})} [{card}]")
    if not (rec_rel <= SEQ_RECON_TOL and sample_rel <= SEQ_SAMPLE_TOL):
        raise AssertionError(f"[36c] the engines over the seq mesh differ (reconstruct "
                             f"{rec_rel}, sample {sample_rel})")
    return counts


QUALITY_CASES = (2, 1, 4)   # [37]: train cases, test cases, slices per case
QUALITY_STEPS = 4
QUALITY_SAMPLES = 4
QUALITY_DEEP_CACHE = "2:1:adaptive"


def table_rows(text: str, header: str) -> dict:
    """``{first cell: [other cells]}`` of the markdown table under the line
    that starts with ``header`` in ``text``."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith(header))
    rows = {}
    for line in lines[start + 2:]:
        if not line.startswith("| "):
            break
        cells = [c.strip() for c in line.strip("|").split("|")]
        rows[cells[0]] = cells[1:]
    return rows


def check_quality_rows(what: str, rows: dict, want: list) -> None:
    """Every row of a tool's table: a finite PSNR with its 95% CI and a
    finite SSIM."""
    if sorted(rows) != sorted(want):
        raise AssertionError(f"{what}: table rows {sorted(rows)}, expected {sorted(want)}")
    for name, cells in rows.items():
        psnr, sep, ci = cells[0].partition(" ± ")
        values = [float(psnr), float(ci or "nan"), float(cells[1])]
        if not sep or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{what}: row {name} {cells} lacks a finite PSNR, CI or SSIM")


def phase_quality_tools(card: str, work: Path) -> None:
    """[37]: the quality tools on the card, in subprocesses, at the
    flagship's width and a cut depth."""
    from concurrent.futures import ThreadPoolExecutor

    from fmdm_tpu_torch.scripts import deepcache_quality_frontier as frontier
    from fmdm_tpu_torch.scripts import flagship_quality_sweep as sweep
    from fmdm_tpu_torch.scripts import int8_quality_eval

    train_cases, test_cases, depth = QUALITY_CASES
    log(f"[37] the quality workflow: flagship_quality_sweep over {train_cases} train and "
        f"{test_cases} test phantom cases of {depth} slices, both variants 1 epoch, flowmatch "
        f"and ddpm at {QUALITY_STEPS} steps on {QUALITY_SAMPLES} samples; then int8 and "
        f"DeepCache {QUALITY_DEEP_CACHE} on its flow run dir")
    root = work / "quality"
    start = time.perf_counter()
    text, secs = in_subprocess(
        "fmdm_tpu_torch.scripts.flagship_quality_sweep",
        ["--root", str(root), "--epochs", "1", "--train-cases", str(train_cases),
         "--test-cases", str(test_cases), "--depth", str(depth), "--aliases", "flowmatch,ddpm",
         "--num-samples", str(QUALITY_SAMPLES), "--steps", str(QUALITY_STEPS), "--jobs", "2"],
        "the quality sweep")
    sweep_rows = table_rows(text, "| sampler |")
    check_quality_rows("flagship_quality_sweep", sweep_rows, ["flowmatch", "ddpm"])
    log(f"  flagship_quality_sweep: exit 0, wall {secs:.2f} s; " + "; ".join(
        f"{name} PSNR {cells[0]} SSIM {cells[1]} samples/s {cells[2]}"
        for name, cells in sweep_rows.items()) + f" [{card}]")
    (flow_run,) = root.glob("run_flow_matching_run*")
    kw = dict(num_samples=QUALITY_SAMPLES, steps=QUALITY_STEPS)
    with contextlib.redirect_stdout(sys.stderr), ThreadPoolExecutor(2) as pool:
        int8 = pool.submit(int8_quality_eval.evaluate, flow_run, [("flowmatch", "int8", None)],
                           root=root, **kw)
        cached = pool.submit(frontier.frontier, flow_run, root / "deepcache",
                             scheduler="flowmatch", variants=[QUALITY_DEEP_CACHE], **kw)
        int8_rows, cached_rows = int8.result(), cached.result()
    int8_table = table_rows(sweep.format_table(int8_rows), "| sampler |")
    cached_table = table_rows(frontier.format_frontier(cached_rows), "| deep_cache |")
    check_quality_rows("int8_quality_eval", int8_table, ["flowmatch_int8"])
    check_quality_rows("deepcache_quality_frontier", cached_table,
                       [QUALITY_DEEP_CACHE.replace(":", "_")])
    for name, cells in {**int8_table, **cached_table}.items():
        log(f"  {name}: PSNR {cells[0]} SSIM {cells[1]} model samples/s {cells[2]}")
    log(f"  [37] wall {time.perf_counter() - start:.2f} s (the sweep {secs:.2f} s) [{card}]")


@contextlib.contextmanager
def long_attention(edit):
    """Every self-attention call of ``nn.blocks`` at 512 tokens or more (the
    ring's calls under [36c]'s routing) returns ``edit(q, k, v, out)``."""
    from fmdm_tpu_torch.nn import blocks

    real = blocks.sdpa

    def sdpa(q, k, v, **kwargs):
        out = real(q, k, v, **kwargs)
        return edit(q, k, v, out) if q.shape[-2] >= 512 else out

    blocks.sdpa = sdpa
    try:
        yield
    finally:
        blocks.sdpa = real



def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batches", default="8,32",
                        help="sample batch sizes; the first one's run counts the launches")
    parser.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dp-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--par-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    batches = [int(b) for b in args.batches.split(",")]
    if args.dp_rank is not None or args.par_rank is not None:
        # [35b]'s or [36b]'s second rank, started by the main run
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 1
        if args.par_rank is not None:
            return par_worker(args.par_rank, args.dp_port, args.seed)
        return dp_worker(args.dp_rank, args.dp_port, args.seed)

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
    k1 = phase_k1(torch, card, gen, torch.Generator().manual_seed(args.seed + 1), batches[0])
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

    # 2 steps (3 until [16b]): the second is DPM++'s second-order update
    log("[6] the sampling loop: first 2 DPM++ steps, f32, batch 1, card vs CPU plain path")
    shape = (1, 1, 256, 256)
    init = torch.randn(shape, generator=gen)
    cond = torch.full(shape, 0.5)
    short = [SamplingEngine(m, scheduler, timesteps[:2], conditioning_mode="concatenate",
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
    exact_rates = {}
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
        exact_rates[batch] = batch * NUM_STEPS / secs
        log(f"  batch {batch}: {secs:.4f} s, {batch * NUM_STEPS / secs:.2f} denoise steps/s, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches K1 {launches[0]} "
            f"K2 {launches[1]}, output mean {float(out.mean()):.4f} std {float(out.std()):.4f} [{card}]")

    k3 = phase_k3(torch, card, gen, torch.Generator().manual_seed(args.seed + 3), library_kernels)
    k4, k5 = phase_k4_k5(torch, card, gen)
    phase_mmdit_flash(torch, card, args.seed)
    all_records = (K1, K2, K3, K4, K5)
    train_counts, vae_k1_calls = phase_vae(torch, card, args.seed, gen, all_records)
    vae_batch = int(json.loads(VAE_CONFIG.read_text())["training"]["batch_size"])

    log("[13] K1 over the recorded calls of one flagship forward and one VAE reconstruct")
    # the replayed calls' inputs are drawn on the card: the CPU's generator is slow at this size
    k1_gen = torch.Generator("cuda").manual_seed(args.seed + 13)
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
    train_state = phase_denoise(torch, card, args.seed, gen, all_records)
    denoise_counts = train_state["counts"]
    phase_schedulers(torch, gen)
    with tempfile.TemporaryDirectory() as tmp:
        decode_counts = phase_decode(torch, card, args.seed, gen, all_records, Path(tmp))
        cli_counts = phase_run_model(torch, card, args.seed, all_records, Path(tmp))
        train_loop_counts = phase_train(torch, card, args.seed, all_records, Path(tmp))
        phase_efficient_forward(torch, card, args.seed, gen, all_records)
        efficient_counts = phase_efficient_train(torch, card, args.seed, gen, all_records,
                                                 batches[0], scheduler, timesteps)
        deep_cache_counts = phase_deep_cache(torch, card, args.seed, gen, all_records, model,
                                             scheduler, timesteps, batches[0],
                                             exact_rates[batches[0]])
        phase_clis(card, Path(tmp))
        volume_counts = phase_volumes(torch, card, args.seed, all_records, scheduler, timesteps)
        k1b = phase_k1b(torch, card, args.seed, [
            ("flagship train step", flagship_k1_calls, FLOW_TRAIN_BATCH, torch.bfloat16),
            ("3D train step", volume_counts["k1_calls"], VOLUME_TRAINING["train_batch_size"],
             torch.bfloat16),
            ("VAE train step", vae_k1_calls, vae_batch, torch.float32)])
        vq_counts = phase_vq(torch, card, args.seed, gen, all_records)
        loss_counts = phase_losses(torch, card, args.seed, gen, all_records)
        vae_cli = phase_vae_clis(torch, card, args.seed, all_records, Path(tmp))
        chain_counts = phase_latent_chain(torch, card, args.seed, all_records, Path(tmp),
                                          vae_cli["run"], vae_cli["latents"])
        gan_counts = phase_gan(torch, card, args.seed, gen, all_records, Path(tmp))
        int8_counts = phase_int8(torch, card, args.seed, gen, all_records, Path(tmp))
        phase_rmsnorm(torch, card, gen)
        pending_counts = phase_checkpoints(torch, card, args.seed, all_records, train_state,
                                           Path(tmp))
        del train_state
        dp_counts = phase_torchrun(torch, card, args.seed, all_records, Path(tmp))
        phase_quality_tools(card, Path(tmp))
    dp_counts.update(phase_gloo_ranks(torch, card, args.seed, all_records))
    dp_counts.update(phase_split_engines(torch, card, args.seed, all_records))
    ring = phase_ring(torch, card, args.seed, all_records)
    par_counts = phase_par_ranks(torch, card, args.seed, all_records)
    seq_counts = phase_seq_engines(torch, card, args.seed, all_records)

    k1["launches"], k2["launches"] = main_launches
    k3["launches"], k4["launches"], k5["launches"] = (train_counts[k] for k in ("K3", "K4", "K5"))
    # each path's launches, counted from 0 over its run: the sample's, and
    # the TRAIN_STEPS timed steps of each train step
    k1b["launches"] = denoise_counts["K1B"]
    sample_counts = {"K1": main_launches[0], "K2": main_launches[1]}
    for kernel, r in (("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4), ("K5", k5), ("K1B", k1b)):
        r["launches_by_path"] = {
            f"{NUM_STEPS}-step sample, batch {batches[0]}": sample_counts.get(kernel, 0),
            f"flagship train step x {TRAIN_STEPS}": denoise_counts[kernel],
            f"VAE train step x {TRAIN_STEPS}": train_counts[kernel],
            f"decode from a run dir, {len(DECODE_RUNS) + 1} runs at batch {DECODE_BATCH}":
                decode_counts.get(kernel, 0),
            f"run_model evaluate in process, batch {DECODE_BATCH} and 1": cli_counts.get(kernel, 0),
            "training from a config in process, 1 epoch of the DDPM and VAE loops":
                train_loop_counts.get(kernel, 0),
            f"EfficientUNet (compvis) train step x {TRAIN_STEPS}":
                efficient_counts["train"].get(kernel, 0),
            f"EfficientUNet (compvis) {NUM_STEPS}-step sample, batch {batches[0]}":
                efficient_counts["sample"].get(kernel, 0),
            f"3D EfficientUNet train step x {TRAIN_STEPS}, bf16, batch "
            f"{VOLUME_TRAINING['train_batch_size']}": volume_counts["train"].get(kernel, 0),
            f"3D EfficientUNet {NUM_STEPS}-step sample, bf16, batch {VOLUME_SAMPLE_BATCH}":
                volume_counts["sample"].get(kernel, 0),
            f"DeepCache '3:1:adaptive' {NUM_STEPS}-step sample, batch {batches[0]}":
                deep_cache_counts.get(kernel, 0),
            f"VQ-VAE (EMA) train step x {TRAIN_STEPS}": vq_counts.get(kernel, 0),
            f"KL-VAE perceptual train step x {TRAIN_STEPS}": loss_counts.get(kernel, 0),
            f"VAE run_model evaluate in process, batch {DECODE_BATCH}":
                vae_cli["launches"].get(kernel, 0),
            f"latent chain evaluate --latent_vae, batch {DECODE_BATCH}":
                chain_counts.get(kernel, 0),
            f"GAN train step ({GAN_CONFIG.name}) x {TRAIN_STEPS}": gan_counts.get(kernel, 0),
            f"int8 decode, {INT8_STEPS} DPM++ steps at batch {DECODE_BATCH}":
                int8_counts.get(kernel, 0),
            f"flagship train step x {TRAIN_STEPS} beside a pending async checkpoint write":
                pending_counts.get(kernel, 0),
            f"run_model evaluate of a DCP run dir, data-parallel sampling on, batch {DECODE_BATCH}":
                dp_counts["evaluate"].get(kernel, 0),
            "flagship train step over 2 gloo ranks, 2 rows per rank (rank 0)":
                dp_counts["flagship"].get(kernel, 0),
            "KL-VAE GAN train step over 2 gloo ranks, 1 row per rank (rank 0)":
                dp_counts["KL-VAE GAN"].get(kernel, 0),
            "VQ-VAE EMA train step over 2 gloo ranks, 1 row per rank (rank 0)":
                dp_counts["VQ-VAE EMA"].get(kernel, 0),
            "3-step DPM++ sample at batch 4 split over 2 shards on the card":
                dp_counts["sample split"].get(kernel, 0),
            "VAE reconstruct at batch 3 split over 2 shards on the card":
                dp_counts["reconstruct split"].get(kernel, 0),
            f"ring attention forward + backward over {SP_RANKS} shards of the card, "
            f"{RING_SHAPE} f32": ring["counts"].get(kernel, 0),
            **{f"{what} train step over {SP_RANKS} gloo ranks (rank 0)": c.get(kernel, 0)
               for what, c in par_counts.items()},
            f"KL-VAE reconstruct at batch 2 over a (data 1, seq {SP_RANKS}) mesh of the card":
                seq_counts["reconstruct"].get(kernel, 0),
            f"3-step DPM++ sample at batch 2 over a (data 1, seq {SP_RANKS}) mesh, min_tokens "
            f"{SEQ_ENGINE_MIN_TOKENS}": seq_counts["sample"].get(kernel, 0)}
    for r in (k3, k4, k5):
        kernel = r["name"].split()[0]
        r["ring_hop"] = {"shape": [RING_SHAPE[0], RING_SHAPE[1], RING_SHAPE[2] // SP_RANKS,
                                   RING_SHAPE[3]], "dtype": "float32",
                         "ms": ring["ms"][f"{kernel} hop"],
                         "bound_ms": ring["hop_bounds"][f"{kernel} hop"],
                         "max_abs_err": ring["max_abs_err"][kernel]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "bound_term", "library_ms", "shape", "dtype")
    extra = ("library_kernel", "variants", "per_forward", "per_step", "launches_by_path",
             "ring_hop")
    ends = [s for _, s in PHASE_STARTS[1:]] + [time.perf_counter()]
    log("seconds per phase: " + ", ".join(f"{label} {end - start:.1f}" for (label, start), end
                                          in zip(PHASE_STARTS, ends)))
    log(f"whole run: {time.perf_counter() - run_start:.1f} s")
    log(json.dumps({"kernels": [{**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
                                for r in (k1, k2, k3, k4, k5, k1b)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
