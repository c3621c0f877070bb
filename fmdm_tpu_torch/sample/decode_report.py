"""
The flagship's f32 forward, the model call of ``decode_diffusion_batch``, per
batch size and per cuDNN setting, on one CUDA card.

    python -m fmdm_tpu_torch.sample.decode_report [--batches 1,2,3,4,6,8] [--seed 0]

Builds the flagship (``model.unet`` of ``configs/LDCT/LDCT_ddpm_diffusers_nd.json``,
concatenate conditioning, weights from ``--seed``) in f32 with TF32 off, as
the decode path samples, and prints for each batch the device time of one
forward (CUDA events, the mean of 3 after a warm-up), its peak memory, and
the number and name of the device kernels the largest share of its time
goes to (one ``torch.profiler`` pass). At batch 4, ``run_model``'s default,
it also times the forward under ``torch.backends.cudnn.deterministic``,
under ``torch.backends.cudnn.benchmark`` and as two forwards of batch 2,
each of which lets cuDNN choose its convolution algorithms otherwise. The
card's name and power limit are printed beside every number, and one JSON
line holds them all.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
from collections import Counter
from pathlib import Path

import torch

from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn.layers import init_weights

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "LDCT" / "LDCT_ddpm_diffusers_nd.json"
TIMED = 3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def forward_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIMED


def top_kernels(fn, count: int = 3):
    """(kernel launches, [(name, ms, launches)] of the ``count`` kernels with
    the most device time) over one call of ``fn``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times, calls = Counter(), Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            times[e.key] += e.self_device_time_total / 1e3
            calls[e.key] += e.count
    return sum(calls.values()), [(name[:80], round(ms, 3), calls[name])
                                 for name, ms in times.most_common(count)]


@contextlib.contextmanager
def cudnn_flags(**flags):
    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", default="1,2,3,4,6,8")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg = json.loads(CONFIG.read_text())["model"]["unet"]
    model = DiffusionUNetFactory().build(cfg, conditioning="concatenate", channels=1, device="cuda")
    init_weights(model, torch.Generator().manual_seed(args.seed)).eval()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    rows = []

    def inputs(batch):
        return (torch.randn((batch, 2, 256, 256), generator=gen, device="cuda"),
                torch.full((batch,), 500, device="cuda", dtype=torch.int32))

    with torch.no_grad():
        for batch in (int(b) for b in args.batches.split(",")):
            x, t = inputs(batch)
            torch.cuda.reset_peak_memory_stats()
            ms = forward_ms(lambda: model(x, t))
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches, top = top_kernels(lambda: model(x, t))
            rows.append(dict(what=f"batch {batch}", batch=batch, ms=ms, peak_gib=peak,
                             launches=launches, top=top))
            print(f"batch {batch}: forward {ms:.2f} ms ({ms / batch:.2f} ms per image), peak "
                  f"{peak:.2f} GiB, {launches} kernel launches; most time: {top} [{card}]",
                  flush=True)
        x, t = inputs(4)
        variants = (("cudnn.deterministic", dict(deterministic=True), lambda: model(x, t)),
                    ("cudnn.benchmark", dict(benchmark=True), lambda: model(x, t)),
                    ("two forwards of batch 2", {},
                     lambda: (model(x[:2], t[:2]), model(x[2:], t[2:]))))
        for label, flags, fn in variants:
            with cudnn_flags(**flags):
                torch.cuda.reset_peak_memory_stats()
                ms = forward_ms(fn)
                peak = torch.cuda.max_memory_allocated() / 2**30
                launches, top = top_kernels(fn)
            rows.append(dict(what=f"batch 4, {label}", batch=4, ms=ms, peak_gib=peak,
                             launches=launches, top=top))
            print(f"batch 4, {label}: {ms:.2f} ms, peak {peak:.2f} GiB, {launches} kernel "
                  f"launches; most time: {top} [{card}]", flush=True)
    print(json.dumps({"card": card, "dtype": "float32", "tf32": False, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
