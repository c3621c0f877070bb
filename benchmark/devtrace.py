"""
Readings of a ``torch.profiler`` trace of the measured window: device time
by kernel name and by class, the device's busy time (the union of its
kernel and copy intervals, so overlapping streams count once), and the
breakdown the result line carries (the kernels that took most time, and the
longest idle gaps of the device by what the host was doing).

``device_busy_s`` and ``classify`` are copied from the program's
``sample/profile_sample.py`` (``device_busy_ms``, ``classify``), so that a
change to the program cannot change them. Classes go by fragments of the
kernel's name, first match wins; the benchmark's tests pin them on names
seen on the H100.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

CLASSES = (
    ("K1 group_norm_act", ("gn_cluster", "gn_stats", "gn_apply")),
    ("K2 small_t_attention", ("small_t_attention",)),
    ("K3 flash_forward", ("flash_fwd",)),
    ("K4 flash_backward_dkv", ("flash_bwd_dkv",)),
    ("K5 flash_backward_dq", ("flash_bwd_dq",)),
    ("elementwise and copies", ("elementwise_kernel", "CatArray", "Memcpy", "Memset")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit", "nchwToNhwc", "nhwcToNchw",
                     "xmma", "cudnn", "fft", "pointwise_mult_and_sum_complex", "region_transform")),
    ("matrix product", ("gemm", "cublas", "cutlass", "nvjet")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "cat_", "fill", "reduce",
                                "index")),
)
FLASH = ("K3 flash_forward", "K4 flash_backward_dkv", "K5 flash_backward_dq")
NAME_CHARS = 160   # a kernel's name as the breakdown gives it
HOST_DEPTH = 8     # host events before a gap's middle searched for one around it


def classify(name: str) -> str:
    lowered = name.lower()
    for label, fragments in CLASSES:
        if any(f.lower() in lowered for f in fragments):
            return label
    return "other"


def _is_device(event) -> bool:
    import torch

    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


class Trace:
    """The device and host events of one finished profile."""

    def __init__(self, prof):
        import torch

        self.device: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for e in prof.events():
            span = (float(e.time_range.start), float(e.time_range.end), e.name)
            if _is_device(e):
                self.device.append(span)
            elif e.device_type == torch.autograd.DeviceType.CPU:
                self.host.append(span)
        self.device.sort()

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for start, end, name in self.device:
            out[name] += (end - start) / 1e6
        return dict(out)

    def class_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s in self.kernel_seconds().items():
            out[classify(name)] += s
        return dict(out)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for start, end, _ in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def device_busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def breakdown(self, window_s: float, top: int = 10) -> dict:
        """``device_ops``: the ``top`` kernels by device seconds;
        ``idle_gaps``: the device's idle seconds between kernels by the
        innermost host event running at each gap's middle ("host idle"
        where none runs: Python and PyTorch's dispatch between launches),
        and "window edges" before the first kernel and after the last."""
        kernels = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        idle: Dict[str, float] = defaultdict(float)
        if len(busy) > 1:
            gap0 = np.array([b for (_, b) in busy[:-1]])
            gap1 = np.array([a for (a, _) in busy[1:]])
            mids = 0.5 * (gap0 + gap1)
            label = np.full(mids.shape, -1)
            best = np.full(mids.shape, np.inf)
            if self.host:
                host = sorted(self.host)
                starts = np.array([h[0] for h in host])
                ends = np.array([h[1] for h in host])
                last = np.searchsorted(starts, mids, side="right") - 1
                for back in range(HOST_DEPTH):
                    idx = last - back
                    ok = idx >= 0
                    idx = np.where(ok, idx, 0)
                    span = ends[idx] - starts[idx]
                    hit = ok & (ends[idx] >= mids) & (span < best)
                    label = np.where(hit, idx, label)
                    best = np.where(hit, span, best)
            for i, seconds in zip(label.tolist(), ((gap1 - gap0) / 1e6).tolist()):
                idle[host[i][2][:NAME_CHARS] if i >= 0 else "host idle"] += seconds
            edges = window_s - (busy[-1][1] - busy[0][0]) / 1e6
            if edges > 0:
                idle["window edges"] += edges
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in kernels],
                "idle_gaps": [[n, s] for n, s in gaps_top]}
