"""
The default-device rule of the port's entry points.

``device=None`` means CUDA. When no CUDA device is present that raises: an
entry point never falls back to the CPU on its own. The CPU is used only when
the caller names it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceArg = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceArg = None) -> torch.device:
    """Resolve an entry point's ``device`` argument (``None`` -> ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fmdm_tpu_torch: no CUDA device is available. Pass device='cpu' "
            "explicitly to run the plain PyTorch path on the CPU.")
    return dev
