"""
Build and load the port's CUDA kernels.

Every ``fmdm_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together), then linked into ONE shared
library with a plain C interface under ``<repo>/build/kernels/``. The library
is loaded with ``ctypes``; each kernel module declares its function's
``argtypes`` (``c_void_p`` for pointers and the stream). The file name carries
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. The build reads only sources in this repository,
and a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class KernelRecord:
    """What a kernel is and how often its wrapper launched it.

    ``launches`` is a plain integer that the wrapper increments where it
    launches the kernel and nowhere else; a run resets it to 0 and reads it
    back to show that its path went through the kernel. A kernel with
    variants also counts its device launches per variant in ``variants``."""

    name: str
    source: str     # CUDA source, relative to the repository root
    replaces: str   # the TPU kernel it replaces, file:line
    launches: int = 0
    variants: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.launches = 0
        for key in self.variants:
            self.variants[key] = 0


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float   # 0.0 when a cached library was reused
    log: str         # nvcc/ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _sources() -> List[Path]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands concurrently; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(outputs)


@functools.lru_cache(maxsize=1)
def build() -> BuildInfo:
    """Compile the kernels into ``build/kernels/`` unless an up-to-date
    library is already there."""
    sources = _sources()
    lib_path = BUILD_DIR / f"libfmdm_kernels_{_digest(sources)}.so"
    if lib_path.exists():
        return BuildInfo(lib_path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources, objects)])
        staged = Path(tmp) / lib_path.name
        log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                          *map(str, objects), "-o", str(staged)]])
        os.replace(staged, lib_path)
    return BuildInfo(lib_path, time.perf_counter() - start, log)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build().path))
    lib.fmdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fmdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_status(status: int, name: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error code
    (``cudaGetLastError`` right after its launch)."""
    if status != 0:
        reason = library().fmdm_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {reason}")


# Grid dimension y (one block row per group or head) is at most 65535.
MAX_GRID_Y = 65535
