"""
The benchmark of ``fmdm_tpu_torch`` on one NVIDIA H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last the
compared numbers with their limits (``checks``), which also close standard
error. Exits non-zero with no result when the card is missing, when the
program is missing, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)   # the checkout's root, not benchmark/, heads the path
# the caches a kernel build of the program may keep (its CUDA library builds
# into build/kernels/; a Triton or extension kernel would use these), at
# fixed paths inside the checkout, so that only a checkout's first run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / "cache" / sub))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from benchmark import harness

    return harness.main(ROOT, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
