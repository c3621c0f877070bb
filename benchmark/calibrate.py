"""
The readings that the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control 3]

For every seed: the program's compared numbers as a run reads them (its
set-up, for a sample cell one window call, the reference), and for the
first ``--control`` seeds the same numbers of

- ``control``: the reference in fp8 e4m3 put in the program's place, one
  precision below the bf16 the configuration states;
- ``half_batch`` (train cells): the reference fed half of each batch, the
  mean taken over that half;
- ``unchanged`` (train cells): a step that leaves the weights as they were
  (its change is 0, so ``change_gap`` reads 1; no run needed).

One JSON line per seed and a summary line: per number the largest program
reading and the smallest of each fault. The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    import gc

    import torch

    from benchmark import compare, harness

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--detail", action="store_true",
                        help="train cells: each step's loss gap and the worst parameters")
    args = parser.parse_args(argv)
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    entry_class = bench.entry(cell["entry"])
    rows = []
    for i, seed in enumerate(args.seeds):
        start = time.perf_counter()
        entry = entry_class(cfg, cell, seed, "cuda")
        entry.setup()
        if entry.kind == "sample":
            entry.window(units=1)
        entry.release()
        out = {"seed": seed}
        if entry.kind == "train":
            ref = entry.reference_readings()
            out["program"] = compare.train_numbers(entry.readings, ref)
            out["all_steps_loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(
                entry.readings["losses"], ref["losses"]))
            out["all_leaves_grad_gap"] = compare.worst_leaves(
                entry.readings["first_grad"], ref["first_grad"], ref["first_grad"], 1)[0][0]
            if args.detail:
                out["loss_gaps"] = [abs(a - b) / abs(b) for a, b in
                                    zip(entry.readings["losses"], ref["losses"])]
                out["grad_leaves"] = compare.worst_leaves(entry.readings["first_grad"],
                                                          ref["first_grad"], ref["first_grad"])
                out["change_leaves"] = compare.worst_leaves(entry.readings["change"],
                                                            ref["change"], ref["change"])
                out["median_grad"] = compare.median(ref["first_grad"].values())
            if i < args.control:
                out["control"] = compare.train_numbers(entry.reference_readings("fp8"), ref)
                out["half_batch"] = compare.train_numbers(
                    entry.reference_readings(half_batch=True), ref)
                still = dict(entry.readings, change={k: 0.0 for k in ref["change"]})
                out["unchanged"] = compare.train_numbers(still, ref)
        else:
            call, judged = entry.judged()
            ref = entry.reference_rows(call, judged)
            out["program"] = compare.sample_numbers(entry.calls[call][2][judged], ref)
            if i < args.control:
                out["control"] = compare.sample_numbers(
                    entry.reference_rows(call, judged, "fp8"), ref)
        out["seconds"] = time.perf_counter() - start
        print(json.dumps(out), flush=True)
        rows.append(out)
        del entry
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for kind in ("program", "control", "half_batch", "unchanged"):
        got = [r[kind] for r in rows if kind in r]
        if got:
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
