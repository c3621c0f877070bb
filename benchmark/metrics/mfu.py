"""``mfu.train`` / ``mfu.sample``: the whole step's share of the chip's bf16
peak. FLOPs of the products (convolutions, linears, attention) counted on
the reference's shapes at the cell's batch (a train step: the forward and
what its backward needs, nothing recomputed), times the units of the
untraced window (the one the end-to-end metrics read, so the profiler's
own cost is not in it), over that window's seconds and the published
peak."""

from benchmark import counters, peaks


def read(r):
    if r.timed_units <= 0 or r.timed_s <= 0:
        return None
    work = counters.flops(r.ops, r.train) * r.forwards_per_unit * r.timed_units
    return 100.0 * work / r.timed_s / peaks.PRODUCT_FLOPS[r.dtype]
