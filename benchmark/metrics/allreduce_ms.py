"""``allreduce_ms.train``: device ms per train step inside the span
``train.allreduce``, the gradients' sum over the ranks (one all-reduce of a
flat buffer per dtype, and the copies in and out), on the traced rank;
between the span's two CUDA events, so it holds the rank's wait for the
slowest rank's gradients too."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("train.allreduce",))
