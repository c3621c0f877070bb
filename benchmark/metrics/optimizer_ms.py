"""``optimizer_ms.train``: device ms per train step inside the span
``train.optimizer`` (the rate set and AdamW's ``step()`` over every
parameter), between the span's two CUDA events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("train.optimizer",))
