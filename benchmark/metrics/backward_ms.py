"""``backward_ms.train``: device ms per train step inside the span
``train.backward`` (each chunk's ``.backward()``, K1's and K2's plain
backwards included), between the span's two CUDA events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("train.backward",))
