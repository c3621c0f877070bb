"""``k1_backward_ms.train``: device ms per train step inside the spans
``k1.backward``, K1's plain backward (the plain GroupNorm forward recomputed
in f32, then its autograd), one span per K1 call of the forward, opened on
autograd's device thread; between each span's two CUDA events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("k1.backward",))
