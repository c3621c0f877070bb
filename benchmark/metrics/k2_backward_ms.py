"""``k2_backward_ms.train``: device ms per train step inside the spans
``k2.backward``, K2's plain backward (the plain attention recomputed in f32,
then its autograd), one span per K2 call of the forward; between each
span's two CUDA events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("k2.backward",))
