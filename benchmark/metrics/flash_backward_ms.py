"""``flash_backward_ms.train``: device ms per train step inside the spans
``flash.backward``, the flash attention's backward (delta, then K4 and K5),
one span per call of the forward's flash kernels, opened on autograd's
device thread; between each span's two CUDA events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("flash.backward",))
