"""``forward_ms.train``: device ms per train step inside the span
``train.forward`` (each chunk's loss: the noising, the model's forward, the
loss), between the span's two CUDA events: its kernels and any idle among
them."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("train.forward",))
