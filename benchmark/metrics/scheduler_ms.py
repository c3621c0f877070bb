"""``scheduler_ms.sample``: device ms per denoise step inside the span
``sample.scheduler`` (the sampler's own arithmetic on the f32 sample),
between the span's two CUDA events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("sample.scheduler",), per_step=True)
