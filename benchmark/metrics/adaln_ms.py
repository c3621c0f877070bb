"""``adaln_ms.train``: device ms per train step inside the spans
``mmdit.adaln`` of the forward, one per LayerNorm of either stream with its
modulation ``LN(x) (1 + scale) + shift``; between each span's two CUDA
events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("mmdit.adaln",))
