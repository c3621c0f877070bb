"""``self_attention_ms.train``: device ms per train step inside the spans
``mmdit.self_attention`` of the forward, the image-only second attention of
MMDiT-X's dual blocks (projections, RMSNorms, K3, output projection);
between each span's two CUDA events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("mmdit.self_attention",))
