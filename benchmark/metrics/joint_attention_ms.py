"""``joint_attention_ms.train``: device ms per train step inside the spans
``mmdit.joint_attention`` of the forward, one per MMDiT block: both
streams' q, k, v projections, their RMSNorms, the concatenation, the
attention over image and text tokens (K3 on the card), the split and the
output projections; between each span's two CUDA events."""

from benchmark.metrics import program_spans


def read(r):
    return program_spans.ms_per_unit(r, ("mmdit.joint_attention",))
