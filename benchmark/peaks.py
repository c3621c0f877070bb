"""
Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Every roofline and every
``mfu`` of the benchmark is taken against these, never against a measured
or assumed rate.
"""

BF16_FLOPS = 989e12       # bf16 / fp16 tensor cores
F32_FLOPS = 67e12         # f32 outside the tensor cores
HBM_BYTES = 3.35e12       # HBM3 bytes per second

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
PRODUCT_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS, "float32": F32_FLOPS}
