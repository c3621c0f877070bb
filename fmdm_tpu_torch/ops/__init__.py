"""Tensor primitives (counterpart of ``fmdm_tpu/ops``)."""
