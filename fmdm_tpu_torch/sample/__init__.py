"""Sampling (counterpart of ``fmdm_tpu/sample``)."""
