"""Utilities (counterpart of ``fmdm_tpu/utils``)."""
