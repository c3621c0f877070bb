"""Layers and blocks (counterpart of ``fmdm_tpu/nn``)."""
