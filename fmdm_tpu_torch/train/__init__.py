"""Training steps (counterpart of ``fmdm_tpu/train``)."""
