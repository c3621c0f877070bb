"""Models and factories (counterpart of ``fmdm_tpu/models``)."""
