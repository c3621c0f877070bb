"""
fmdm_tpu_torch — the PyTorch/CUDA port of ``fmdm_tpu`` for NVIDIA Hopper.

The module layout mirrors ``fmdm_tpu`` so each counterpart is easy to find
(``fmdm_tpu/ops/norm.py`` -> ``fmdm_tpu_torch/ops/norm.py`` ...). Parameter
names reproduce the JAX trees' dotted paths, so ``state_dict()`` keys equal
``fmdm_tpu.nn.module.flatten_params(params)`` keys one for one.

The package imports ``torch`` only: never ``jax`` and nothing of ``fmdm_tpu``.
Entry points default to the CUDA device and raise when it is absent unless the
caller asks for ``device="cpu"`` (see :mod:`fmdm_tpu_torch.device`). The
Pallas kernels of the JAX package are hand-written CUDA C++ kernels here
(``csrc/``), built with ``nvcc`` on first use (``ops/kernels/build.py``).
"""
