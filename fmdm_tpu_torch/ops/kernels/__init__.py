"""
Hand-written Hopper kernels that replace the JAX package's Pallas kernels.

Each kernel module holds the wrapper (launch on a CUDA tensor, plain PyTorch
version on a CPU tensor, nothing else), the plain version itself, and a
:class:`~fmdm_tpu_torch.ops.kernels.build.KernelRecord` with its launch count.
The CUDA sources live in ``fmdm_tpu_torch/csrc``; ``build.py`` compiles them.
"""
