"""
The quality workflow of the port (counterpart of the JAX package's
``scripts/flagship_quality_sweep.py`` and the tools beside it). Each tool
runs as ``python -m fmdm_tpu_torch.scripts.<name>`` and drives the port's
CLIs in subprocesses, as its JAX counterpart drives ``train.py`` and
``run_model.py``:

- ``flagship_quality_sweep``: a synthetic LDCT phantom set, the two flagship
  configs trained, ``evaluate`` per sampler alias, a markdown table;
- ``r4_pipeline``: the restart-safe driver over those stages, state under
  ``.scratch/torch_r4/``;
- ``convergence_curve``: ``evaluate`` over a run's epoch snapshots;
- ``deepcache_quality_frontier``: ``evaluate`` under DeepCache settings;
- ``int8_quality_eval``: ``evaluate`` in bf16 and int8, with DeepCache;
- ``latent_diffusion_sweep``: a KL-VAE, its latents, a latent denoiser,
  ``evaluate --latent_vae``.

Every tool takes ``--device``, which it passes on: the card unless it says
``cpu``.
"""
