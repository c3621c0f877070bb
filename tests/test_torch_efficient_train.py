"""The port's EfficientUNetND in training against the JAX package's, on the
CPU in f32: the denoise train step with JAX's noise and t replayed (loss,
count, every gradient and the AdamW update, held as
``tests/test_torch_denoise_train.py`` holds the flagship's), and ``python -m
fmdm_tpu_torch.train`` / ``run_model --mode evaluate`` with ``--device cpu``
on the LDCT compvis config cut to a reduced EfficientUNet at 16².
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.schedulers import DDPMScheduler as JaxDDPM
from fmdm_tpu.train.common import make_denoise_train_step as jax_make_step
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.schedulers import DDPMScheduler
from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step
from tests.test_torch_denoise_train import (  # noqa: F401
    LR, SCHED, TOTAL, WARMUP, WD, _assert_grads_match, _batch, _gradient_reader, _jax_batch,
    _torch_batch, _tree, few_torch_threads, jax_draws)
from tests.test_torch_efficient_unet import REDUCED
from tests.test_torch_models import _pair
from tests.test_torch_train_cli import write_ldct_root

REPO = Path(__file__).resolve().parents[1]
LDCT_COMPVIS = REPO / "configs" / "LDCT" / "LDCT_ddpm_compvis.json"

# at the 32² of the denoise tests' draws, GroupNorm groups of 2 channels
TRAIN_UNET = {"unet_impl": "efficient_nd", "model_channels": 64, "num_res_blocks": 1,
              "channel_mult": [1, 2], "attention_resolutions": [2], "num_heads": 2,
              "dim_head": 16}


@pytest.mark.parametrize("conditioning", ["concatenate", "attention"])
def test_train_step_matches_jax(conditioning):
    """Two DDPM steps at batch 3 (the middle row masked), JAX's noise and t
    replayed: loss, count, every gradient (the FiLM projections
    ``emb_layers`` included) and the AdamW update, as
    ``tests/test_torch_denoise_train.py`` holds the flagship's."""
    import optax

    from fmdm_tpu.train.common import make_adamw as jax_make_adamw

    jm = JaxFactory().build(TRAIN_UNET, conditioning=conditioning, channels=1)
    tm = DiffusionUNetFactory().build(TRAIN_UNET, conditioning=conditioning, channels=1,
                                      device="cpu")
    _, tm = _pair(jm, tm, seed=14)
    tm.train()
    jstep = jax_make_step(jm, JaxDDPM.create(**SCHED), _gradient_reader(), variant="diffusion",
                          conditioning_mode=conditioning, latent_norm=None)
    optimizer, schedule = make_adamw(tm.parameters(), LR, WD, WARMUP, TOTAL)
    step = make_denoise_train_step(tm, DDPMScheduler.create(**SCHED), optimizer, schedule,
                                   variant="diffusion", conditioning_mode=conditioning,
                                   latent_norm=None, device="cpu")
    adamw, _ = jax_make_adamw(LR, WD, WARMUP, TOTAL)
    opt_state = adamw.init(_tree(tm.named_parameters()))
    for i in range(2):
        batch = _batch(15 + i, [1.0, 0.0, 1.0])
        rng = jax.random.PRNGKey(16 + i)
        before = _tree(tm.named_parameters())
        reader = _gradient_reader()
        _, state, want_sum, want_count = jstep(_tree(tm.named_parameters()), reader.init(before),
                                               _jax_batch(batch), rng)
        noise, t = jax_draws(rng, "diffusion", 3, 1, 1000)
        got_sum, got_count = step.step(_torch_batch(batch), noise=torch.from_numpy(noise),
                                       t=torch.from_numpy(t))
        assert float(got_count) == float(want_count) == 2.0
        assert float(got_sum) == pytest.approx(float(want_sum), rel=1e-5)
        _assert_grads_match(tm, state["g"])
        assert all(float(p.grad.abs().max()) > 0 for n, p in tm.named_parameters()
                   if "emb_layers" in n)
        grads = unflatten_params({n: jnp.asarray(p.grad.numpy().copy())
                                  for n, p in tm.named_parameters()})
        updates, opt_state = adamw.update(grads, opt_state, before)
        want = flatten_params(optax.apply_updates(before, updates))
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _module_cli(module, *args):
    return subprocess.run([sys.executable, "-m", module, *map(str, args)], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)


def test_train_and_evaluate_clis_on_a_reduced_compvis_config(tmp_path):
    """The LDCT compvis DDPM config cut to REDUCED at 16²: one epoch of
    ``python -m fmdm_tpu_torch.train --device cpu``, then ``run_model --mode
    evaluate --device cpu`` on its run dir; the JAX package loads the
    port's checkpoint into its own EfficientUNetND."""
    root = write_ldct_root(tmp_path / "data")
    cfg = json.loads(LDCT_COMPVIS.read_text())
    cfg["model"]["unet"] = dict(REDUCED)
    cfg["model"]["scheduler"]["num_inference_steps"] = 2
    cfg["training"].update(data_root=str(root), output_dir=str(tmp_path / "run"), img_size=16,
                           num_workers=0, use_tensor_cache=False, seed=5, num_epochs=1,
                           num_inference_steps=2, train_batch_size=4, batch_size=4,
                           lr_warmup_steps=2)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = _module_cli("fmdm_tpu_torch.train", "--config", path, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    run = tmp_path / "run_run1"
    rows = (run / "metrics.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(",")[1:])
    jm, params = jdu.build_diffusion_model(json.loads((run / "train_config.json").read_text()),
                                           ckpt_path=str(run / "diff_last.pt"))
    assert type(jm).__name__ == "EfficientUNetND"

    out = _module_cli("fmdm_tpu_torch.run_model", "--ckpt_dir", run, "--mode", "evaluate",
                      "--device", "cpu", "--num_samples", 4, "--batch_size", 2,
                      "--num_inference_steps", 2, "--output_dir", tmp_path / "eval")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Model throughput:" in out.stdout
    (exp,) = (tmp_path / "eval").iterdir()
    per_image = (exp / "eval_metrics_per_image.csv").read_text().splitlines()
    summary = (exp / "eval_metrics.csv").read_text().splitlines()
    assert len(per_image) == 5 and len(summary) == 2
    header, values = summary[0].split(","), summary[1].split(",")
    assert all(np.isfinite(float(values[header.index(k)])) for k in ("mse", "psnr", "ssim"))
