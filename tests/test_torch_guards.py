"""Guards of the port: it imports neither JAX nor the JAX package, its entry
points default to CUDA and raise without it, and the CPU never launches a
kernel."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "fmdm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "fmdm_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax(path):
    assert not FORBIDDEN & set(_imported_roots(path))


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fmdm_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(fmdm_tpu_torch.__path__, 'fmdm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('fmdm_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def _entry_points():
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory, VAEFactory
    from fmdm_tpu_torch.models.unet_diffusers import UNetDiffusersND
    from fmdm_tpu_torch.models.vae import AutoencoderKL
    from fmdm_tpu_torch.nn.blocks import ResBlockND, SpatialSelfAttention
    from fmdm_tpu_torch.sample.diffusion_utils import build_diffusion_model, decode_diffusion_batch
    from fmdm_tpu_torch.sample.engine import SamplingEngine
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model
    from fmdm_tpu_torch.schedulers import DDPMScheduler, DPMSolverMultistepScheduler
    from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step
    from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer

    cfg = {"unet_impl": "diffusers_nd", "block_out_channels": [8, 16], "norm_num_groups": 4,
           "layers_per_block": 1, "down_block_types": ["DownBlock2D", "DownBlock2D"],
           "up_block_types": ["UpBlock2D", "UpBlock2D"]}
    sched = DPMSolverMultistepScheduler.create()
    vae = {"resolution": 8, "base_ch": 8, "down_channels": [8, 8], "num_res_blocks": 1,
           "in_channels": 1, "out_channels": 1, "attn_heads": 2, "attn_dim_head": 4}
    denoise = {"training": {"batch_size": 2}, "model": {"unet": cfg, "model_type": "diffusion"}}
    run = {"training": {"conditioning": "concatenate", "channels": 1, "num_inference_steps": 1},
           "model": {"unet": cfg, "model_type": "diffusion", "scheduler": {"name": "ddim"}}}
    cpu_unet = DiffusionUNetFactory().build(cfg, "concatenate", 1, device="cpu")

    def train_step(**kw):
        model = DiffusionUNetFactory().build(cfg, "concatenate", 1, device="cpu")
        optimizer, schedule = make_adamw(model.parameters(), 1e-4, 0.0, 1, 10)
        return make_denoise_train_step(model, DDPMScheduler.create(), optimizer, schedule,
                                       variant="diffusion", conditioning_mode="concatenate",
                                       latent_norm=None, **kw)

    return {
        "factory": lambda **kw: DiffusionUNetFactory().build(cfg, "concatenate", 1, **kw),
        "unet": lambda **kw: UNetDiffusersND(block_out_channels=(8, 16), norm_num_groups=4,
                                             down_block_types=("DownBlock2D",) * 2,
                                             up_block_types=("UpBlock2D",) * 2, **kw),
        "resblock": lambda **kw: ResBlockND(8, None, 0.0, norm_groups=4, **kw),
        "engine": lambda **kw: SamplingEngine(torch.nn.Linear(1, 1), sched,
                                              sched.set_timesteps(3), **kw),
        "vae_factory": lambda **kw: VAEFactory().build(vae, **kw),
        "autoencoder_kl": lambda **kw: AutoencoderKL(**vae, **kw),
        "build_vae_model": lambda **kw: build_vae_model({"model": vae}, **kw),
        "spatial_attention": lambda **kw: SpatialSelfAttention(8, heads=2, dim_head=4, **kw),
        "build_denoise_trainer": lambda **kw: build_denoise_trainer(denoise, variant="diffusion",
                                                                    num_samples=4, **kw),
        "make_denoise_train_step": train_step,
        "build_diffusion_model": lambda **kw: build_diffusion_model(run, **kw),
        "decode_diffusion_batch": lambda **kw: decode_diffusion_batch(
            cpu_unet, run["training"], run["model"], (1, 1, 8, 8), torch.zeros(1, 1, 8, 8), **kw),
    }


@pytest.mark.parametrize("name", ["factory", "unet", "resblock", "engine", "vae_factory",
                                  "autoencoder_kl", "build_vae_model", "spatial_attention",
                                  "build_denoise_trainer", "make_denoise_train_step",
                                  "build_diffusion_model", "decode_diffusion_batch"])
def test_entry_points_default_to_cuda_and_never_fall_back(name, monkeypatch):
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(device="cuda")
    make(device="cpu")


def test_cpu_forward_launches_no_kernel():
    from fmdm_tpu_torch.ops.kernels.flash_attention import K3, K4, K5
    from fmdm_tpu_torch.ops.kernels.group_norm import K1
    from fmdm_tpu_torch.ops.kernels.small_t_attention import K2
    from fmdm_tpu_torch.train.vae_impl import KLTrainStep

    records = (K1, K2, K3, K4, K5)
    for r in records:
        r.launches = 0
    model = _entry_points()["factory"](device="cpu")
    with torch.no_grad():
        out = model(torch.randn(1, 2, 8, 8), 3)
    assert out.shape == (1, 1, 8, 8)
    vae = _entry_points()["vae_factory"](device="cpu")
    KLTrainStep(vae, {}).step(torch.rand(2, 1, 8, 8), torch.ones(2))
    batch = {"target": torch.rand(2, 1, 8, 8), "image": torch.rand(2, 1, 8, 8),
             "valid": torch.ones(2)}
    _entry_points()["make_denoise_train_step"](device="cpu").step(
        batch, generator=torch.Generator().manual_seed(0))
    assert [r.launches for r in records] == [0] * 5


def test_chip_smoke_refuses_to_run_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
