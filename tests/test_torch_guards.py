"""Guards of the port: it imports neither JAX, orbax nor the JAX package, its entry
points default to CUDA and raise without it, and the CPU never launches a
kernel. The quality tools (``fmdm_tpu_torch/scripts/``) import nothing of the
JAX package's ``scripts/`` either, and pass no device to the CLIs unless
given one (so the CLIs take the card)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "fmdm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "fmdm_tpu", "orbax", "tensorstore"}


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


SCRIPT_FILES = sorted((REPO / "fmdm_tpu_torch" / "scripts").glob("*.py"))
TOOL_FILES = [p for p in SCRIPT_FILES if p.name != "__init__.py"]


@pytest.mark.parametrize("path", SCRIPT_FILES, ids=lambda p: p.name)
def test_quality_tools_import_nothing_of_the_jax_scripts(path):
    assert not (FORBIDDEN | {"scripts"}) & set(_imported_roots(path))
    assert "sys.path" not in path.read_text()


def _keyword(call: ast.Call, name: str):
    return next((k.value for k in call.keywords if k.arg == name), None)


@pytest.mark.parametrize("path", TOOL_FILES, ids=lambda p: p.name)
def test_quality_tools_default_to_the_card(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    device_flags = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
                    and getattr(node.func, "attr", "") == "add_argument"
                    and node.args and getattr(node.args[0], "value", None) == "--device"]
    assert len(device_flags) == 1
    default = _keyword(device_flags[0], "default")
    assert default is None or (isinstance(default, ast.Constant) and default.value is None)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for name in ("default", "device"):
                value = _keyword(node, name)
                assert not (isinstance(value, ast.Constant) and value.value == "cpu"), (
                    path.name, node.lineno)


def test_quality_tools_pass_no_device_unless_given_one():
    from fmdm_tpu_torch.scripts import flagship_quality_sweep as sweep

    cmd = sweep.evaluate_cmd(Path("run"), "flowmatch", Path("out"), num_samples=4)
    assert "--device" not in cmd and cmd[1:3] == ["-m", "fmdm_tpu_torch.run_model"]
    assert sweep.module_cmd("fmdm_tpu_torch.train", "--config", "c")[-2:] == ["--config", "c"]
    assert sweep.module_cmd("fmdm_tpu_torch.train", device="cuda")[-2:] == ["--device", "cuda"]
    assert sweep.build_parser().parse_args([]).device is None


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
    from fmdm_tpu_torch.models.vae import VQVAE, AutoencoderKL
    from fmdm_tpu_torch.models.unet_efficient import EfficientUNetND
    from fmdm_tpu_torch.nn.blocks import (PoolND, ResBlockND, SpatialCrossAttention,
                                          SpatialSelfAttention, UnPoolND)
    from fmdm_tpu_torch.nn.losses import PerceptualLoss
    from fmdm_tpu_torch.nn.vae_modules import VectorQuantizer, VectorQuantizerEMA
    from fmdm_tpu_torch.sample.diffusion_utils import build_diffusion_model, decode_diffusion_batch
    from fmdm_tpu_torch.parallel.mesh import create_mesh, create_mesh_for_batch, rank_device
    from fmdm_tpu_torch.parallel.mesh import create_dp_sp_mesh, create_dp_tp_mesh_global
    from fmdm_tpu_torch.parallel import sequence
    from fmdm_tpu_torch.sample.engine import SamplingEngine
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model
    from fmdm_tpu_torch.schedulers import DDPMScheduler, DPMSolverMultistepScheduler
    from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step
    from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer
    from fmdm_tpu_torch.nn.layers import BatchNorm, RMSNormND
    from fmdm_tpu_torch.nn.vae_modules import MagvitDiscriminatorND, PatchDiscriminator
    from fmdm_tpu_torch.utils.quantize import quantize_model

    cfg = {"unet_impl": "diffusers_nd", "block_out_channels": [8, 16], "norm_num_groups": 4,
           "layers_per_block": 1, "down_block_types": ["DownBlock2D", "DownBlock2D"],
           "up_block_types": ["UpBlock2D", "UpBlock2D"]}
    sched = DPMSolverMultistepScheduler.create()
    vae = {"resolution": 8, "base_ch": 8, "down_channels": [8, 8], "num_res_blocks": 1,
           "in_channels": 1, "out_channels": 1, "attn_heads": 2, "attn_dim_head": 4}
    denoise = {"training": {"batch_size": 2}, "model": {"unet": cfg, "model_type": "diffusion"}}
    run = {"training": {"conditioning": "concatenate", "channels": 1, "num_inference_steps": 1},
           "model": {"unet": cfg, "model_type": "diffusion", "scheduler": {"name": "ddim"}}}
    efficient = {"unet_impl": "efficient_nd", "model_channels": 8, "num_res_blocks": 1,
                 "channel_mult": [1, 2], "attention_resolutions": [2], "num_heads": 2,
                 "dim_head": 4}
    cpu_unet = DiffusionUNetFactory().build(cfg, "concatenate", 1, device="cpu")
    loops = _training_loops(cfg, vae)

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
        "vqvae": lambda **kw: VQVAE(**vae, codebook_size=8, **kw),
        "vector_quantizer": lambda **kw: VectorQuantizer(8, 4, **kw),
        "vector_quantizer_ema": lambda **kw: VectorQuantizerEMA(8, 4, **kw),
        "perceptual_loss": lambda **kw: PerceptualLoss(resize=True, **kw),
        "spatial_attention": lambda **kw: SpatialSelfAttention(8, heads=2, dim_head=4, **kw),
        "linear_attention": lambda **kw: SpatialSelfAttention(8, heads=2, dim_head=4,
                                                              use_linear=True, **kw),
        "cross_attention": lambda **kw: SpatialCrossAttention(8, 4, heads=2, dim_head=4, **kw),
        "pool": lambda **kw: PoolND(2, 1, 8, 2, **kw),
        "unpool": lambda **kw: UnPoolND(2, 8, 1, 2, **kw),
        "efficient_factory": lambda **kw: DiffusionUNetFactory().build(efficient, "attention", 1,
                                                                       **kw),
        "efficient_unet": lambda **kw: EfficientUNetND(2, 2, 8, 1, 1, (2,), channel_mult=(1, 2),
                                                       num_heads=2, dim_head=4, **kw),
        "build_denoise_trainer": lambda **kw: build_denoise_trainer(denoise, variant="diffusion",
                                                                    num_samples=4, **kw),
        "make_denoise_train_step": train_step,
        "build_diffusion_model": lambda **kw: build_diffusion_model(run, **kw),
        "decode_diffusion_batch": lambda **kw: decode_diffusion_batch(
            cpu_unet, run["training"], run["model"], (1, 1, 8, 8), torch.zeros(1, 1, 8, 8), **kw),
        "rmsnorm_resblock": lambda **kw: ResBlockND(8, 4, 0.0, norm_type="rmsnorm",
                                                    use_scale_shift_norm=True, **kw),
        "rmsnorm": lambda **kw: RMSNormND(8, **kw),
        "batch_norm": lambda **kw: BatchNorm(8, **kw),
        "patch_discriminator": lambda **kw: PatchDiscriminator(base_channels=4, **kw),
        "magvit_discriminator": lambda **kw: MagvitDiscriminatorND(base_channels=4, **kw),
        "make_discriminator": lambda **kw: AutoencoderKL(**vae, device="cpu").make_discriminator(
            **kw),
        "rank_device": lambda **kw: rank_device(**kw),
        "create_mesh": lambda device=None: create_mesh(
            devices=None if device is None else [device, device]),
        "create_mesh_for_batch": lambda device=None: create_mesh_for_batch(
            2, None if device is None else [device, device]),
        "ring_attention": lambda device=None: sequence.ring_attention(
            *([torch.ones(1, 2, 4, 4)] * 2,) * 3,
            devices=None if device is None else [device, device]),
        "sequence_parallel_sdpa": lambda device=None: sequence.sequence_parallel_sdpa(
            *(torch.ones(1, 2, 8, 4),) * 3, devices=None if device is None else [device, device]),
        "sequence_self_tests": lambda **kw: sequence.run_self_tests(**kw),
        "create_dp_sp_mesh": lambda device=None: create_dp_sp_mesh(
            2, 2, None if device is None else [device, device]),
        "create_dp_tp_mesh_global": lambda device=None: create_dp_tp_mesh_global(
            2, 2, devices=None if device is None else [device, device]),
        "quantize_model": lambda **kw: quantize_model(
            cpu_unet, [(torch.zeros(1, 2, 8, 8), torch.tensor([3]))], min_hw=4, min_channels=4,
            **kw),
        **loops,
    }


def _training_loops(unet, vae):
    """The run loops and the training CLI over 4 synthetic digits at 8², one
    step each, in a fresh temporary directory."""
    import json
    import tempfile

    from fmdm_tpu_torch.data.mnist import MNISTDataset
    from fmdm_tpu_torch.models.factories import VAEFactory
    from fmdm_tpu_torch.sample import autoencoder_like
    from fmdm_tpu_torch import legacy_train
    from fmdm_tpu_torch.train import __main__ as train_cli
    from fmdm_tpu_torch.train import denoise_lib, vae_impl
    from fmdm_tpu_torch.utils.checkpoint import save_checkpoint

    tmp = Path(tempfile.mkdtemp())

    def digits():
        ds = MNISTDataset(tmp / "data", img_size=8)
        ds.images, ds.labels, ds.data = ds.images[:4], ds.labels[:4], ds.data[:4]
        return ds

    training = {"data_root": str(tmp / "data"), "dataset": "mnist", "batch_size": 4, "seed": 0,
                "img_size": 8, "save_images": False, "conditioning": "concatenate",
                "output_dir": str(tmp / "run")}
    paths = {}
    for name, model, extra in (
            ("diffusion", {"unet": unet, "model_type": "diffusion"}, {}),
            ("vae", dict(vae, model_type="vae", z_channels=4, embed_dim=4), {}),
            ("vae_gan", dict(vae, model_type="vae", z_channels=4, embed_dim=4, resolution=32),
             {"gan_weight": 0.5, "img_size": 32})):
        paths[name] = tmp / f"{name}.json"
        paths[name].write_text(json.dumps({"training": dict(training, **extra), "model": model}))

    # a VAE run dir (embed_dim 1: decode takes the digits as latents)
    vae_run = tmp / "vae_run"
    vae_run.mkdir()
    run_model = dict(vae, model_type="vae", z_channels=4, embed_dim=1)
    (vae_run / "train_config.json").write_text(json.dumps({"training": training,
                                                           "model": run_model}))
    save_checkpoint({"model": VAEFactory().build(run_model, device="cpu")},
                    vae_run / "vae_last.pt")

    def autoencoder_modes(**kw):
        for mode in ("encode", "decode", "sample", "evaluate", "debug_compare"):
            getattr(autoencoder_like, mode)(ckpt_dir=vae_run, num_samples=2,
                                            output_dir=str(tmp / mode), **kw)

    def cli(**kw):
        device = ["--device", str(kw["device"])] if kw.get("device") else []
        real = train_cli.build_train_val_datasets
        train_cli.build_train_val_datasets = lambda cfg: (digits(), None)
        try:
            train_cli.main(["--config", str(paths["diffusion"]), *device])
        finally:
            train_cli.build_train_val_datasets = real

    def legacy(**kw):
        device = ["--device", str(kw["device"])] if kw.get("device") else []
        real = legacy_train.build_train_val_datasets
        legacy_train.build_train_val_datasets = lambda cfg: (digits(), None)
        try:
            legacy_train.main(["vae", "--config", str(paths["vae"]), "--epochs", "1", *device])
        finally:
            legacy_train.build_train_val_datasets = real

    def gan_digits():
        ds = MNISTDataset(tmp / "data32", img_size=32)
        ds.images, ds.labels, ds.data = ds.images[:4], ds.labels[:4], ds.data[:4]
        return ds

    return {
        "denoise_train": lambda **kw: denoise_lib.train(digits(), paths["diffusion"],
                                                        variant="diffusion",
                                                        max_steps_per_epoch=1, **kw),
        "vae_train": lambda **kw: vae_impl.train(digits(), paths["vae"], max_steps_per_epoch=1,
                                                 **kw),
        "vae_gan_train": lambda **kw: vae_impl.train(gan_digits(), paths["vae_gan"],
                                                     max_steps_per_epoch=1, **kw),
        "train_cli": cli,
        "legacy_train": legacy,
        "autoencoder_modes": autoencoder_modes,
    }


@pytest.mark.parametrize("name", ["factory", "unet", "resblock", "engine", "vae_factory",
                                  "autoencoder_kl", "build_vae_model", "spatial_attention",
                                  "linear_attention", "cross_attention", "pool", "unpool",
                                  "efficient_factory", "efficient_unet",
                                  "build_denoise_trainer", "make_denoise_train_step",
                                  "build_diffusion_model", "decode_diffusion_batch",
                                  "denoise_train", "vae_train", "train_cli", "vqvae",
                                  "vector_quantizer", "vector_quantizer_ema", "perceptual_loss",
                                  "autoencoder_modes", "rmsnorm_resblock", "rmsnorm",
                                  "batch_norm", "patch_discriminator", "magvit_discriminator",
                                  "make_discriminator", "quantize_model", "vae_gan_train",
                                  "legacy_train", "rank_device", "create_mesh",
                                  "create_mesh_for_batch", "ring_attention",
                                  "sequence_parallel_sdpa", "sequence_self_tests",
                                  "create_dp_sp_mesh", "create_dp_tp_mesh_global"])
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
        efficient = _entry_points()["efficient_factory"](device="cpu")
        out = efficient(torch.randn(1, 1, 8, 8), 3, context_ca=torch.randn(1, 1, 4, 4))
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
