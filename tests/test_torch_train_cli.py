"""The port's training CLI, ``python -m fmdm_tpu_torch.train``, against the
root ``train.py``: the same flags plus ``--device``; ``--device cpu`` trains
the flagship's config (cut to a two-level UNet at 16²) and the KL-VAE's
over a synthetic LDCT root of 2 cases of 3 slices; without ``--device`` it
raises when no card is present; an unknown ``model_type`` raises JAX's
message; ``--debug_visual_only`` for diffusion, flow matching and the VAE
writes the files JAX's ``debug_visual_only`` writes, from one JAX
checkpoint, with JAX's draws replayed into the port: the float outputs
handed to the dataset's writer within 1e-5 relative to their largest
value (a 3-step decode in f32), the quantized files (PNG grids, PNG and
DICOM slices) within one level.
"""

import ast
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

from fmdm_tpu.data import dataset_utils as jdata
from fmdm_tpu.nn.module import unflatten_params as jax_unflatten
from fmdm_tpu.sample import engine as jengine
from fmdm_tpu.train import denoise_lib as jdenoise
from fmdm_tpu.train import diffusion_lib as jdiff
from fmdm_tpu.train import flow_matching_lib as jflow
from fmdm_tpu.train import vae_lib as jvae_lib
from fmdm_tpu.utils import checkpoint as jckpt
from fmdm_tpu_torch.data import dataset_utils as tdata
from fmdm_tpu_torch.data.io import load_image
from fmdm_tpu_torch.train import __main__ as tmain
from fmdm_tpu_torch.train import denoise_lib as tdenoise
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_models import random_flat_params
from tests.test_torch_run_dir import SMALL_UNET
from tests.test_torch_train_vae_loop import VAE

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"diffusion": REPO / "configs" / "LDCT" / "LDCT_ddpm_diffusers_nd.json",
           "flow_matching": REPO / "configs" / "LDCT" / "LDCT_flow_matching_diffusers_nd.json",
           "vae": REPO / "configs" / "LDCT" / "LDCT_autoencoder_kl.json"}
SIDE, STEPS = 16, 3
OUTPUT_RTOL = 1e-5


def write_ldct_root(root: Path) -> Path:
    """2 cases (``001``, ``002``) of 3 paired 16² slices in HU, in both
    split files, with the LDCT class and its HU window in dataset.json."""
    rng = np.random.default_rng(0)
    (root / "vol").mkdir(parents=True)
    lines = []
    for case in ("001", "002"):
        for kind, scale in (("sdct", 1.0), ("ldct", 1.3)):
            vol = rng.uniform(-1000, 1500, (3, SIDE, SIDE)).astype(np.float32) * scale
            np.save(root / "vol" / f"{kind}_{case}.npy", vol)
        lines.append(f"{case}\tvol/sdct_{case}.npy\tvol/ldct_{case}.npy")
    for split in ("train.txt", "test.txt"):
        (root / split).write_text("\n".join(lines) + "\n")
    (root / "dataset.json").write_text(json.dumps({
        "dataset_class": "datasets.ldct:LDCTDataset",
        "preprocess_kwargs": {"MIN_B": -1024, "MAX_B": 3072, "slope": 1.0, "intersept": -1024}}))
    return root


def small_cfg(model_type: str, root: Path, out: Path) -> dict:
    """The model type's LDCT config at 16² and 1 epoch, over ``root``."""
    cfg = json.loads(CONFIGS[model_type].read_text())
    training = cfg["training"]
    training.update(data_root=str(root), output_dir=str(out), img_size=SIDE, num_workers=0,
                    use_tensor_cache=False, seed=5)
    if model_type == "vae":
        cfg["model"] = dict(VAE, resolution=SIDE)
        training.update(epochs=1, visual_samples=2)
    else:
        cfg["model"]["unet"] = dict(SMALL_UNET)
        cfg["model"]["scheduler"]["num_inference_steps"] = STEPS
        training.update(num_epochs=1, num_inference_steps=STEPS, train_batch_size=4,
                        batch_size=4, lr_warmup_steps=2)
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_ldct_root(tmp_path_factory.mktemp("ldct") / "data")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _cli(*args, timeout=240):
    return subprocess.run([sys.executable, "-m", "fmdm_tpu_torch.train", *map(str, args)],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=timeout)


def test_flags_are_train_pys_plus_device():
    tree = ast.parse((REPO / "train.py").read_text())
    want = [node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"]
    got = [a.option_strings[0] for a in tmain.build_parser()._actions if a.option_strings
           and a.option_strings[0] != "-h"]
    assert got == want + ["--device"]
    assert len(want) == 8


@pytest.mark.parametrize("model_type,prefix", [("diffusion", "diff"), ("vae", "vae")])
def test_cli_trains_on_the_cpu(tmp_path, root, model_type, prefix):
    cfg = small_cfg(model_type, root, tmp_path / "run")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = _cli("--config", path, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    run = tmp_path / "run_run1"
    files = {str(p.relative_to(run)) for p in run.rglob("*") if p.is_file()}
    assert {f"{prefix}_last.pt", f"{prefix}_best.pt", "metrics.csv", "train_config.json",
            "epochs/epoch0001/epoch.pt"} <= files
    rows = (run / "metrics.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(",")[1:])


def test_cli_without_a_card_raises(tmp_path, root):
    cfg = small_cfg("diffusion", root, tmp_path / "run")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = _cli("--config", path, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not (tmp_path / "run_run1").exists()


def test_unknown_model_type_raises_jaxs_message(tmp_path):
    sys.path.insert(0, str(REPO))
    import train as jax_train_cli

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"training": {}, "model": {"model_type": "gan"}}))
    messages = []
    for dispatch in (jax_train_cli.dispatch_train, tmain.dispatch_train):
        with pytest.raises(ValueError) as err:
            dispatch(path, None)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "Unsupported model_type 'gan'" in messages[0]


# ---------------------------------------------------------------------------
# --debug_visual_only against JAX's debug_visual_only
# ---------------------------------------------------------------------------

@pytest.fixture
def replay(monkeypatch):
    """Record JAX's decode draws (the start noise, and the steps' noise of a
    stochastic scheduler) and the float outputs both packages hand to the
    dataset's writer; feed the draws to the port's decode."""
    draws, written = [], {"jax": [], "port": []}
    last = {}
    real_call = jengine.SamplingEngine.__call__

    def engine_call(engine, params, shape, rng, *args, **kw):
        last.update(n=len(engine.timesteps), stochastic=bool(engine.scheduler.needs_noise),
                    shape=tuple(shape))
        return real_call(engine, params, shape, rng, *args, **kw)

    def normal(key):
        return torch.from_numpy(np.array(jax.random.normal(key, last["shape"], jnp.float32)))

    real_jax_decode = jdenoise.decode_diffusion_batch

    def jax_decode(*args, **kw):
        out = real_jax_decode(*args, **kw)
        _, k_sample = jax.random.split(kw["rng"])
        k_init, k_steps = jax.random.split(k_sample)
        steps = ([normal(k) for k in jax.random.split(k_steps, last["n"])]
                 if last["stochastic"] else None)
        draws.append((normal(k_init), steps))
        return out

    real_port_decode = tdenoise.decode_diffusion_batch

    def port_decode(*args, generator=None, **kw):
        init, steps = draws.pop(0)
        return real_port_decode(*args, init_noise=init, step_noise=steps, **kw)

    def recording(pkg, real):
        def save(dataset, row, key, tensor, output_root):
            written[pkg].append((str(Path(output_root).name), np.array(tensor, np.float64)))
            return real(dataset, row, key, tensor, output_root)
        return save

    monkeypatch.setattr(jengine.SamplingEngine, "__call__", engine_call)
    monkeypatch.setattr(jdenoise, "decode_diffusion_batch", jax_decode)
    monkeypatch.setattr(tdenoise, "decode_diffusion_batch", port_decode)
    monkeypatch.setattr(jdata, "save_output_tensor", recording("jax", jdata.save_output_tensor))
    monkeypatch.setattr(tdata, "save_output_tensor", recording("port", tdata.save_output_tensor))
    yield written
    assert not draws, "a recorded draw was not replayed"


def _jax_checkpoint(model_type: str, cfg_path: Path, path: Path) -> Path:
    if model_type == "vae":
        from fmdm_tpu.sample.vae_utils import build_vae_model

        model, _ = build_vae_model(json.loads(cfg_path.read_text()) | {
            "__config_path__": str(cfg_path)})
        flat = {k: v for k, v in random_flat_params(model, 31).items()}
    else:
        from fmdm_tpu.sample.diffusion_utils import DiffusionUNetFactory

        model = DiffusionUNetFactory().build(SMALL_UNET, "concatenate", 1)
        flat = random_flat_params(model, 30)
    jckpt.save_checkpoint({"model": jax_unflatten(flat), "epoch": 1}, path)
    return path


def _assert_same_outputs(jax_root: Path, port_root: Path, written):
    want = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*") if p.is_file())
    got = sorted(p.relative_to(port_root) for p in port_root.rglob("*") if p.is_file())
    assert got == want and len(want) > 3
    for rel in want:
        a, b = (np.asarray(load_image(r / rel)["Image"], np.float64) for r in (port_root, jax_root))
        assert a.shape == b.shape and float(np.abs(a - b).max()) <= 1, rel
    assert [w[0] for w in written["port"]] == [w[0] for w in written["jax"]] and written["jax"]
    for (_, got_t), (_, want_t) in zip(written["port"], written["jax"]):
        err = float(np.abs(got_t - want_t).max() / max(np.abs(want_t).max(), 1e-12))
        assert err <= OUTPUT_RTOL, err


@pytest.mark.parametrize("model_type,jax_debug", [
    ("diffusion", jdiff.debug_visual_only), ("flow_matching", jflow.debug_visual_only),
    ("vae", jvae_lib.debug_visual_only)])
def test_debug_visual_only_matches_jax(tmp_path, root, replay, model_type, jax_debug):
    cfg = small_cfg(model_type, root, tmp_path / "run")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    ckpt = _jax_checkpoint(model_type, cfg_path, tmp_path / "ckpt.pt")
    jax_cfg = json.loads(cfg_path.read_text()) | {"__config_path__": str(cfg_path)}
    _, val = jdata.build_train_val_datasets(jax_cfg)
    jax_debug(val, cfg_path, ckpt, output_dir=tmp_path / "jax", visual_samples=2, seed=4)
    tmain.main(["--config", str(cfg_path), "--debug_visual_only", "--ckpt", str(ckpt),
                "--visual_samples", "2", "--seed", "4", "--output_dir", str(tmp_path / "port"),
                "--device", "cpu"])
    _assert_same_outputs(tmp_path / "jax", tmp_path / "port", replay)
