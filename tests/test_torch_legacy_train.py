"""The port's legacy per-trainer CLI (``fmdm_tpu_torch/legacy_train.py``)
against the JAX package's (``tests/test_cli_aux.py``'s cases): the same
trainer names and modules, the same override dict landing in the config the
trainer reads, an unknown trainer refused; and one real epoch of a trainer
through it on the CPU."""

import json
import sys
from pathlib import Path

import pytest

from fmdm_tpu import legacy_train as jlegacy
from fmdm_tpu_torch import legacy_train as tlegacy
from tests.test_cli_aux import _mnist_cfg
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401

FLAGS = ["--epochs", "3", "--batch_size", "2", "--img_size", "16", "--channels", "1",
         "--perceptual_device", "cpu", "--disc_device", "cpu"]


def _fake(seen, out):
    class FakeModule:
        @staticmethod
        def train(train_ds, json_path, val_dataset=None, resume=None, **kwargs):
            seen["cfg"] = json.loads(Path(json_path).read_text())
            seen["n"] = len(train_ds)
            seen["kwargs"] = dict(kwargs, resume=resume)
            return out
    return FakeModule


def test_legacy_train_overrides_match_jax(tmp_path, monkeypatch):
    cfg_path, _ = _mnist_cfg(tmp_path)
    jax_seen, port_seen, modules = {}, {}, []
    monkeypatch.setattr(jlegacy, "import_module",
                        lambda name: modules.append(name) or _fake(jax_seen, tmp_path))
    monkeypatch.setattr(sys, "argv", ["legacy_train", "diffusion", "--config", str(cfg_path),
                                      "--device", "cpu", *FLAGS])
    jlegacy.main()
    monkeypatch.setattr(tlegacy, "import_module",
                        lambda name: modules.append(name) or _fake(port_seen, tmp_path))
    tlegacy.main(["diffusion", "--config", str(cfg_path), "--device", "cpu", *FLAGS])
    assert port_seen["cfg"] == jax_seen["cfg"]
    t = port_seen["cfg"]["training"]
    assert (t["num_epochs"], t["train_batch_size"], t["img_size"], t["manual_device"],
            t["disc_device"]) == (3, 2, 16, "cpu", "cpu")
    assert port_seen["n"] == jax_seen["n"] > 0
    assert str(port_seen["kwargs"]["device"]) == "cpu" and port_seen["kwargs"]["resume"] is None
    assert modules == ["fmdm_tpu.train.diffusion_lib", "fmdm_tpu_torch.train.diffusion_lib"]
    assert sorted(tlegacy.TRAINER_MODULES) == sorted(jlegacy.TRAINER_MODULES)
    assert all(v == jlegacy.TRAINER_MODULES[k].replace("fmdm_tpu.", "fmdm_tpu_torch.")
               for k, v in tlegacy.TRAINER_MODULES.items())


def test_legacy_train_unknown_trainer(tmp_path):
    cfg_path, _ = _mnist_cfg(tmp_path)
    with pytest.raises(SystemExit):
        tlegacy.main(["nope", "--config", str(cfg_path)])


def test_legacy_train_needs_a_card_unless_told(tmp_path, monkeypatch):
    import torch

    cfg_path, _ = _mnist_cfg(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlegacy.main(["vae", "--config", str(cfg_path)])


def test_legacy_train_runs_a_trainer_on_the_cpu(tmp_path, monkeypatch):
    """One epoch of the diffusion trainer through the legacy CLI over 16 of
    the synthetic digits, its overrides in the run's frozen config."""
    build = tlegacy.build_train_val_datasets

    def first_digits(cfg):
        train, val = build(cfg)
        for ds in (train, val):
            ds.images, ds.labels, ds.data = ds.images[:16], ds.labels[:16], ds.data[:16]
        return train, val

    monkeypatch.setattr(tlegacy, "build_train_val_datasets", first_digits)
    cfg_path, cfg = _mnist_cfg(tmp_path)
    cfg["model"]["unet"].update(block_out_channels=[8, 16], norm_num_groups=4)
    cfg["training"].update(save_images=False, num_workers=0)
    cfg_path.write_text(json.dumps(cfg))
    tlegacy.main(["diffusion", "--config", str(cfg_path), "--device", "cpu", "--epochs", "1",
                  "--batch_size", "8"])
    runs = sorted(Path(cfg["training"]["output_dir"]).parent.glob("ckpt_diffusion*"))
    assert runs, "no run dir"
    frozen = json.loads((runs[-1] / "train_config.json").read_text())["training"]
    assert frozen["num_epochs"] == 1 and frozen["train_batch_size"] == 8
    assert frozen["manual_device"] == "cpu"
    assert any(p.name.startswith("diff_last") for p in runs[-1].iterdir())
    for tmp in cfg_path.parent.glob("legacy_train_*.json"):
        assert json.loads(tmp.read_text())["training"]["num_epochs"] == 1
