"""The port's denoise training loop against the JAX package's, on the CPU.

Host batching (``epoch_batches`` and the ``DataLoader`` path) is held
bitwise to JAX's ``epoch_batches``; ``summarize_model``'s text to JAX's. The
loop runs a two-level UNet (8 and 16 channels, groups of 2 and 4 channels,
one attention level) at 16² over a few synthetic MNIST digits in both
packages: the port's weights start as JAX's (``build_diffusion_model`` is
wrapped to record them) and its steps get the noise and t that JAX drew
(the JAX step returned by ``autotune_grad_accum`` is wrapped to record its
key; ``DenoiseTrainStep.step`` is wrapped to take them). Held: the same
run-dir files, ``metrics.csv`` losses within 1e-5 relative, the weights and
EMA of ``{prefix}_last.pt`` within 1e-5 of JAX's (max abs error over max abs
value; the losses are sums over a few hundred f32 products, the weights a
few Adam updates at a rate of 1e-4 on gradients that agree to ~1e-6), but
the attention keys' biases, whose gradients are rounding noise (see
:func:`assert_trees_close`). A resumed run of the port is bitwise its
uninterrupted run; a JAX checkpoint resumed by the port matches JAX's own
resume within the same tolerances. JAX's optax state is held to torch's
AdamW state by tree order on a model whose names sort differently as
strings, and the start-up micro-batch tuning to JAX's.
"""

import copy
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fmdm_tpu.data import mnist as jmnist
from fmdm_tpu.nn.module import flatten_params as jax_flatten
from fmdm_tpu.train import common as jcommon
from fmdm_tpu.train import denoise_lib as jdenoise
from fmdm_tpu.utils import summary as jsummary
from fmdm_tpu_torch.data import grain_pipeline as tgrain
from fmdm_tpu_torch.data import mnist as tmnist
from fmdm_tpu_torch.train import common as tcommon
from fmdm_tpu_torch.train import denoise_lib as tdenoise
from fmdm_tpu_torch.utils import checkpoint as tckpt
from fmdm_tpu_torch.utils import summary as tsummary
from fmdm_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SIDE = 16
LOSS_RTOL = 1e-5
WEIGHT_TOL = 1e-5
UNET = {"unet_impl": "diffusers_nd", "sample_size": SIDE, "in_channels": 1, "out_channels": 1,
        "layers_per_block": 1, "block_out_channels": [8, 16],
        "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
        "up_block_types": ["AttnUpBlock2D", "UpBlock2D"], "norm_num_groups": 4}
SCHEDULERS = {"diffusion": "ddpm", "flow_matching": "flow_match_euler"}
PREFIX = {"diffusion": "diff", "flow_matching": "flow"}


def tiny(package, root, *, train=True, n=10):
    """The first ``n`` synthetic digits of either package's MNIST at 16²."""
    module = tmnist if package == "port" else jmnist
    ds = module.MNISTDataset(root, train=train, img_size=SIDE)
    ds.images, ds.labels = ds.images[:n], ds.labels[:n]
    if hasattr(ds, "data"):
        ds.data = ds.data[:n]
    return ds


def denoise_cfg(tmp: Path, variant: str, **training) -> dict:
    n_train = 50
    cfg = {
        "training": {"data_root": str(tmp / "data"), "dataset": "mnist",
                     "output_dir": str(tmp / "ckpt"), "train_batch_size": 4, "num_epochs": 2,
                     "learning_rate": 1e-4, "weight_decay": 1e-2, "lr_warmup_steps": 2,
                     "num_train_timesteps": n_train, "num_inference_steps": 3,
                     "conditioning": "concatenate", "channels": 1, "img_size": SIDE,
                     "save_model_epochs": 1, "seed": 7, "save_images": False, "num_workers": 0,
                     **training},
        "model": {"unet": dict(UNET), "model_type": variant,
                  "scheduler": {"name": SCHEDULERS[variant], "num_train_timesteps": n_train,
                                "num_inference_steps": 3,
                                "params": {"beta_start": 0.0001, "beta_end": 0.02}}},
    }
    return cfg


def write_cfg(path: Path, cfg: dict) -> Path:
    path.write_text(json.dumps(cfg, indent=2))
    return path


# ---------------------------------------------------------------------------
# JAX's draws, recorded and replayed
# ---------------------------------------------------------------------------

class Recorder:
    """Wrap JAX's ``autotune_grad_accum`` so that every call of the step it
    returns records what ``draw(args, accum)`` computes from its inputs."""

    def __init__(self, monkeypatch, draw):
        self.draws = []
        self.accums = []
        real = jcommon.autotune_grad_accum

        def autotune(*args, **kw):
            accum, step = real(*args, **kw)
            self.accums.append(accum)

            def recorded(*a, **k):
                self.draws.append(draw(a, accum))
                return step(*a, **k)

            return accum, recorded

        monkeypatch.setattr(jcommon, "autotune_grad_accum", autotune)


def denoise_draws(variant: str, n_train: int):
    """The noise and t of JAX's denoise step for its (batch, key) inputs,
    as numpy: ``split(key)`` into the noise's and t's keys, after
    ``split(key, n_chunks)`` when there are several chunks."""
    def draw(args, accum):
        batch, rng = args[-2], args[-1]
        x0 = batch["target"]
        bs = x0.shape[0]
        chunk = max(1, -(-bs // accum))
        n_chunks = -(-bs // chunk)
        keys = [rng] if n_chunks == 1 else list(jax.random.split(rng, n_chunks))
        noise, t = [], []
        for key in keys:
            k_noise, k_t = jax.random.split(key)
            noise.append(np.array(jax.random.normal(k_noise, (chunk, *x0.shape[1:]), jnp.float32)))
            if variant == "diffusion":
                t.append(np.array(jax.random.randint(k_t, (chunk,), 0, n_train)))
            else:
                t.append(np.array(jax.random.uniform(k_t, (chunk,), jnp.float32)))
        return np.concatenate(noise), np.concatenate(t)
    return draw


def replay_denoise_steps(monkeypatch, draws):
    real = tcommon.DenoiseTrainStep.step

    def step(self, batch, *, noise=None, t=None, generator=None):
        noise, t = draws.pop(0)
        return real(self, batch, noise=torch.from_numpy(noise), t=torch.from_numpy(t))

    monkeypatch.setattr(tcommon.DenoiseTrainStep, "step", step)


def share_initial_weights(monkeypatch):
    """Record the weights JAX's loop draws, and have the port's loop start
    from them."""
    initial = {}
    real = jdenoise.build_diffusion_model

    def jax_build(*args, **kw):
        model, params = real(*args, **kw)
        initial.update({k: np.array(v) for k, v in jax_flatten(params).items()})
        return model, params

    monkeypatch.setattr(jdenoise, "build_diffusion_model", jax_build)
    monkeypatch.setattr(tdenoise, "init_weights", lambda model, _gen: load_jax_params(model, initial))
    return initial


def run_files(run: Path):
    return sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())


def read_metrics(run: Path):
    lines = (run / "metrics.csv").read_text().strip().splitlines()
    return lines[0], [[float(v) for v in line.split(",")] for line in lines[1:]]


def assert_metrics_close(port_run: Path, jax_run: Path):
    (head_p, rows_p), (head_j, rows_j) = read_metrics(port_run), read_metrics(jax_run)
    assert head_p == head_j
    assert len(rows_p) == len(rows_j) and rows_p
    for got, want in zip(rows_p, rows_j):
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1:], want[1:], rtol=LOSS_RTOL, atol=1e-6)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def assert_trees_close(got: dict, want: dict, noise_bound: float, tol=WEIGHT_TOL):
    """Every weight within ``tol`` of the tree's largest JAX value, but the
    attention keys' biases: softmax over the keys ignores the q·b each adds
    to all of a query's logits, so their gradients are 0 in exact arithmetic
    and rounding noise in each package, which Adam turns into updates of up
    to each step's rate. They are held to ``noise_bound`` (twice the summed
    rates) in absolute terms."""
    assert got.keys() == want.keys()
    scale = max(float(np.abs(v).max()) for v in want.values())
    noisy = [k for k in want if k.endswith("to_k.bias")]
    worst = max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()) / scale
                for k in want if k not in noisy)
    assert worst <= tol, f"max|port-jax|/max|jax| = {worst:.3e}"
    for k in noisy:
        assert float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()) <= noise_bound, k


def summed_rates(rate, steps: int) -> float:
    return float(sum(rate(s) for s in range(steps)))


def checkpoint_trees(path: Path, keys=("model", "ema")):
    payload = tckpt.load_checkpoint(path)
    return {k: {n: np.asarray(v) for n, v in payload[k].items()} for k in keys if k in payload}


# ---------------------------------------------------------------------------
# Host batching
# ---------------------------------------------------------------------------

def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if w[k] is None:
                assert g[k] is None
            else:
                assert np.asarray(g[k]).dtype == w[k].dtype
                assert np.array_equal(np.asarray(g[k]), w[k]), k


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_batches_match_jax(tmp_path, workers, shuffle):
    """11 digits at batch 4 (a ragged last batch of 3, edge-padded, valid 0),
    through the threads and through the DataLoader, bitwise JAX's."""
    jds, tds = tiny("jax", tmp_path, n=11), tiny("port", tmp_path, n=11)
    kw = dict(shuffle=shuffle, seed=5, epoch=3)
    want = list(jcommon.epoch_batches(jds, 4, num_workers=workers, **kw))
    assert want[-1]["valid"].tolist() == [1, 1, 1, 0]
    _assert_batches_equal(tcommon.epoch_batches(tds, 4, num_workers=workers, **kw), want)
    _assert_batches_equal(tcommon.prefetch(tcommon.epoch_batches(tds, 4, num_workers=workers, **kw)),
                          want)
    _assert_batches_equal(tgrain.grain_epoch_batches(tds, 4, num_workers=workers, **kw), want)


def test_dataloader_pins_and_keeps_the_order_per_epoch(tmp_path):
    tds = tiny("port", tmp_path, n=9)
    jds = tiny("jax", tmp_path, n=9)
    for epoch in (1, 2):
        want = list(jcommon.epoch_batches(jds, 4, shuffle=True, seed=1, epoch=epoch))
        got = list(tgrain.grain_epoch_batches(tds, 4, shuffle=True, seed=1, epoch=epoch,
                                              pin_memory=torch.cuda.is_available()))
        _assert_batches_equal(got, want)


def test_prefetch_reraises_the_producers_error():
    def produce():
        yield 1
        raise KeyError("sample 3")

    out = []
    with pytest.raises(KeyError, match="sample 3"):
        for item in tcommon.prefetch(produce()):
            out.append(item)
    assert out == [1]


def test_auto_fetch_workers_match_jax(tmp_path, monkeypatch):
    """``num_workers=None`` threads the BaseDataset family (LDCT) and keeps
    other datasets (MNIST) serial, in both packages."""
    import concurrent.futures

    from tests.test_torch_data import _write_ldct_root

    root = tmp_path / "ldct"
    root.mkdir()
    _write_ldct_root(root, header=False, rows=[("001", 4, 4), ("002", 4, 4)])
    from fmdm_tpu.data import ldct as jldct
    from fmdm_tpu_torch.data import ldct as tldct

    made = []
    real = concurrent.futures.ThreadPoolExecutor

    class Counting(real):
        def __init__(self, max_workers=None, **kw):
            made.append(max_workers)
            super().__init__(max_workers=max_workers, **kw)

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Counting)

    def workers(epoch_batches, ds):
        made.clear()
        list(epoch_batches(ds, 2, shuffle=True, seed=0, epoch=1))
        return made[0] if made else 0

    pairs = {"ldct": (jldct.LDCTDataset(root, train=True), tldct.LDCTDataset(root, train=True)),
             "mnist": (tiny("jax", tmp_path, n=4), tiny("port", tmp_path, n=4))}
    for name, (jds, tds) in pairs.items():
        assert tds.thread_safe_getitem if name == "ldct" else not hasattr(tds, "thread_safe_getitem")
        assert workers(tcommon.epoch_batches, tds) == workers(jcommon.epoch_batches, jds), name
    assert workers(tcommon.epoch_batches, pairs["ldct"][1]) == min(8, tcommon.os.cpu_count())


# ---------------------------------------------------------------------------
# The model summary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [3, 0])
@pytest.mark.parametrize("which", ["unet", "vae"])
def test_summary_text_matches_jax(tmp_path, capsys, depth, which):
    from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxUNet
    from fmdm_tpu.models.factories import VAEFactory as JaxVAE
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory, VAEFactory
    from tests.test_torch_train_vae_loop import VAE

    if which == "unet":
        jm, tm = (JaxUNet().build(UNET, "concatenate", 1),
                  DiffusionUNetFactory().build(UNET, "concatenate", 1, device="cpu"))
    else:
        path = write_cfg(tmp_path / "vae.json", {"model": VAE})
        jm, tm = JaxVAE().build_from_json(path), VAEFactory().build(VAE, device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    training = {"summary_depth": depth}
    want_total = jsummary.summarize_model(params, {}, training, name=which)
    want = capsys.readouterr().out
    got_total = tsummary.summarize_model(tm, {}, training, name=which)
    got = capsys.readouterr().out
    assert got == want and got_total == want_total
    assert want.count("\n") > 10
    assert tsummary.summarize_model(tm, {}, {"show_model_summary": False}) == want_total
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# The loop against JAX's
# ---------------------------------------------------------------------------

def denoise_rate(cfg: dict, n: int):
    training = cfg["training"]
    total = training["num_epochs"] * -(-n // training["train_batch_size"])
    return tcommon.cosine_warmup_schedule(training["learning_rate"], training["lr_warmup_steps"],
                                          total)


def optimizer_step(payload) -> int:
    return int(payload["optimizer"]["state"][0]["step"])


def assert_runs_match(jax_run, port_run, name, rate):
    """The same files, metrics, epoch and best metric; the weights and EMA
    of ``name`` (the last checkpoint) as :func:`assert_trees_close` holds
    them, over the optimizer steps of the port's run at ``rate``."""
    assert run_files(port_run) == run_files(jax_run)
    assert_metrics_close(port_run, jax_run)
    jp, tp = (tckpt.load_checkpoint(r / name) for r in (jax_run, port_run))
    bound = 2 * summed_rates(rate, optimizer_step(tp))
    want, got = checkpoint_trees(jax_run / name), checkpoint_trees(port_run / name)
    assert got.keys() == want.keys()
    for key in want:
        assert_trees_close(got[key], want[key], bound)
    assert tp["epoch"] == jp["epoch"]
    assert tp["best_metric"] == pytest.approx(jp["best_metric"], rel=LOSS_RTOL)


def _train_both(tmp_path, monkeypatch, variant, cfg, *, n=10):
    """JAX's train(), then the port's with JAX's initial weights and draws;
    returns (JAX's run dir, the port's, JAX's accumulations)."""
    recorder = Recorder(monkeypatch, denoise_draws(variant, cfg["training"]["num_train_timesteps"]))
    share_initial_weights(monkeypatch)
    runs = {}
    for pkg, lib in (("jax", jdenoise), ("port", tdenoise)):
        pkg_cfg = copy.deepcopy(cfg)
        pkg_cfg["training"]["output_dir"] = str(tmp_path / f"{pkg}_ckpt")
        path = write_cfg(tmp_path / f"{pkg}.json", pkg_cfg)
        ds, val = tiny(pkg, tmp_path / "data", n=n), tiny(pkg, tmp_path / "data", train=False, n=4)
        if pkg == "port":
            replay_denoise_steps(monkeypatch, recorder.draws)
        runs[pkg] = lib.train(ds, path, val_dataset=val, variant=variant,
                              **({"device": "cpu"} if pkg == "port" else {}))
    assert not recorder.draws, "a recorded draw was not replayed"
    return runs["jax"], runs["port"], recorder.accums


def truncate_to_epoch(run: Path, dst: Path, epoch: int) -> Path:
    """A copy of ``run`` as it stood after ``epoch``: its config, the
    metrics rows up to it and the epoch snapshots up to it."""
    dst.mkdir(parents=True)
    shutil.copy(run / "train_config.json", dst)
    lines = (run / "metrics.csv").read_text().splitlines()[:epoch + 1]
    (dst / "metrics.csv").write_text("\n".join(lines) + "\n")
    for e in range(1, epoch + 1):
        shutil.copytree(run / "epochs" / f"epoch{e:04d}", dst / "epochs" / f"epoch{e:04d}")
    return dst


DDPM_TRAINING = {"ema_decay": 0.9, "save_images": True, "save_images_every": 2,
                 "visual_samples": 4}


@pytest.fixture(scope="module")
def ddpm_runs(tmp_path_factory):
    """The DDPM loop with EMA and visuals, trained by JAX and by the port on
    JAX's draws."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("ddpm")
    cfg = denoise_cfg(tmp, "diffusion", **DDPM_TRAINING)
    try:
        with pytest.MonkeyPatch.context() as mp:
            jax_run, port_run, _ = _train_both(tmp, mp, "diffusion", cfg)
    finally:
        torch.set_num_threads(threads)
    return {"tmp": tmp, "cfg": cfg, "jax": jax_run, "port": port_run}


def test_train_matches_jax_ddpm(ddpm_runs):
    jax_run, port_run, cfg = ddpm_runs["jax"], ddpm_runs["port"], ddpm_runs["cfg"]
    assert_runs_match(jax_run, port_run, "diff_last.pt", denoise_rate(cfg, 10))
    assert {"diff_best.pt", "epochs/epoch0002/epoch.pt", "visuals/epoch0002_output.png"} <= set(
        run_files(port_run))
    assert port_run.name == jax_run.name.replace("jax", "port")
    saved = json.loads((port_run / "train_config.json").read_text())
    assert saved["model"] == cfg["model"] and saved["training"]["output_dir"] == str(port_run)


def test_port_resumes_a_jax_run(ddpm_runs, monkeypatch):
    """JAX's epoch-1 snapshot (weights, optax state, EMA) resumed for epoch
    2 by the port and by JAX itself: the same files, metrics, weights and
    EMA, and the optimizer's step continued from 3 to 6."""
    tmp, cfg = ddpm_runs["tmp"], ddpm_runs["cfg"]
    snapshot = ddpm_runs["jax"] / "epochs" / "epoch0001" / "epoch.pt"
    assert tckpt.is_jax_tree_map(tckpt.load_checkpoint(snapshot)["optimizer"])
    recorder = Recorder(monkeypatch, denoise_draws("diffusion", 50))
    runs = {}
    for pkg, lib in (("jax", jdenoise), ("port", tdenoise)):
        run = truncate_to_epoch(ddpm_runs["jax"], tmp / f"resumed_by_{pkg}", 1)
        pkg_cfg = copy.deepcopy(cfg)
        pkg_cfg["training"]["output_dir"] = str(run)
        path = write_cfg(tmp / f"resume_{pkg}.json", pkg_cfg)
        if pkg == "port":
            replay_denoise_steps(monkeypatch, recorder.draws)
        runs[pkg] = lib.train(tiny(pkg, tmp / "data"), path,
                              val_dataset=tiny(pkg, tmp / "data", train=False, n=4),
                              resume=str(snapshot), variant="diffusion",
                              **({"device": "cpu"} if pkg == "port" else {}))
        assert runs[pkg] == run
    assert not recorder.draws
    assert_runs_match(runs["jax"], runs["port"], "diff_last.pt", denoise_rate(cfg, 10))
    assert optimizer_step(tckpt.load_checkpoint(runs["port"] / "diff_last.pt")) == 6


@pytest.mark.parametrize("route", ["argument", "config"])
def test_resume_in_the_port_is_bitwise(tmp_path, route):
    """1 epoch, then 1 resumed epoch, equals 2 epochs straight bitwise:
    weights, EMA, AdamW's moments and step, the rate, the loss; batches
    through the DataLoader's two workers. Resumed by ``resume``, the run
    continues in its dir; by ``training.resume``, in a new ``_runN`` dir
    beside ``output_dir``, as in the JAX package."""
    cfg = denoise_cfg(tmp_path, "diffusion", ema_decay=0.9, data_loader="grain", num_workers=2)
    ds = tiny("port", tmp_path / "data")
    straight = tdenoise.train(ds, write_cfg(tmp_path / "cfg.json", cfg), variant="diffusion",
                              device="cpu")
    base = truncate_to_epoch(straight, tmp_path / "resumed", 1)
    snapshot = str(straight / "epochs" / "epoch0001" / "epoch.pt")
    cfg["training"]["output_dir"] = str(base)
    if route == "config":
        cfg["training"]["resume"] = snapshot
    run = tdenoise.train(ds, write_cfg(tmp_path / "resume.json", cfg),
                         resume=snapshot if route == "argument" else None, variant="diffusion",
                         device="cpu")
    lines = (straight / "metrics.csv").read_text().splitlines()
    if route == "argument":
        assert run == base and (run / "metrics.csv").read_text().splitlines() == lines
    else:
        assert run == tmp_path / "resumed_run1"
        assert (run / "metrics.csv").read_text().splitlines() == [lines[0], lines[2]]
    got, want = (tckpt.load_checkpoint(r / "diff_last.pt") for r in (run, straight))
    for key in ("model", "ema"):
        assert got[key].keys() == want[key].keys()
        for name in want[key]:
            assert torch.equal(got[key][name], want[key][name]), (key, name)
    opt_got, opt_want = got["optimizer"], want["optimizer"]
    assert opt_got["param_groups"] == opt_want["param_groups"]
    for i, state in opt_want["state"].items():
        for k, v in state.items():
            assert torch.equal(opt_got["state"][i][k], v), (i, k)
    assert optimizer_step(got) == 6
    assert got["epoch"] == want["epoch"] == 2 and got["best_metric"] == want["best_metric"]


class _Oversized:
    """A JAX step whose trial compile exhausts device memory."""

    def lower(self, *args, **kw):
        raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate")


def inject_memory_error(monkeypatch, over: int):
    """Both packages' start-up trial fails for micro-batches above ``over``."""
    real_make = jdenoise.make_denoise_train_step

    def make(*args, grad_accum=1, **kw):
        step = real_make(*args, grad_accum=grad_accum, **kw)
        return _Oversized() if -(-4 // grad_accum) > over else step

    real_trial = tcommon.DenoiseTrainStep.trial

    def trial(self, batch, generator):
        if -(-batch["target"].shape[0] // self.grad_accum) > over:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real_trial(self, batch, generator)

    monkeypatch.setattr(jdenoise, "make_denoise_train_step", make)
    monkeypatch.setattr(tcommon.DenoiseTrainStep, "trial", trial)


def test_train_matches_jax_flow_under_a_memory_error(tmp_path, monkeypatch):
    """Flow matching over 3 epochs with checkpoints every 2 epochs and
    snapshots every 2; the trial at micro-batch 4 runs out of memory, and
    both packages halve it to 2 (accumulation 2)."""
    cfg = denoise_cfg(tmp_path, "flow_matching", num_epochs=3, checkpoint_every_epochs=2,
                      save_model_epochs=2)
    inject_memory_error(monkeypatch, over=2)
    jax_run, port_run, accums = _train_both(tmp_path, monkeypatch, "flow_matching", cfg)
    assert accums == [2]
    assert_runs_match(jax_run, port_run, "flow_last.pt", denoise_rate(cfg, 10))
    assert run_files(port_run) == ["epochs/epoch0002/epoch.pt", "epochs/epoch0003/epoch.pt",
                                   "flow_best.pt", "flow_last.pt", "metrics.csv",
                                   "train_config.json"]


# ---------------------------------------------------------------------------
# Start-up micro-batch tuning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,accum,over,allow", [
    (8, 1, 3, True), (8, 1, 1, True), (7, 2, 2, True), (6, 1, 0, True), (8, 1, 3, False),
])
def test_autotune_picks_jax_accumulation(batch, accum, over, allow, caplog):
    """The same accumulation, warnings and refusals as JAX's for a trial that
    runs out of memory above ``over`` rows (never fits when 0)."""
    def run(autotune, error):
        tried = []

        def trial(step, a):
            tried.append(a)
            if -(-batch // a) > over:
                raise error
        caplog.clear()
        try:
            out = autotune(lambda a: ("step", a), trial, batch_size=batch, grad_accum=accum,
                           allow_microbatching=allow)
        except Exception as err:  # noqa: BLE001 - compared below
            out = type(err)
        return out, tried, [r.getMessage().replace(type(error).__name__, "E") for r in caplog.records]

    want = run(jcommon.autotune_grad_accum, RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    got = run(tcommon.autotune_grad_accum, torch.OutOfMemoryError("CUDA out of memory"))
    assert got[1:] == want[1:]
    assert got[0] == want[0] or (isinstance(got[0], type) and issubclass(got[0], RuntimeError)
                                 and want[0] is RuntimeError)


def test_memory_errors_are_told_apart():
    assert tcommon.is_memory_error(torch.OutOfMemoryError("x"))
    assert tcommon.is_memory_error(RuntimeError("CUDA error: out of memory"))
    assert tcommon.is_memory_error(RuntimeError("CUBLAS_STATUS_ALLOC_FAILED when calling"))
    assert not tcommon.is_memory_error(RuntimeError("nvcc failed to build group_norm.cu"))
    assert not tcommon.is_memory_error(ValueError("out of memory"))
    with pytest.raises(RuntimeError, match="nvcc"):
        tcommon.autotune_grad_accum(lambda a: a, lambda s, a: (_ for _ in ()).throw(
            RuntimeError("nvcc failed")), batch_size=8, grad_accum=1)


def test_trial_leaves_no_trace(tmp_path):
    """A trial changes no weight, optimizer state, rate step, EMA or draw:
    a step after it equals a step of a fresh trainer bitwise."""
    cfg = denoise_cfg(tmp_path, "diffusion", ema_decay=0.9)
    batch = {"target": torch.rand(4, 1, SIDE, SIDE), "image": torch.rand(4, 1, SIDE, SIDE),
             "valid": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    results = []
    for with_trial in (True, False):
        _, _, trainer = tdenoise.build_denoise_trainer(cfg, variant="diffusion", num_samples=10,
                                                       device="cpu")
        before = [p.detach().clone() for p in trainer.model.parameters()]
        gen = torch.Generator().manual_seed(3)
        if with_trial:
            trainer.grad_accum = 2
            trainer.trial(batch, torch.Generator().manual_seed(0))
            trainer.grad_accum = 1
            assert all(torch.equal(p, b) for p, b in zip(trainer.model.parameters(), before))
            assert all(p.grad is None for p in trainer.model.parameters())
            assert not trainer.optimizer.state and trainer.global_step == 0
            assert all(torch.equal(e, b) for e, b in zip(trainer.ema, before))
        loss, _ = trainer.step(batch, generator=gen)
        results.append((loss, [p.detach() for p in trainer.model.parameters()], gen.get_state()))
    (loss_a, params_a, gen_a), (loss_b, params_b, gen_b) = results
    assert torch.equal(loss_a, loss_b) and torch.equal(gen_a, gen_b)
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


# ---------------------------------------------------------------------------
# A JAX run's optimizer state in the port
# ---------------------------------------------------------------------------

class _Leaf(torch.nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(shape))


class _Toy(torch.nn.Module):
    """Names whose string order differs from JAX's tree order ("a-b.w"
    sorts before "a.w" as a string, after it by components) and integer-like
    components past 9 ("layers.10" before "layers.2" in both orders); every
    parameter's shape differs, so a misplaced leaf is caught."""

    def __init__(self):
        super().__init__()
        self.add_module("a", _Leaf((3,)))
        self.add_module("a-b", _Leaf((2, 2)))
        self.layers = torch.nn.ModuleList([_Leaf((i + 4,)) for i in range(11)])


def _toy_jax_state(tmp_path, *, steps=2, optimizer=None):
    """Toy weights, and the state of ``optimizer`` (default: the JAX
    package's AdamW at its cosine-warmup rate) after ``steps`` updates on
    fixed gradients, written by the JAX package's checkpoint writer."""
    from fmdm_tpu.nn.module import unflatten_params as jax_unflatten
    from fmdm_tpu.train.common import make_adamw as jax_make_adamw
    from fmdm_tpu.utils import checkpoint as jckpt

    toy = _Toy()
    rng = np.random.default_rng(0)
    flat = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
            for n, p in toy.named_parameters()}
    grads = {n: rng.standard_normal(v.shape).astype(np.float32) for n, v in flat.items()}
    params = jax.tree_util.tree_map(jnp.asarray, jax_unflatten(flat))
    opt = optimizer or jax_make_adamw(1e-2, 1e-2, 1, 10)[0]
    state = opt.init(params)
    for _ in range(steps):
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, jax_unflatten(grads)),
                                    state, params)
        params = optax.apply_updates(params, updates)
    path = tmp_path / "jax.pt"
    jckpt.save_checkpoint({"model": params, "optimizer": state, "epoch": 1}, path)
    return toy, path, state, grads, opt, params


def test_jax_adamw_state_loads_by_tree_order(tmp_path):
    """mu and nu land on the parameters in tree_flatten's order, the step
    and the rate's step continue, and one more update equals optax's."""
    from fmdm_tpu.nn.module import unflatten_params as jax_unflatten

    toy, path, state, grads, opt, params = _toy_jax_state(tmp_path)
    names = [n for n, _ in toy.named_parameters()]
    assert sorted(names) != sorted(names, key=lambda n: tuple(n.split(".")))
    payload = tckpt.load_checkpoint(path)
    toy.load_state_dict(payload["model"])
    optimizer, rate = tcommon.make_adamw(toy.parameters(), 1e-2, 1e-2, 1, 10)
    assert tckpt.load_optimizer_state(optimizer, payload["optimizer"], toy) == 2
    mu = jax_flatten(state[0].mu)
    nu = jax_flatten(state[0].nu)
    for name, p in toy.named_parameters():
        st = optimizer.state[p]
        assert np.array_equal(st["exp_avg"].numpy(), np.asarray(mu[name])), name
        assert np.array_equal(st["exp_avg_sq"].numpy(), np.asarray(nu[name])), name
        assert int(st["step"]) == 2
    # one more update in both
    for name, p in toy.named_parameters():
        p.grad = torch.from_numpy(grads[name])
    for group in optimizer.param_groups:
        group["lr"] = rate(2)
    optimizer.step()
    updates, _ = opt.update(jax.tree_util.tree_map(jnp.asarray, jax_unflatten(grads)), state,
                            params)
    want = jax_flatten(optax.apply_updates(params, updates))
    for name, p in toy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_foreign_jax_optimizer_states_are_refused(tmp_path):
    toy, path, *_ = _toy_jax_state(tmp_path)
    entry = tckpt.load_checkpoint(path)["optimizer"]
    fresh = lambda: tcommon.make_adamw(toy.parameters(), 1e-2, 0.0, 1, 10)[0]  # noqa: E731
    n = len(list(toy.parameters()))
    # a count that disagrees
    bad = dict(entry, leaf_0=np.asarray(5, np.int32))
    with pytest.raises(ValueError, match="disagrees"):
        tckpt.load_optimizer_state(fresh(), bad, toy)
    # two leaves swapped (a shape that does not fit its position)
    swapped = dict(entry, leaf_1=entry["leaf_2"], leaf_2=entry["leaf_1"])
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_optimizer_state(fresh(), swapped, toy)
    # a parameter fewer (a VQ codebook's EMA split out of the optimized tree)
    fewer = {k: v for k, v in entry.items() if k != f"leaf_{2 * n + 1}"}
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_optimizer_state(fresh(), fewer, toy)
    # optax.adamw at a constant rate: no schedule count
    (tmp_path / "const").mkdir()
    _, const_path, *_ = _toy_jax_state(tmp_path / "const", optimizer=optax.adamw(1e-3))
    with pytest.raises(ValueError, match="JAX package"):
        tckpt.load_optimizer_state(fresh(), tckpt.load_checkpoint(const_path)["optimizer"], toy)
    # no model to order the leaves by
    with pytest.raises(ValueError, match="JAX package"):
        tckpt.load_optimizer_state(fresh(), entry)
