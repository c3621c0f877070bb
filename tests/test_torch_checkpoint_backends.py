"""The port's four checkpoint backends (``torch``, ``torch_async``, ``orbax``
as ``torch.distributed.checkpoint``, ``orbax_async``), mirroring
``tests/test_orbax_ckpt.py``: each round trip bitwise and an overwrite; the
async snapshot taken before ``save_checkpoint`` returns (the writer held
back until the live tensors were changed in place); the writer's error
re-raised by ``flush_checkpoint_writes``; a failed async save leaving no
clone; a clone surviving an overwrite of its source; a JAX orbax directory
refused with the way across. Then a two-level UNet of the flagship's
topology trained for two epochs and resumed from its epoch-1 snapshot under
each backend, on JAX's draws: the resumed weights are bitwise the ``torch``
backend's, and within the train-loop tolerance of the JAX package's run
under the same backend name."""

import copy
import threading

import numpy as np
import pytest
import torch

from fmdm_tpu.nn.module import flatten_params as jax_flatten
from fmdm_tpu.train import denoise_lib as jdenoise
from fmdm_tpu.utils import checkpoint as jckpt
from fmdm_tpu.utils import orbax_ckpt as jorbax
from fmdm_tpu_torch.train import denoise_lib as tdenoise
from fmdm_tpu_torch.utils import checkpoint as tckpt
from fmdm_tpu_torch.utils import orbax_ckpt as torbax
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_train_loop import (Recorder, assert_trees_close, denoise_cfg,
                                         denoise_draws, denoise_rate, optimizer_step,
                                         replay_denoise_steps, share_initial_weights,
                                         summed_rates, tiny, truncate_to_epoch, write_cfg)

BACKENDS = ("torch", "torch_async", "orbax", "orbax_async")
ASYNC = ("torch_async", "orbax_async")


def _restore_default_backends():
    """Both packages keep the selected backend in a module global, and each
    trainer sets it from its config: put both back to ``torch`` so later
    tests in the same process save single files."""
    try:
        tckpt.flush_checkpoint_writes()
        jckpt.flush_checkpoint_writes()
    finally:
        tckpt.set_checkpoint_backend("torch")
        jckpt.set_checkpoint_backend("torch")


@pytest.fixture(autouse=True)
def _reset_backend():
    yield
    _restore_default_backends()


def _live_state(seed: int = 0):
    """A module after one AdamW step, its EMA, a discriminator's weights
    under ``extra_state``, a generator's state and scalars: every kind of
    entry the trainers save."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(2, 4, 3), torch.nn.GroupNorm(2, 4))
    disc = torch.nn.Linear(3, 2)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-2)
    model(torch.randn(2, 2, 5, 5)).square().mean().backward()
    optimizer.step()
    state = {"model": model, "optimizer": optimizer,
             "ema": {k: v.detach().clone() * 0.5 for k, v in model.state_dict().items()},
             "extra_state": {"disc_params": {k: v.detach() for k, v in
                                              disc.state_dict().items()}},
             "lr_scheduler": {"last_epoch": seed}, "scaler": None, "epoch": seed,
             "best_metric": 0.25 + seed, "note": "hello",
             "rng_state": {"device": "cpu", "state": torch.Generator().manual_seed(seed)
                           .get_state()}}
    return state, model, optimizer, disc


def _expected(state, model, optimizer, disc):
    """What the file must hold: copies of the live values now."""
    return {"model": {k: v.clone() for k, v in model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state["ema"].items()},
            "disc": {k: v.clone() for k, v in disc.state_dict().items()},
            "optimizer": copy.deepcopy(optimizer.state_dict()),
            "epoch": state["epoch"], "best_metric": state["best_metric"]}


def _assert_holds(path, want):
    got = tckpt.load_checkpoint(path)
    for key in ("model", "ema"):
        assert got[key].keys() == want[key].keys()
        for name, value in want[key].items():
            assert got[key][name].dtype == value.dtype
            assert torch.equal(got[key][name], value), (key, name)
    for name, value in want["disc"].items():
        assert torch.equal(got["extra_state"]["disc_params"][name], value), name
    opt = got["optimizer"]
    assert opt["param_groups"] == want["optimizer"]["param_groups"]
    for i, state in want["optimizer"]["state"].items():
        for k, v in state.items():
            assert torch.equal(opt["state"][i][k], v), (i, k)
    assert (got["epoch"], got["best_metric"], got["note"]) == (want["epoch"],
                                                                want["best_metric"], "hello")
    assert got["scaler"] is None and got["lr_scheduler"] == {"last_epoch": want["epoch"]}
    return got


@pytest.mark.parametrize("backend", BACKENDS)
def test_round_trip_is_bitwise_and_overwrites(tmp_path, backend):
    path = tmp_path / "diff_last.pt"
    for seed in (1, 2):   # the second save overwrites the first
        live = _live_state(seed)
        want = _expected(*live)
        tckpt.save_checkpoint(live[0], path, backend=backend)
        tckpt.flush_checkpoint_writes()
        got = _assert_holds(path, want)
        torch.optim.AdamW(live[1].parameters(), lr=1e-3).load_state_dict(got["optimizer"])
    assert path.is_dir() == backend.startswith("orbax")
    if backend.startswith("orbax"):
        assert torbax.is_orbax_checkpoint(path)
        assert sorted(p.name for p in path.iterdir()) == [".metadata", "__0_0.distcp"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["diff_last.pt"]   # no stray temps
    tckpt.set_checkpoint_backend(backend)   # the selected backend is the default
    tckpt.save_checkpoint(_live_state(3)[0], tmp_path / "b.pt")
    tckpt.flush_checkpoint_writes()
    assert (tmp_path / "b.pt").is_dir() == backend.startswith("orbax")
    assert tckpt.get_checkpoint_backend() == backend


@pytest.mark.parametrize("backend", ASYNC)
def test_async_save_snapshots_before_it_returns(tmp_path, backend):
    """The writer is held back until every live tensor (CPU storage) was
    changed in place: the file holds the values at the call."""
    state, model, optimizer, disc = _live_state(4)
    want = _expected(state, model, optimizer, disc)
    gate = threading.Event()
    tckpt._submit(gate.wait)   # the writer thread is busy until the gate opens
    tckpt.save_checkpoint(state, tmp_path / "ck.pt", backend=backend)
    model(torch.randn(2, 2, 5, 5)).square().mean().backward()
    optimizer.step()   # moments, step counts and weights change in place
    with torch.no_grad():
        for t in list(state["ema"].values()) + list(disc.parameters()):
            t.add_(1.0)
    state["rng_state"]["state"].zero_()
    assert not torch.equal(next(model.parameters()), next(iter(want["model"].values())))
    gate.set()
    tckpt.flush_checkpoint_writes()
    got = _assert_holds(tmp_path / "ck.pt", want)
    assert torch.equal(got["rng_state"]["state"],
                       torch.Generator().manual_seed(4).get_state())


def test_flush_reraises_the_writers_error(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    for backend in ASYNC:
        tckpt.save_checkpoint({"epoch": 1}, tmp_path / "file" / "ck.pt", backend=backend)
    with pytest.raises(OSError):
        tckpt.flush_checkpoint_writes()
    tckpt.flush_checkpoint_writes()   # the failed writes are not pending any more


@pytest.mark.parametrize("backend", ASYNC)
def test_a_failed_async_save_leaves_no_clone(tmp_path, backend):
    primary, best = tmp_path / "vae_last.pt", tmp_path / "vae_best.pt"
    live = _live_state(5)
    want = _expected(*live)
    tckpt.save_checkpoint(live[0], primary, backend=backend.split("_")[0])
    bad = dict(_live_state(6)[0], note=lambda: None)   # cannot be pickled
    tckpt.save_checkpoint_with_mirrors(bad, primary, [best], backend=backend)
    with pytest.raises(Exception, match="pickle|lambda"):
        tckpt.flush_checkpoint_writes()
    assert not best.exists()
    _assert_holds(primary, want)   # the earlier checkpoint is intact


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_clone_survives_an_overwrite_of_its_source(tmp_path, backend):
    src, dst, epoch = tmp_path / "last.pt", tmp_path / "best.pt", tmp_path / "e" / "epoch.pt"
    first = _live_state(7)
    want_first = _expected(*first)
    tckpt.save_checkpoint_with_mirrors(first[0], src, [epoch], backend=backend)
    tckpt.clone_checkpoint(src, dst, backend=backend)
    second = _live_state(8)
    want_second = _expected(*second)
    tckpt.save_checkpoint(second[0], src, backend=backend)
    tckpt.flush_checkpoint_writes()
    _assert_holds(dst, want_first)
    _assert_holds(epoch, want_first)
    _assert_holds(src, want_second)


def test_a_jax_orbax_directory_is_refused(tmp_path):
    """The JAX package's orbax directory (OCDBT, written here by its own
    backend) raises a ValueError naming the torch backend as the way
    across; the JAX package reads it, and a file it saves with the torch
    backend loads in the port."""
    params = {"conv": {"weight": np.arange(8, dtype=np.float32).reshape(2, 4)}}
    path = tmp_path / "diff_last.pt"
    jorbax.save_checkpoint({"model": params, "epoch": 3, "best_metric": 0.5}, path)
    assert path.is_dir() and not torbax.is_orbax_checkpoint(path)
    for load in (tckpt.load_checkpoint, tckpt.load_model_params, tckpt.maybe_load_checkpoint):
        with pytest.raises(ValueError, match="JAX package's orbax checkpoint.*'torch' checkpoint "
                                             "backend"):
            load(path)
    assert tckpt.latest_checkpoint(tmp_path, "diff") == path
    across = tmp_path / "across.pt"
    jckpt.save_checkpoint(jckpt.load_checkpoint(path), across, backend="torch")
    got = tckpt.load_checkpoint(across)
    assert torch.equal(got["model"]["conv.weight"], torch.from_numpy(params["conv"]["weight"]))
    assert got["epoch"] == 3
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="not a checkpoint"):
        tckpt.load_checkpoint(tmp_path / "empty")


def test_a_dcp_directory_serves_every_loader(tmp_path):
    live = _live_state(9)
    path = tmp_path / "vae_best.pt"
    tckpt.save_checkpoint(live[0], path, backend="orbax")
    assert tckpt.latest_checkpoint(tmp_path, "vae") == path
    epoch, best, payload = tckpt.maybe_load_checkpoint(path)
    assert (epoch, best) == (10, 9.25) and payload["note"] == "hello"
    params = tckpt.load_model_params(path, expected=live[1])
    assert all(torch.equal(params[k], v) for k, v in live[1].state_dict().items())


# ---------------------------------------------------------------------------
# Training and resuming under each backend, against JAX's run
# ---------------------------------------------------------------------------

def _jax_weights(path):
    """The model and EMA of a JAX run's checkpoint (either JAX backend), as
    flat numpy trees."""
    payload = jckpt.load_checkpoint(path)
    return {"model": {n: np.asarray(v) for n, v in jax_flatten(payload["model"]).items()}}


def _port_weights(path):
    payload = tckpt.load_checkpoint(path)
    return {"model": dict(payload["model"])}


@pytest.fixture(scope="module")
def backend_runs(tmp_path_factory):
    """Per backend: JAX's two epochs, the port's two epochs on JAX's draws,
    and the port's epoch 2 resumed from its own epoch-1 snapshot."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("backends")
    runs = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            recorder = Recorder(mp, denoise_draws("diffusion", 50))
            share_initial_weights(mp)
            replay_denoise_steps(mp, recorder.draws)   # the port pops what JAX recorded
            for backend in BACKENDS:
                # no EMA: the JAX package's orbax backend cannot save an `ema` tree
                cfg = denoise_cfg(tmp, "diffusion", checkpoint_backend=backend)
                out = {"cfg": cfg}
                for pkg, lib in (("jax", jdenoise), ("port", tdenoise)):
                    pkg_cfg = copy.deepcopy(cfg)
                    pkg_cfg["training"]["output_dir"] = str(tmp / f"{backend}_{pkg}")
                    path = write_cfg(tmp / f"{backend}_{pkg}.json", pkg_cfg)
                    if pkg == "port":
                        draws = list(recorder.draws)
                    out[pkg] = lib.train(tiny(pkg, tmp / "data"), path, variant="diffusion",
                                         **({"device": "cpu"} if pkg == "port" else {}))
                assert not recorder.draws
                resumed = truncate_to_epoch(out["port"], tmp / f"{backend}_resumed", 1)
                cfg_r = copy.deepcopy(cfg)
                cfg_r["training"]["output_dir"] = str(resumed)
                recorder.draws.extend(draws[len(draws) // 2:])   # epoch 2's draws again
                out["resumed"] = tdenoise.train(
                    tiny("port", tmp / "data"), write_cfg(tmp / f"{backend}_r.json", cfg_r),
                    resume=str(resumed / "epochs" / "epoch0001" / "epoch.pt"),
                    variant="diffusion", device="cpu")
                assert not recorder.draws
                runs[backend] = out
    finally:
        torch.set_num_threads(threads)
        _restore_default_backends()
    return runs


@pytest.mark.parametrize("backend", BACKENDS)
def test_training_resumes_under_each_backend(backend_runs, backend):
    run = backend_runs[backend]
    ref = backend_runs["torch"]
    last = run["resumed"] / "diff_last.pt"
    assert last.is_dir() == backend.startswith("orbax")
    payload = tckpt.load_checkpoint(last)
    assert payload["epoch"] == 2 and optimizer_step(payload) == 6
    got = _port_weights(last)
    for r in (run["port"] / "diff_last.pt", ref["resumed"] / "diff_last.pt"):
        want = _port_weights(r)   # bitwise: the straight run and the torch backend's
        for key in want:
            assert got[key].keys() == want[key].keys()
            assert all(torch.equal(got[key][n], want[key][n]) for n in want[key]), (key, r)
    jax_last = run["jax"] / "diff_last.pt"
    assert jax_last.is_dir() == backend.startswith("orbax")
    want = _jax_weights(jax_last)
    bound = 2 * summed_rates(denoise_rate(run["cfg"], 10), 6)
    assert_trees_close({n: v.numpy() for n, v in got["model"].items()}, want["model"], bound)
    for name in ("diff_best.pt", "epochs/epoch0002/epoch.pt"):
        assert (run["resumed"] / name).exists()
