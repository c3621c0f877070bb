"""DeepCache in the port against the JAX package, on the CPU in f32: the
deep/shallow splice of ``UNetDiffusersND.forward`` at every valid depth,
the refresh mask, the engine's cached sampling, the ``--deep_cache`` flag
grammar, the ``auto`` quality budget (the same candidate as JAX on JAX's
draws, and exact when nothing fits), the decode path's refusals and
fallbacks, and ``evaluate`` resolving ``auto`` end to end.

A spliced forward fed the feature captured at the same (x, t) runs the same
operations as the full forward, so the port holds it bitwise; against JAX
the tolerance is ``F32_TOL`` (sums in another order).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu import run_model as jrm
from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.sample import engine as jengine
from fmdm_tpu.schedulers import DDIMScheduler as JaxDDIM
from fmdm_tpu_torch import run_model as trm
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.sample import diffusion_utils as tdu
from fmdm_tpu_torch.sample import engine as tengine
from fmdm_tpu_torch.schedulers import DDIMScheduler
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_efficient_unet import REDUCED as EFFICIENT_UNET
from tests.test_torch_models import F32_TOL, REDUCED_UNET, _normal, _pair
from tests.test_torch_run_model import runs  # noqa: F401

# the flagship's six-level topology at reduced width: depths 1-5
SIDE = 32
# three levels, the last with attention: the JAX scans compile quickly
SMALL = {"unet_impl": "diffusers_nd", "sample_size": 16, "in_channels": 1, "out_channels": 1,
         "layers_per_block": 1, "norm_num_groups": 4, "block_out_channels": [8, 16, 16],
         "down_block_types": ["DownBlock2D", "DownBlock2D", "AttnDownBlock2D"],
         "up_block_types": ["AttnUpBlock2D", "UpBlock2D", "UpBlock2D"]}
# two levels: the auto tests' many decodes stay cheap
TINY = {"unet_impl": "diffusers_nd", "sample_size": 16, "in_channels": 1, "out_channels": 1,
        "layers_per_block": 1, "norm_num_groups": 4, "block_out_channels": [8, 16],
        "down_block_types": ["DownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "UpBlock2D"]}
AUTO_STEPS = 10   # enough steps that the four candidates' masks differ
TRAINING = {"num_train_timesteps": 50}
MODEL_CFG = {"scheduler": {"name": "ddim"}}


@pytest.fixture(autouse=True)
def _deep_cache_off(monkeypatch):
    monkeypatch.setattr(jdu, "_DP_SAMPLING", False)
    yield
    tdu.set_deep_cache(None)
    jdu.set_deep_cache(None)
    tdu._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def flagship():
    return _models(REDUCED_UNET, 50)


def _models(cfg, seed):
    jm = JaxFactory().build(cfg, conditioning=None, channels=1)
    tm = DiffusionUNetFactory().build(cfg, conditioning=None, channels=1, device="cpu")
    params, tm = _pair(jm, tm, seed=seed)
    return jm, params, tm


@pytest.fixture(scope="module")
def small():
    return _models(SMALL, 49)


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY, 51)


def _inputs(seed, batch=2, side=SIDE):
    rng = np.random.default_rng(seed)
    return _normal(rng, batch, 1, side, side), np.array([7, 930][:batch], np.int32)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_splice_matches_the_full_forward_and_jax(flagship, depth):
    jm, params, tm = flagship
    x, t = _inputs(52)
    jx, jt = jnp.asarray(x), jnp.asarray(t)

    @jax.jit
    def capture_and_splice(p, x, t):
        _, feat = jm(p, x, t, cache_depth=depth, return_deep_feature=True)
        return feat, jm(p, x, t, deep_cache=feat, cache_depth=depth)

    j_feat, j_spliced = capture_and_splice(params, jx, jt)
    with torch.no_grad():
        full = tm(torch.from_numpy(x), torch.from_numpy(t))
        out, feat = tm(torch.from_numpy(x), torch.from_numpy(t), cache_depth=depth,
                       return_deep_feature=True)
        spliced = tm(torch.from_numpy(x), torch.from_numpy(t), deep_cache=feat, cache_depth=depth)
    assert torch.equal(out, full) and torch.equal(spliced, full)
    assert feat.shape == j_feat.shape
    np.testing.assert_allclose(feat.numpy(), np.asarray(j_feat), **F32_TOL)
    np.testing.assert_allclose(spliced.numpy(), np.asarray(j_spliced), **F32_TOL)


def test_invalid_depths_raise(flagship):
    _, _, tm = flagship
    x, t = torch.zeros(1, 1, SIDE, SIDE), torch.tensor([0])
    for depth in (None, 0, 6):
        with pytest.raises(ValueError, match="cache_depth"):
            tm(x, t, cache_depth=depth, return_deep_feature=True)
    for depth in (None, 0, 6, -1):
        with pytest.raises(ValueError, match="cache_depth"):
            tm(x, t, deep_cache=x, cache_depth=depth)


def test_refresh_mask_matches_jax():
    for n in (1, 2, 3, 7, 10, 25, 50, 100):
        for interval in range(1, 7):
            for schedule in ("uniform", "adaptive"):
                got = tengine.deep_cache_refresh_mask(n, interval, schedule)
                want = jengine.deep_cache_refresh_mask(n, interval, schedule)
                assert got.dtype == bool and np.array_equal(got, want), (n, interval, schedule)
    assert tengine.deep_cache_refresh_mask(50, 3, "uniform").sum() == 17
    assert tengine.deep_cache_refresh_mask(50, 3, "adaptive").sum() == 25
    with pytest.raises(ValueError, match="schedule"):
        tengine.deep_cache_refresh_mask(10, 2, "sometimes")


def _engine(model, steps, deep_cache=None):
    sched = DDIMScheduler.create(num_train_timesteps=50)
    return tengine.SamplingEngine(model, sched, sched.set_timesteps(steps),
                                  deep_cache=deep_cache, device="cpu")


def test_interval_one_equals_the_uncached_engine(flagship):
    _, _, tm = flagship
    init = torch.from_numpy(_inputs(53)[0])
    base = _engine(tm, 6)(tuple(init.shape), init_sample=init)
    for schedule in ("adaptive", "uniform"):
        for depth in (1, 3):
            cached = _engine(tm, 6, (1, depth, schedule))(tuple(init.shape), init_sample=init)
            assert torch.equal(cached, base)


@pytest.mark.parametrize("setting", [(3, 1), (2, 2, "uniform")], ids=["3:1", "2:2:uniform"])
def test_cached_sample_matches_jax(small, setting):
    """9 DDIM steps from the same initial noise: the cached engine's sample
    against JAX's scan (staleness is the same in both), and away from the
    exact sample."""
    jm, params, tm = small
    init = _inputs(54, side=16)[0]
    sched = JaxDDIM.create(num_train_timesteps=50)
    jengine_cached = jengine.SamplingEngine(jm, sched, sched.set_timesteps(9), deep_cache=setting)
    want = np.asarray(jengine_cached(params, init.shape, jax.random.PRNGKey(0),
                                     init_sample=jnp.asarray(init)))
    got = _engine(tm, 9, setting)(init.shape, init_sample=torch.from_numpy(init))
    exact = _engine(tm, 9)(init.shape, init_sample=torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert torch.isfinite(got).all() and not torch.equal(got, exact)


def test_flag_grammar_matches_jax():
    for value in (None, "3", "3:2", "5:1:uniform", "4::uniform", "2:1:adaptive", "auto", "auto:",
                  "auto:0.25", "auto:3"):
        assert trm._parse_deep_cache(value) == jrm._parse_deep_cache(value), value
    for bad in ("3:1:sometimes", "auto:0", "auto:-1", "x"):
        for parse in (trm._parse_deep_cache, jrm._parse_deep_cache):
            with pytest.raises(ValueError):
                parse(bad)


def test_set_deep_cache_installs_and_clears():
    tdu.set_deep_cache((3, 1))
    assert tdu._DEEP_CACHE == (3, 1)
    tdu.set_deep_cache(["auto", 0.5])
    assert tdu._deep_cache_is_auto(tdu._DEEP_CACHE)
    for off in (None, ()):
        tdu.set_deep_cache(off)
        assert tdu._DEEP_CACHE is None
    assert tdu._AUTO_CANDIDATES == jdu._AUTO_CANDIDATES


def _targets():
    return np.random.default_rng(55).random((2, 1, 16, 16)).astype(np.float32)


def _jax_init_noise(rng, shape):
    """The unscaled start noise of JAX's decode_diffusion_batch from ``rng``:
    its key splits into the reference noise's and the engine's, the engine's
    into the start noise's and the steps'."""
    _, k_sample = jax.random.split(rng)
    k_init, _ = jax.random.split(k_sample)
    return torch.from_numpy(np.array(jax.random.normal(k_init, shape, jnp.float32)))


def test_auto_picks_the_same_candidate_as_jax(tiny, monkeypatch):
    """JAX's probes and the port's decode the same start noise (JAX's,
    replayed): the PSNR each candidate costs agrees, and at budgets just
    above each cost both packages install the same candidate."""
    jm, params, tm = tiny
    targets = _targets()
    rng = jax.random.PRNGKey(56)
    noise = _jax_init_noise(rng, targets.shape)
    real_decode = tdu.decode_diffusion_batch
    monkeypatch.setattr(tdu, "decode_diffusion_batch",
                        lambda *a, **kw: real_decode(*a, init_noise=noise, **kw))

    def psnr(out):
        mse = float(np.mean((np.clip(np.asarray(out), 0, 1) - targets) ** 2))
        return 10 * np.log10(1 / max(mse, 1e-12))

    costs = {}
    for setting in (None,) + tdu._AUTO_CANDIDATES:
        jdu.set_deep_cache(setting)
        tdu.set_deep_cache(setting)
        want = jdu.decode_diffusion_batch(jm, params, TRAINING, MODEL_CFG, targets.shape, rng=rng,
                                          num_inference_steps=AUTO_STEPS)
        got = tdu.decode_diffusion_batch(tm, TRAINING, MODEL_CFG, targets.shape, device="cpu",
                                         num_inference_steps=AUTO_STEPS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        costs[setting] = (psnr(want), psnr(got))
    drops = {c: (costs[None][0] - costs[c][0], costs[None][1] - costs[c][1])
             for c in tdu._AUTO_CANDIDATES}
    for jax_drop, port_drop in drops.values():
        assert port_drop == pytest.approx(jax_drop, abs=1e-3)
    assert len({round(d[0], 6) for d in drops.values()}) > 1   # the candidates differ

    for budget in sorted({d[0] + 1e-3 for d in drops.values() if d[0] + 1e-3 > 0}):
        expected = next(c for c in tdu._AUTO_CANDIDATES if drops[c][0] <= budget)
        jdu.set_deep_cache(("auto", budget))
        tdu.set_deep_cache(("auto", budget))
        chosen = (jdu.resolve_auto_deep_cache(jm, params, TRAINING, MODEL_CFG, targets, rng=rng,
                                              num_inference_steps=AUTO_STEPS),
                  tdu.resolve_auto_deep_cache(tm, TRAINING, MODEL_CFG, torch.from_numpy(targets),
                                              num_inference_steps=AUTO_STEPS, device="cpu"))
        assert chosen == (expected, expected) and tdu._DEEP_CACHE == expected, budget


def test_auto_probes_decode_the_same_draws(tiny):
    """Each probe restarts the generator, so the candidates differ only by
    their cache; resolving leaves nothing installed but the choice."""
    _, _, tm = tiny
    seen = []
    real_decode = tdu.decode_diffusion_batch

    def recording(*args, generator=None, **kw):
        seen.append(generator.get_state().clone())
        return real_decode(*args, generator=generator, **kw)

    tdu.set_deep_cache(("auto", 99.0))
    gen = torch.Generator().manual_seed(57)
    try:
        tdu.decode_diffusion_batch = recording
        chosen = tdu.resolve_auto_deep_cache(tm, TRAINING, MODEL_CFG, torch.from_numpy(_targets()),
                                             num_inference_steps=3, generator=gen, device="cpu")
    finally:
        tdu.decode_diffusion_batch = real_decode
    assert chosen == tdu._AUTO_CANDIDATES[0] == tdu._DEEP_CACHE
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])


def test_auto_falls_back_to_exact_when_nothing_fits(tiny, monkeypatch, caplog):
    """Every candidate costs more than the budget (the decode replaced by
    one whose PSNR drops by a set amount per interval): exact, with a warning."""
    _, _, tm = tiny
    targets = np.full((2, 1, 16, 16), 0.5, np.float32)
    cost = {5: 5.0, 4: 4.0, 3: 3.0, 2: 2.0}

    def fake(*args, **kw):
        setting = tdu._DEEP_CACHE
        if setting is None:
            return torch.from_numpy(targets)
        delta = np.sqrt(10.0 ** (-(120.0 - cost[setting[0]]) / 10.0))
        return torch.from_numpy(targets + np.float32(delta))

    monkeypatch.setattr(tdu, "decode_diffusion_batch", fake)
    tdu.set_deep_cache(("auto", 0.5))
    with caplog.at_level(logging.WARNING):
        assert tdu.resolve_auto_deep_cache(tm, TRAINING, MODEL_CFG, torch.from_numpy(targets),
                                           device="cpu") is None
    assert tdu._DEEP_CACHE is None and "running EXACT" in caplog.text
    tdu.set_deep_cache(("auto", 2.5))
    assert tdu.resolve_auto_deep_cache(tm, TRAINING, MODEL_CFG, torch.from_numpy(targets),
                                       device="cpu") == (2, 1, "adaptive")
    tdu.set_deep_cache((4, 1))   # no auto setting pending: a no-op
    assert tdu.resolve_auto_deep_cache(tm, TRAINING, MODEL_CFG, torch.from_numpy(targets),
                                       device="cpu") == (4, 1)


def test_unresolved_auto_refuses_to_decode(tiny):
    _, _, tm = tiny
    tdu.set_deep_cache(("auto", 0.5))
    with pytest.raises(RuntimeError, match="deep_cache auto"):
        tdu.decode_diffusion_batch(tm, TRAINING, MODEL_CFG, (1, 1, 16, 16), device="cpu",
                                   num_inference_steps=2)


def test_decode_path_honors_deep_cache(tiny):
    """A cached engine per setting, the setting in the cache key."""
    _, _, tm = tiny
    outs = {}
    for setting in (None, (3, 1)):
        tdu.set_deep_cache(setting)
        outs[setting] = tdu.decode_diffusion_batch(
            tm, TRAINING, MODEL_CFG, (2, 1, 16, 16), device="cpu", num_inference_steps=6,
            generator=torch.Generator().manual_seed(0))
    engines = {key[-1]: e for key, e in tdu._ENGINE_CACHE.items()}
    assert engines.keys() == {None, (3, 1)} and engines[(3, 1)].deep_cache == (3, 1)
    assert torch.isfinite(outs[(3, 1)]).all() and not torch.equal(outs[(3, 1)], outs[None])


def test_efficient_unet_decode_warns_and_stays_exact(caplog):
    tm = DiffusionUNetFactory().build(EFFICIENT_UNET, conditioning=None, channels=1,
                                      device="cpu").eval()
    outs = {}
    for setting in (None, (3, 1, "adaptive")):
        tdu.set_deep_cache(setting)
        with caplog.at_level(logging.WARNING):
            outs[setting] = tdu.decode_diffusion_batch(
                tm, TRAINING, MODEL_CFG, (1, 1, 16, 16), device="cpu", num_inference_steps=4,
                generator=torch.Generator().manual_seed(1))
    assert "EfficientUNetND has no deep/shallow split; ignoring" in caplog.text
    assert torch.equal(outs[(3, 1, "adaptive")], outs[None])
    assert {key[-1] for key in tdu._ENGINE_CACHE} == {None}


def test_evaluate_resolves_auto_end_to_end(runs, tmp_path, capsys):  # noqa: F811
    """``run_model --mode evaluate --deep_cache auto:99`` on a run dir:
    resolved on the first batch of references to the most aggressive
    candidate before the timed loop, and the run completes with it."""
    trm.main(["--ckpt_dir", str(runs["diffusion"]), "--mode", "evaluate", "--device", "cpu",
              "--num_samples", "4", "--batch_size", "2", "--num_inference_steps", str(AUTO_STEPS),
              "--deep_cache", "auto:99", "--output_dir", str(tmp_path)])
    assert tdu._DEEP_CACHE == tdu._AUTO_CANDIDATES[0]
    assert "deep_cache auto:99 resolved to interval=5 depth=1 schedule=adaptive" in \
        capsys.readouterr().err
    (exp,) = tmp_path.iterdir()
    rows = (exp / "eval_metrics.csv").read_text().splitlines()
    assert len(rows) == 2
    assert {key[-1] for key in tdu._ENGINE_CACHE} >= {None, tdu._AUTO_CANDIDATES[0]}
