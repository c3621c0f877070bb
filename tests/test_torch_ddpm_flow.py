"""The port's DDPM and flow-matching schedulers, its scheduler registry and
its sampling engine under a stochastic scheduler, against the JAX package's.

Model outputs and samples are numpy, seeded, and handed to both sides; the
step noise is JAX's own ``jax.random.normal(key, ...)``, handed to the port
as ``noise=``. The tables and coefficients are f32 on both sides and each
step is a few elementwise f32 operations: held at rtol 1e-6 (with an atol of
1e-6 for elements near 0).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.sample.engine import SamplingEngine as JaxEngine
from fmdm_tpu.schedulers import DDPMScheduler as JaxDDPM
from fmdm_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlow
from fmdm_tpu.schedulers import registry as jax_registry
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.sample.engine import SamplingEngine, sample_with_scheduler, step_generator
from fmdm_tpu_torch.schedulers import (
    SCHEDULER_REGISTRY, DDPMScheduler, DPMSolverMultistepScheduler,
    FlowMatchEulerDiscreteScheduler, build_scheduler, resolve_scheduler_override)
from tests.oracles.diffusers_numpy import NpDDPM
from tests.test_torch_models import REDUCED_UNET, _pair
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401

STEP_TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE = (2, 1, 8, 8)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_noise(key, shape):
    return np.array(jax.random.normal(key, shape, dtype=jnp.float32))


def test_ddpm_add_noise_matches_jax():
    kw = dict(beta_start=0.0001, beta_end=0.02)
    js, ts = JaxDDPM.create(**kw), DDPMScheduler.create(**kw)
    rng = np.random.default_rng(0)
    x0, noise = _normal(rng, 4, 1, 4, 4), _normal(rng, 4, 1, 4, 4)
    t = np.array([0, 1, 500, 999], np.int32)
    want = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


@pytest.mark.parametrize("spacing,steps,offset", [
    ("leading", 50, 0), ("leading", 7, 1), ("linspace", 10, 0), ("trailing", 13, 0),
    ("leading", 1000, 0)])
def test_ddpm_set_timesteps_matches_jax(spacing, steps, offset):
    kw = dict(timestep_spacing=spacing, steps_offset=offset)
    np.testing.assert_array_equal(DDPMScheduler.create(**kw).set_timesteps(steps),
                                  JaxDDPM.create(**kw).set_timesteps(steps))


@pytest.mark.parametrize("kw", [
    {},                                                        # epsilon, fixed_small, clip
    {"variance_type": "fixed_large"},
    {"prediction_type": "sample", "clip_sample": False},
    {"prediction_type": "v_prediction", "beta_schedule": "scaled_linear"},
    {"thresholding": True, "sample_max_value": 1.5},           # before clip_sample
    {"timestep_spacing": "trailing", "clip_sample_range": 2.0},
])
def test_ddpm_steps_match_jax_with_its_noise(kw):
    """Every step of a 6-step schedule, which ends at t = 0 (no noise added),
    on the same sample and model output on both sides, JAX's noise injected;
    also pinned to the float64 numpy oracle of diffusers' step."""
    cfg = dict(beta_start=0.0001, beta_end=0.02, **kw)
    js, ts = JaxDDPM.create(**cfg), DDPMScheduler.create(**cfg)
    timesteps = ts.set_timesteps(6)
    np.testing.assert_array_equal(timesteps, js.set_timesteps(6))
    oracle = NpDDPM(**cfg)
    oracle.set_timesteps(6)
    rng = np.random.default_rng(1)
    keys = jax.random.split(jax.random.PRNGKey(2), len(timesteps))
    jt = jnp.asarray(timesteps)
    for i, t in enumerate(timesteps):
        x = 1.5 * _normal(rng, *SHAPE)
        out = (0.8 * x + 0.3 * rng.standard_normal(SHAPE)).astype(np.float32)
        _, want = js.step({}, jnp.asarray(out), i, jnp.asarray(x), jt, rng=keys[i])
        noise = _jax_noise(keys[i], SHAPE)
        _, got = ts.step({}, torch.from_numpy(out), i, torch.from_numpy(x), timesteps,
                         noise=torch.from_numpy(noise))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL, err_msg=f"t={t}")
        np.testing.assert_allclose(got.numpy(), oracle.step(out.astype(np.float64), t,
                                                            x.astype(np.float64), noise),
                                   rtol=1e-5, atol=1e-5, err_msg=f"oracle t={t}")
    assert timesteps[-1] == 0 or kw.get("timestep_spacing") == "trailing"


def test_ddpm_step_noise_only_while_t_positive_and_needs_a_source():
    ts = DDPMScheduler.create()
    timesteps = ts.set_timesteps(4)
    x = torch.zeros(SHAPE)
    out = torch.ones(SHAPE)
    assert ts.needs_noise
    _, a = ts.step({}, out, 3, x, timesteps, noise=torch.zeros(SHAPE))
    _, b = ts.step({}, out, 3, x, timesteps, noise=torch.ones(SHAPE))
    assert timesteps[3] == 0 and torch.equal(a, b)
    _, c = ts.step({}, out, 0, x, timesteps, generator=torch.Generator().manual_seed(0))
    _, d = ts.step({}, out, 0, x, timesteps, generator=torch.Generator().manual_seed(0))
    assert torch.equal(c, d)
    with pytest.raises(ValueError, match="generator or a noise"):
        ts.step({}, out, 0, x, timesteps)


@pytest.mark.parametrize("kw,error", [
    ({"variance_type": "learned"}, NotImplementedError),
    ({"trained_betas": [0.1]}, NotImplementedError),
    ({"rescale_betas_zero_snr": True}, NotImplementedError),
    ({"timestep_spacing": "karras"}, ValueError),
])
def test_ddpm_refuses_what_jax_refuses(kw, error):
    with pytest.raises(error):
        JaxDDPM.create(**kw)
    with pytest.raises(error):
        DDPMScheduler.create(**kw)


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_flow_match_matches_jax(shift):
    js = JaxFlow.create(shift=shift)
    ts = FlowMatchEulerDiscreteScheduler.create(shift=shift)
    timesteps = ts.set_timesteps(8)
    want_t = js.set_timesteps(8)
    assert timesteps.dtype == want_t.dtype == np.float32
    np.testing.assert_array_equal(timesteps, want_t)
    rng = np.random.default_rng(3)
    x0, noise = _normal(rng, *SHAPE), _normal(rng, *SHAPE)
    t = timesteps[[0, 3]]
    np.testing.assert_allclose(
        ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t)).numpy(),
        np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))), **STEP_TOL)
    assert not ts.needs_noise
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jt = jnp.asarray(timesteps)
    for i in range(len(timesteps)):
        out = _normal(rng, *SHAPE)
        _, jx = js.step({}, jnp.asarray(out), i, jx, jt)
        _, tx = ts.step({}, torch.from_numpy(out), i, tx, timesteps)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **STEP_TOL)
    # a sliced schedule takes its sigmas from its own timestep values
    _, want = js.step({}, jnp.asarray(out), 1, jnp.asarray(x0), jt[4:])
    _, got = ts.step({}, torch.from_numpy(out), 1, torch.from_numpy(x0), timesteps[4:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


def test_flow_match_refuses_dynamic_shifting():
    for cls in (JaxFlow, FlowMatchEulerDiscreteScheduler):
        with pytest.raises(NotImplementedError):
            cls.create(use_dynamic_shifting=True)


def _fields(scheduler):
    return {f.name: getattr(scheduler, f.name) for f in dataclasses.fields(scheduler)}


def _assert_same_scheduler(got, want):
    assert type(got).__name__ == type(want).__name__
    gf, wf = _fields(got), _fields(want)
    # fields of what the port has not ported (DPM's Karras sigmas) are off in JAX
    assert gf.keys() <= wf.keys() and not any(wf[k] for k in wf.keys() - gf.keys())
    for k in gf:
        if isinstance(wf[k], np.ndarray):
            np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
        else:
            assert gf[k] == wf[k], k


@pytest.mark.parametrize("spec,training", [
    ({"name": "ddpm", "params": {"beta_start": 0.0001, "beta_end": 0.02}},
     {"num_train_timesteps": 1000}),
    ({"name": "DDPM", "num_train_timesteps": 500, "num_inference_steps": 20}, {}),
    ({"name": "flowmatch", "params": {"beta_start": 0.0001, "beta_end": 0.02}}, {}),
    ({"name": "flow_match_euler", "params": {"shift": 3.0}}, {"num_inference_steps": 30}),
    ({"name": "dpm_multistep", "params": {"solver_order": 1, "algorithm_type": "dpmsolver"}}, {}),
    ({}, {"scheduler": "flowmatch", "num_inference_steps": 12}),   # training.scheduler
    (None, None),                                                  # the ddpm fallback
])
def test_build_scheduler_matches_jax(spec, training):
    got, n = build_scheduler(spec, training)
    want, want_n = jax_registry.build_scheduler(spec, training)
    assert n == want_n
    _assert_same_scheduler(got, want)


@pytest.mark.parametrize("name", sorted(jax_registry.SCHEDULER_REGISTRY))
def test_every_registry_name_builds_as_in_jax_or_names_its_unported_class(name):
    assert set(SCHEDULER_REGISTRY) == set(jax_registry.SCHEDULER_REGISTRY)
    want, _ = jax_registry.build_scheduler({"name": name}, {})
    entry = SCHEDULER_REGISTRY[name]
    if isinstance(entry, str):
        assert entry == type(want).__name__
        with pytest.raises(NotImplementedError, match=entry):
            build_scheduler({"name": name}, {})
    else:
        _assert_same_scheduler(build_scheduler({"name": name}, {})[0], want)


def test_unknown_scheduler_raises_like_jax():
    for build in (build_scheduler, jax_registry.build_scheduler):
        with pytest.raises(ValueError, match="Unknown scheduler 'euler'"):
            build({"name": "euler"}, {})
    for resolve in (resolve_scheduler_override, jax_registry.resolve_scheduler_override):
        with pytest.raises(ValueError, match="Unknown scheduler override"):
            resolve("euler")


@pytest.mark.parametrize("name", [
    None, "", "ddpm", "ddim", "dpmsolver1", "dpmsolver2", "dpmsolver++", "dpmsolversde", "unipc",
    "flowmatch", "flow_match_euler", "dpm_multistep", "dpm_sde", " DPMSolver++ ",
    "dpmsolver++?thresholding=true,order=3", "ddpm?variance_type=fixed_large,clip_sample=false",
    "flowmatch?shift=2.5"])
def test_resolve_scheduler_override_matches_jax(name):
    assert resolve_scheduler_override(name) == jax_registry.resolve_scheduler_override(name)


class InjectedNoise:
    """A stochastic scheduler whose step i takes ``noises[i]`` instead of
    drawing from the generator the engine hands it (which it records)."""

    def __init__(self, scheduler, noises):
        self.scheduler, self.noises, self.generators = scheduler, noises, []

    def __getattr__(self, name):
        return getattr(self.scheduler, name)

    def step(self, state, model_output, index, sample, timesteps, generator=None):
        self.generators.append(generator)
        return self.scheduler.step(state, model_output, index, sample, timesteps,
                                   noise=self.noises[index].to(sample.device))


def test_sampling_engine_five_ddpm_steps_match_jax():
    """JAX splits the call's key into the initial noise's and the steps',
    and the steps' into one key per step; the port gets those same draws."""
    kw = dict(beta_start=0.0001, beta_end=0.02)
    jm = JaxFactory().build(REDUCED_UNET, conditioning="concatenate", channels=1)
    tm = DiffusionUNetFactory().build(REDUCED_UNET, conditioning="concatenate", channels=1,
                                      device="cpu")
    params, tm = _pair(jm, tm, seed=20)
    jsched, tsched = JaxDDPM.create(**kw), DDPMScheduler.create(**kw)
    timesteps = tsched.set_timesteps(5)
    np.testing.assert_array_equal(timesteps, jsched.set_timesteps(5))
    assert timesteps[-1] == 0
    shape = (2, 1, 32, 32)
    rng = np.random.default_rng(21)
    cond = _normal(rng, *shape)
    key = jax.random.PRNGKey(22)
    want = np.asarray(JaxEngine(jm, jsched, timesteps, conditioning_mode="concatenate")(
        params, shape, key, conditioning_batch=jnp.asarray(cond)))

    key_init, key_steps = jax.random.split(key)
    init = _jax_noise(key_init, shape)
    noises = [torch.from_numpy(_jax_noise(k, shape))
              for k in jax.random.split(key_steps, len(timesteps))]
    injected = InjectedNoise(tsched, noises)
    gen = torch.Generator().manual_seed(0)
    got = SamplingEngine(tm, injected, timesteps, conditioning_mode="concatenate", device="cpu")(
        shape, gen, conditioning_batch=torch.from_numpy(cond), init_sample=torch.from_numpy(init))
    # five f32 UNet calls chained through the DDPM steps, sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # the engine hands every step the caller's generator (it lives on the device)
    assert injected.generators == [gen] * 5


def test_engine_hands_a_generator_only_to_a_stochastic_scheduler():
    tm = DiffusionUNetFactory().build(dict(REDUCED_UNET, block_out_channels=[32] * 6),
                                      conditioning="concatenate", channels=1, device="cpu")
    dpm = DPMSolverMultistepScheduler.create()
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(dpm, name)

        def step(self, *args, generator=None):
            seen.append(generator)
            return dpm.step(*args, generator=generator)

    shape = (1, 1, 32, 32)
    cond = torch.zeros(shape)
    gen = torch.Generator().manual_seed(1)
    SamplingEngine(tm, Spy(), dpm.set_timesteps(2), conditioning_mode="concatenate",
                   device="cpu")(shape, gen, conditioning_batch=cond)
    assert seen == [None, None]
    # DDPM from the facade: the same seed gives the same sample, another seed another
    ddpm = DDPMScheduler.create()
    runs = [sample_with_scheduler(tm, ddpm, 2, shape, torch.Generator().manual_seed(s),
                                  conditioning_mode="concatenate", conditioning_batch=cond,
                                  device="cpu") for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_step_generator_lives_on_the_device():
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(5)
    assert step_generator(gen, cpu) is gen
    torch.manual_seed(6)
    a = step_generator(None, cpu)
    torch.manual_seed(6)
    b = step_generator(None, cpu)
    assert a.device == cpu and torch.equal(torch.randn(3, generator=a), torch.randn(3, generator=b))
