"""The port's DDIM, UniPC and DPM-SDE schedulers and DPM-Solver++'s order 3,
Karras sigmas and 'sde-dpmsolver++', against the JAX package's, the float64
numpy oracles of diffusers' update rules, and the frozen golden trajectories.

Model outputs and samples are numpy, seeded, and handed to both sides. Each
step of a whole schedule is compared on the same sample (JAX's previous
output), so an error cannot grow along the chain; each side carries its own
multistep history. The step noise is JAX's own ``jax.random.normal(key,
...)``, handed to the port as ``noise=``. Tables and coefficients are f32 on
both sides and each step is a few elementwise f32 operations: held at rtol
1e-6 with an atol of 1e-6 (in sigma space, DPM-SDE's samples are O(sigma):
its atol is 1e-6 of the step's largest magnitude), once with XLA's own
elementary functions for the scalar coefficients and once with torch's
(``xla_scalar_functions`` says where the two differ).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fmdm_tpu.sample.engine import SamplingEngine as JaxEngine
from fmdm_tpu.sample.engine import select_timesteps as jax_select_timesteps
from fmdm_tpu.schedulers import registry as jax_registry
from fmdm_tpu.schedulers import (DDIMScheduler as JaxDDIM, DPMSolverMultistepScheduler as JaxDPM,
                                 DPMSolverSDEScheduler as JaxSDE,
                                 UniPCMultistepScheduler as JaxUniPC)
from fmdm_tpu_torch.sample.engine import SamplingEngine, select_timesteps
from fmdm_tpu_torch.schedulers import (
    SCHEDULER_REGISTRY, DDIMScheduler, DPMSolverMultistepScheduler, DPMSolverSDEScheduler,
    UniPCMultistepScheduler, build_scheduler, resolve_scheduler_override)
from tests.oracles.diffusers_numpy import NpDDIM, NpDPMSolverMultistep, NpDPMSolverSDE, NpUniPC
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401

STEP_TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE = (2, 1, 4, 4)
GOLDEN = np.load(Path(__file__).parent / "fixtures_scheduler_golden.npz")

CLASSES = {"ddim": (JaxDDIM, DDIMScheduler), "dpm": (JaxDPM, DPMSolverMultistepScheduler),
           "unipc": (JaxUniPC, UniPCMultistepScheduler), "sde": (JaxSDE, DPMSolverSDEScheduler)}

# (class, create kwargs, steps): each new scheduler and option, a short
# (n < 15, the lower-order tail) and a longer schedule
CASES = [
    ("ddim", {}, 25),
    ("ddim", {"eta": 1.0}, 10),
    ("ddim", {"eta": 0.5, "prediction_type": "v_prediction", "clip_sample": False}, 12),
    ("ddim", {"prediction_type": "sample", "set_alpha_to_one": False}, 10),
    ("ddim", {"thresholding": True, "sample_max_value": 1.5, "use_clipped_model_output": True}, 10),
    ("ddim", {"timestep_spacing": "trailing", "clip_sample_range": 2.0}, 13),
    ("dpm", {"solver_order": 3}, 25),
    ("dpm", {"solver_order": 3}, 10),
    ("dpm", {"solver_order": 3, "algorithm_type": "dpmsolver"}, 20),
    ("dpm", {"solver_order": 3, "solver_type": "heun", "euler_at_final": True}, 12),
    ("dpm", {"use_karras_sigmas": True}, 25),
    ("dpm", {"use_karras_sigmas": True, "solver_order": 3, "solver_type": "heun"}, 12),
    ("dpm", {"algorithm_type": "sde-dpmsolver++"}, 25),
    ("dpm", {"algorithm_type": "sde-dpmsolver++", "solver_type": "heun"}, 10),
    ("dpm", {"algorithm_type": "sde-dpmsolver++", "use_karras_sigmas": True}, 12),
    ("dpm", {"algorithm_type": "sde-dpmsolver++", "solver_order": 1}, 10),
] + [
    ("unipc", {"solver_type": st, "solver_order": order, "use_karras_sigmas": karras}, steps)
    for st in ("bh1", "bh2") for order in (1, 2, 3) for karras, steps in ((False, 25), (True, 12))
] + [
    ("unipc", {"predict_x0": False, "solver_order": 3}, 20),
    ("unipc", {"prediction_type": "v_prediction", "thresholding": True}, 12),
    ("unipc", {"final_sigmas_type": "sigma_min", "lower_order_final": False,
               "solver_order": 3, "timestep_spacing": "trailing"}, 10),
    ("sde", {}, 12),
    ("sde", {"use_karras_sigmas": True}, 10),
    ("sde", {"prediction_type": "v_prediction", "s_noise": 0.5}, 10),
    ("sde", {"prediction_type": "sample"}, 10),
]


def _id(case):
    name, kw, steps = case
    return f"{name}-{steps}-" + ",".join(f"{k}={v}" for k, v in kw.items())


def _jax_noise(key, shape=SHAPE):
    return np.array(jax.random.normal(key, shape, dtype=jnp.float32))


def _tol(want, tol=1e-6):
    """rtol ``tol``, and an atol of ``tol`` times the step's magnitude (at
    least 1): in sigma space, DPM-SDE's samples are O(sigma)."""
    return dict(rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture
def xla_scalar_functions(monkeypatch):
    """Evaluate the f32 elementary functions of 0-d tensors (the schedulers'
    scalar coefficients) with XLA's implementations, as the JAX schedulers
    evaluate them. XLA's f32 expm1 is not correctly rounded on |x| < 0.5,
    and its log, exp and sqrt differ from torch's in the last ulp on some
    inputs; UniPC's b-vector recursion (three divisions by h, each followed
    by a cancelling subtraction) grows one ulp of expm1 by orders of
    magnitude in b3. With these functions the port runs the same f32
    arithmetic as JAX."""
    for name in ("sqrt", "log", "exp", "expm1"):
        torch_fn, xla_fn = getattr(torch, name), getattr(jnp, name)

        def fn(x, *args, _torch_fn=torch_fn, _xla_fn=xla_fn, **kwargs):
            if isinstance(x, torch.Tensor) and x.dim() == 0 and x.dtype == torch.float32 \
                    and not args and not kwargs:
                return torch.tensor(np.asarray(_xla_fn(np.float32(x.item()))))
            return _torch_fn(x, *args, **kwargs)

        monkeypatch.setattr(torch, name, fn)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_steps_match_jax_with_its_noise(case, xla_scalar_functions):
    """Every step at rtol/atol 1e-6, with XLA's elementary functions for the
    scalar coefficients (the fixture) and JAX's noise."""
    _steps_against_jax(case, 1e-6)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_steps_match_jax_with_torchs_own_functions(case):
    """The same steps with torch's own expm1, log, exp and sqrt: 1e-6 as
    well, except UniPC at orders 2-3, whose b-vector recursion amplifies the
    last-ulp differences of expm1 and log (see the fixture) to the order of
    1e-5 of a step: held at 5e-5."""
    name, kw, _ = case
    _steps_against_jax(case, 5e-5 if name == "unipc" and kw.get("solver_order", 2) > 1 else 1e-6)


def _steps_against_jax(case, tol):
    name, kw, steps = case
    jax_cls, cls = CLASSES[name]
    js, ts = jax_cls.create(**kw), cls.create(**kw)
    timesteps = ts.set_timesteps(steps)
    want_t = js.set_timesteps(steps)
    assert timesteps.dtype == want_t.dtype
    np.testing.assert_array_equal(timesteps, want_t)
    jt = jnp.asarray(timesteps)
    if hasattr(ts, "sigmas_for"):
        np.testing.assert_allclose(ts.sigmas_for(timesteps).numpy(),
                                   np.asarray(js._sigmas_for(jt)), rtol=1e-6)
    assert ts.needs_noise == (js.needs_noise or name == "sde")
    assert ts.init_noise_scale(timesteps) == js.init_noise_scale(want_t)
    rng = np.random.default_rng(1)
    scale = ts.init_noise_scale(timesteps)
    x = (scale * rng.standard_normal(SHAPE)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), len(timesteps))
    jstate = js.init_state(jt, jnp.asarray(x))
    tstate = ts.init_state(timesteps, torch.from_numpy(x))
    for i in range(len(timesteps)):
        np.testing.assert_allclose(
            ts.scale_model_input(torch.from_numpy(x), i, timesteps).numpy(),
            np.asarray(js.scale_model_input(jnp.asarray(x), i, jt)), **STEP_TOL)
        out = (0.5 * x / max(scale, 1.0) + rng.standard_normal(SHAPE)).astype(np.float32)
        jstate, want = js.step(jstate, jnp.asarray(out), i, jnp.asarray(x), jt, rng=keys[i])
        noise = {"noise": torch.from_numpy(_jax_noise(keys[i]))} if ts.needs_noise else {}
        tstate, got = ts.step(tstate, torch.from_numpy(out), i, torch.from_numpy(x), timesteps,
                              **noise)
        want = np.asarray(want)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **_tol(want, tol), err_msg=f"step {i}")
        x = want


@pytest.mark.parametrize("name,kw", [
    ("ddim", {"eta": 1.0}), ("dpm", {"algorithm_type": "sde-dpmsolver++"}), ("sde", {})])
def test_stochastic_steps_need_a_noise_source(name, kw):
    ts = CLASSES[name][1].create(**kw)
    timesteps = ts.set_timesteps(4)
    x = torch.zeros(SHAPE)
    state = ts.init_state(timesteps, x)
    assert ts.needs_noise
    with pytest.raises(ValueError, match="generator or a noise"):
        ts.step(state, torch.ones(SHAPE), 0, x, timesteps)
    _, a = ts.step(state, torch.ones(SHAPE), 0, x, timesteps, generator=torch.Generator().manual_seed(0))
    _, b = ts.step(state, torch.ones(SHAPE), 0, x, timesteps, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


# the numpy oracles (float64 re-statements of diffusers' update rules),
# compared in lockstep at every step's own magnitude as
# tests/test_scheduler_oracle_parity.py compares the JAX schedulers
ORACLES = {
    "ddim": (lambda: DDIMScheduler.create(), NpDDIM),
    "ddim_eta": (lambda: DDIMScheduler.create(eta=0.5), lambda: NpDDIM(eta=0.5)),
    "dpmpp3": (lambda: DPMSolverMultistepScheduler.create(solver_order=3),
               lambda: NpDPMSolverMultistep(solver_order=3)),
    "dpmpp2_karras": (lambda: DPMSolverMultistepScheduler.create(use_karras_sigmas=True),
                      lambda: NpDPMSolverMultistep(use_karras_sigmas=True)),
    "dpmpp2_sde": (lambda: DPMSolverMultistepScheduler.create(algorithm_type="sde-dpmsolver++"),
                   lambda: NpDPMSolverMultistep(algorithm_type="sde-dpmsolver++")),
    "unipc": (lambda: UniPCMultistepScheduler.create(), NpUniPC),
    "unipc3_bh1": (lambda: UniPCMultistepScheduler.create(solver_order=3, solver_type="bh1"),
                   lambda: NpUniPC(solver_order=3, solver_type="bh1")),
    "unipc_karras": (lambda: UniPCMultistepScheduler.create(use_karras_sigmas=True),
                     lambda: NpUniPC(use_karras_sigmas=True)),
}


@pytest.mark.parametrize("n_steps", [10, 25])
@pytest.mark.parametrize("name", sorted(ORACLES))
def test_trajectory_matches_numpy_oracle(name, n_steps):
    make, make_oracle = ORACLES[name]
    ts, oracle = make(), make_oracle()
    timesteps = ts.set_timesteps(n_steps)
    oracle_t = oracle.set_timesteps(n_steps)
    rng = np.random.RandomState(42)
    outputs = rng.randn(n_steps, *SHAPE).astype(np.float32)
    noises = np.random.RandomState(7).randn(n_steps, *SHAPE).astype(np.float32)
    x = np.linspace(-1.5, 1.5, int(np.prod(SHAPE))).reshape(SHAPE)
    state = ts.init_state(timesteps, torch.from_numpy(x.astype(np.float32)))
    err = []
    for i in range(n_steps):
        noise = {"noise": torch.from_numpy(noises[i])} if ts.needs_noise else {}
        state, got = ts.step(state, torch.from_numpy(outputs[i]), i,
                             torch.from_numpy(x.astype(np.float32)), timesteps, **noise)
        try:
            x = oracle.step(outputs[i].astype(np.float64), oracle_t[i], x, noises[i])
        except TypeError:
            x = oracle.step(outputs[i].astype(np.float64), oracle_t[i], x)
        err.append(np.abs(got.numpy() - x).max() / max(np.sqrt(np.mean(x ** 2)), 1.0))
    assert max(err) < 5e-4, f"{name}: max normalized err {max(err):.2e} at step {int(np.argmax(err))}"


def test_dpm_sde_matches_numpy_oracle():
    """DPM-SDE's per-call tables against diffusers' first/second-order state
    machine: the interleaved schedule, the input scaling and every call."""
    for karras in (False, True):
        ts, oracle = DPMSolverSDEScheduler.create(use_karras_sigmas=karras), NpDPMSolverSDE(
            use_karras_sigmas=karras)
        timesteps = ts.set_timesteps(10)
        np.testing.assert_allclose(timesteps, oracle.set_timesteps(10), rtol=1e-5, atol=1e-4)
        rng = np.random.RandomState(3)
        x = np.linspace(-1.0, 1.0, int(np.prod(SHAPE))).reshape(SHAPE) * 3.0
        state = ts.init_state(timesteps, torch.zeros(SHAPE))
        for i in range(len(timesteps)):
            out, noise = rng.randn(*SHAPE).astype(np.float32), rng.randn(*SHAPE).astype(np.float32)
            np.testing.assert_allclose(
                ts.scale_model_input(torch.from_numpy(x.astype(np.float32)), i, timesteps).numpy(),
                oracle.scale_model_input(x), rtol=2e-4, atol=2e-4)
            state, got = ts.step(state, torch.from_numpy(out), i,
                                 torch.from_numpy(x.astype(np.float32)), timesteps,
                                 noise=torch.from_numpy(noise))
            x = oracle.step(out.astype(np.float64), timesteps[i], x, noise.astype(np.float64))
            np.testing.assert_allclose(got.numpy(), x, rtol=1e-4, atol=1e-4 * max(1, np.abs(x).max()))


@pytest.mark.parametrize("golden,make", [
    ("ddim", lambda: DDIMScheduler.create(num_train_timesteps=100)),
    ("dpmpp", lambda: DPMSolverMultistepScheduler.create(num_train_timesteps=100)),
    ("unipc", lambda: UniPCMultistepScheduler.create(num_train_timesteps=100)),
    ("sde", lambda: DPMSolverSDEScheduler.create(num_train_timesteps=100)),
])
def test_golden_trajectory_and_add_noise(golden, make):
    """tests/fixtures_scheduler_golden.npz, at the tolerances of
    tests/test_scheduler_golden.py; DPM-SDE's noise is JAX's PRNGKey(7 + i)."""
    ts = make()
    rng = np.random.RandomState(0)
    x0 = rng.randn(*SHAPE).astype(np.float32)
    pred = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32))
    timesteps = ts.set_timesteps(10)
    x = torch.from_numpy(x0)
    state = ts.init_state(timesteps, x)
    traj = []
    for i in range(3):
        noise = {"noise": torch.from_numpy(_jax_noise(jax.random.PRNGKey(7 + i)))} \
            if ts.needs_noise else {}
        state, x = ts.step(state, pred, i, x, timesteps, **noise)
        traj.append(x.numpy())
    rtol, atol = (2e-4, 5e-5) if golden == "sde" else (1e-5, 1e-6)
    np.testing.assert_allclose(np.stack(traj), GOLDEN[f"{golden}_traj"], rtol=rtol, atol=atol)
    t = torch.full((2,), int(timesteps[0]), dtype=torch.int32)
    np.testing.assert_allclose(ts.add_noise(torch.from_numpy(x0), pred, t).numpy(),
                               GOLDEN[f"{golden}_addnoise"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kw", [("ddim", {}), ("dpm", {"solver_order": 3}),
                                     ("unipc", {}), ("sde", {})])
def test_add_noise_matches_jax(name, kw):
    jax_cls, cls = CLASSES[name]
    js, ts = jax_cls.create(**kw), cls.create(**kw)
    js.set_timesteps(10), ts.set_timesteps(10)
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal((4, 1, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 1, 500, 999], np.int32)
    want = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(np.asarray(want)))


def test_karras_sigmas_are_reset_by_set_timesteps():
    """A scheduler reused after another set_timesteps reads that schedule's
    sigmas, never a stale stash; without Karras the stash is cleared."""
    for cls in (DPMSolverMultistepScheduler, UniPCMultistepScheduler):
        ts = cls.create(use_karras_sigmas=True)
        first = ts.sigmas_for(ts.set_timesteps(10))
        second = ts.sigmas_for(ts.set_timesteps(20))
        assert len(first) == 11 and len(second) == 21 and first[0] == second[0]
        assert not torch.equal(first[1:3], second[1:3])
        with pytest.raises(ValueError, match="set_timesteps"):
            cls.create(use_karras_sigmas=True).sigmas_for(np.arange(3))
        plain = cls.create()
        plain.set_timesteps(5)
        assert plain._karras_sigmas is None


class _JaxToy:
    """A JAX model of the engine's calling convention: a fixed affine map of
    its input and its timestep."""

    def __call__(self, params, x, t, context_ca=None):
        return 0.3 * x + 1e-3 * t.astype(jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))


class _TorchToy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.unused = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x, t, context_ca=None):
        return 0.3 * x + 1e-3 * t.float().reshape((-1,) + (1,) * (x.dim() - 1))


@pytest.mark.parametrize("start_step,last_n", [(None, None), (700, None), (None, 6), (None, 5),
                                               (480, 7), (430, None)])
def test_dpm_sde_sliced_sampling_matches_jax_engine(start_step, last_n):
    """The two-call DPM-SDE steps through both engines from a sliced schedule:
    align_sliced_timesteps, init_noise_scale and scale_model_input at the
    sliced offset, every call's noise replayed from JAX's keys."""
    js, ts = JaxSDE.create(), DPMSolverSDEScheduler.create()
    sel = select_timesteps(ts.set_timesteps(8), start_step, last_n)
    want_sel = jax_select_timesteps(js.set_timesteps(8), start_step, last_n)
    np.testing.assert_array_equal(sel, want_sel)
    jengine = JaxEngine(_JaxToy(), js, want_sel)
    engine = SamplingEngine(_TorchToy(), ts, sel, device="cpu")
    np.testing.assert_array_equal(engine.timesteps, jengine.timesteps)
    assert len(engine.timesteps) in (len(sel), len(sel) - 1)
    assert ts._offset(engine.timesteps) % 2 == 0
    scale = ts.init_noise_scale(engine.timesteps)
    assert scale == js.init_noise_scale(jengine.timesteps)
    assert start_step is not None or last_n is not None or scale == np.float32(ts.init_noise_sigma)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jengine({}, SHAPE, key))
    # the JAX engine splits (init, steps) and one key per step
    k_init, k_steps = jax.random.split(key)
    init = torch.from_numpy(_jax_noise(k_init)) * scale
    noises = [torch.from_numpy(_jax_noise(k)) for k in jax.random.split(k_steps, len(sel))]
    got = engine(SHAPE, init_sample=init, step_noise=noises[:len(engine.timesteps)])
    np.testing.assert_allclose(got.numpy(), want, **_tol(want))


def test_step_noise_must_fit_the_schedule():
    ts = DPMSolverSDEScheduler.create()
    engine = SamplingEngine(_TorchToy(), ts, ts.set_timesteps(3), device="cpu")
    with pytest.raises(ValueError, match="step_noise"):
        engine(SHAPE, torch.Generator().manual_seed(0), step_noise=[torch.zeros(SHAPE)])
    ddim = DDIMScheduler.create()
    engine = SamplingEngine(_TorchToy(), ddim, ddim.set_timesteps(2), device="cpu")
    with pytest.raises(ValueError, match="deterministic"):
        engine(SHAPE, torch.Generator().manual_seed(0), step_noise=[torch.zeros(SHAPE)] * 2)


def _fields(scheduler):
    return {f.name: getattr(scheduler, f.name) for f in dataclasses.fields(scheduler)}


@pytest.mark.parametrize("alias", [
    "ddim", "ddim?eta=1.0", "unipc", "unipc?solver_order=3,use_karras_sigmas=true",
    "unipc?solver_type=bh1", "dpmsolver++?solver_order=3", "dpmsolver++?use_karras_sigmas=true",
    "dpmsolver++?algorithm_type=sde-dpmsolver++", "dpmsolversde", "dpm_sde", "dpmsolver1",
    "dpmsolver2", "dpmsolver++", "ddpm", "flowmatch", "flow_match_euler", "dpm_multistep"])
def test_every_alias_builds_as_in_jax(alias):
    """Each alias of resolve_scheduler_override, with and without '?k=v'
    parameters, builds the scheduler JAX builds, with the same fields."""
    spec = resolve_scheduler_override(alias)
    assert spec == jax_registry.resolve_scheduler_override(alias)
    got, n = build_scheduler(spec, {"num_inference_steps": 7})
    want, want_n = jax_registry.build_scheduler(spec, {"num_inference_steps": 7})
    assert type(got).__name__ == type(want).__name__ and n == want_n == 7
    assert type(got) is SCHEDULER_REGISTRY[spec["name"]]
    gf, wf = _fields(got), _fields(want)
    for k in gf:
        np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
