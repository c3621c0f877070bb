"""The port's DPM-Solver multistep scheduler against the JAX package's.

Both get identical model outputs (numpy, seeded) and each chains its own
samples through a whole schedule. The tables and coefficients are f32 on both
sides, so only the order of a few f32 operations differs: held at 1e-5
relative over 20-50 chained steps.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fmdm_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from fmdm_tpu_torch.schedulers import DPMSolverMultistepScheduler

BENCH = dict(num_train_timesteps=1000, algorithm_type="dpmsolver++", solver_order=2,
             beta_start=0.0001, beta_end=0.02)


@pytest.mark.parametrize("steps,kw", [
    (50, {}),                                                          # the serving path
    (20, {"solver_type": "heun"}),
    (10, {"timestep_spacing": "trailing"}),                            # lower_order_final, n < 15
    (20, {"algorithm_type": "dpmsolver"}),                             # eps space, sigma_min final
    (20, {"solver_order": 1, "timestep_spacing": "leading", "steps_offset": 1}),
    (20, {"prediction_type": "v_prediction", "beta_schedule": "scaled_linear"}),
    (20, {"thresholding": True, "sample_max_value": 1.5}),
])
def test_dpm_steps_match_jax(steps, kw):
    cfg = dict(BENCH, **kw)
    js, ts = JaxDPM.create(**cfg), DPMSolverMultistepScheduler.create(**cfg)
    timesteps = ts.set_timesteps(steps)
    np.testing.assert_array_equal(timesteps, js.set_timesteps(steps))
    np.testing.assert_allclose(ts.sigmas_for(timesteps).numpy(),
                               np.asarray(js._sigmas_for(jnp.asarray(timesteps))), rtol=1e-6)

    rng = np.random.default_rng(steps)
    shape = (2, 1, 8, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jstate = js.init_state(timesteps, jx)
    tstate = ts.init_state(timesteps, tx)
    jt = jnp.asarray(timesteps)
    for i in range(steps):
        out = (0.8 * x + 0.3 * rng.standard_normal(shape)).astype(np.float32)
        jstate, jx = js.step(jstate, jnp.asarray(out), i, jx, jt)
        tstate, tx = ts.step(tstate, torch.from_numpy(out), i, tx, timesteps)
        assert tx.dtype == torch.float32
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    assert tstate["order_count"] == int(jstate["order_count"])


def test_add_noise_matches_jax():
    js, ts = JaxDPM.create(**BENCH), DPMSolverMultistepScheduler.create(**BENCH)
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal((3, 1, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 500, 999])
    want = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [{"use_karras_sigmas": True}, {"solver_order": 3},
                                {"algorithm_type": "sde-dpmsolver++"}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        DPMSolverMultistepScheduler.create(**dict(BENCH, **kw))


@pytest.mark.parametrize("kw", [{"solver_order": 4}, {"algorithm_type": "ddim"},
                                {"final_sigmas_type": "zero", "algorithm_type": "dpmsolver"},
                                {"trained_betas": [0.1]}])
def test_invalid_options_are_refused_as_in_jax(kw):
    with pytest.raises((ValueError, NotImplementedError)) as ours:
        DPMSolverMultistepScheduler.create(**dict(BENCH, **kw))
    with pytest.raises(type(ours.value)):
        JaxDPM.create(**dict(BENCH, **kw))
