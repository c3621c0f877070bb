"""The 3D volume path (BASELINE configs[4]: EfficientUNetND on windowed LDCT
volumes) of the port against the JAX package's, on the CPU in f32.

The model is ``scripts/bench_3d.py``'s ``UNET_3D`` cut to two levels of
64/128 channels and one res block per level (FiLM on, linear attention at
ds 2, the middle block's softmax self-attention), on (4, 8, 8) volumes with
concatenate conditioning. Weights are drawn with numpy and loaded into both
sides. Covered: two DDPM train steps with JAX's noise and t replayed (held
as ``tests/test_torch_efficient_train.py`` holds the 2-D step), the same
steps under ``remat``, 2 DPM++ steps through ``SamplingEngine`` at a 5-D
shape, and the flow-matching trainer on ``tests/test_3d_training.py``'s
windowed volumes.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu.data.ldct import LDCTDataset as JaxLDCTDataset
from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.sample.engine import SamplingEngine as JaxEngine
from fmdm_tpu.schedulers import DDPMScheduler as JaxDDPM
from fmdm_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from fmdm_tpu.train.common import make_denoise_train_step as jax_make_step
from fmdm_tpu_torch.data.ldct import LDCTDataset
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.sample.engine import SamplingEngine
from fmdm_tpu_torch.schedulers import DDPMScheduler, DPMSolverMultistepScheduler
from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step
from tests.test_3d_training import _make_volume_root
from tests.test_torch_denoise_train import (  # noqa: F401
    LR, SCHED, TOTAL, WARMUP, WD, _assert_grads_match, _gradient_reader, _tree,
    few_torch_threads)
from tests.test_torch_models import _normal, _pair

# scripts/bench_3d.py's UNET_3D (64 channels, FiLM, 8 heads x 32) cut to two
# levels and one res block; GroupNorm groups of 2+ channels
UNET_3D = {"unet_impl": "efficient_nd", "spatial_dims": 3, "in_channels": 1, "out_channels": 1,
           "model_channels": 64, "num_res_blocks": 1, "channel_mult": [1, 2],
           "attention_resolutions": [2], "num_heads": 2, "dim_head": 16,
           "use_scale_shift_norm": True}
SHAPE = (4, 8, 8)   # (D, H, W): the middle attention at (2, 4, 4), 32 tokens
DPM = dict(num_train_timesteps=1000, algorithm_type="dpmsolver++", solver_order=2,
           beta_start=0.0001, beta_end=0.02)


@pytest.fixture(scope="module")
def models():
    """The JAX model and its parameters, and the port's with the same weights."""
    jm = JaxFactory().build(UNET_3D, conditioning="concatenate", channels=1)
    tm = DiffusionUNetFactory().build(UNET_3D, conditioning="concatenate", channels=1,
                                      device="cpu")
    params, tm = _pair(jm, tm, seed=40)
    return jm, params, tm


def _batch(seed: int, valid):
    rng = np.random.default_rng(seed)
    shape = (len(valid), 1) + SHAPE
    return {"target": rng.standard_normal(shape).astype(np.float32),
            "image": rng.standard_normal(shape).astype(np.float32),
            "valid": np.asarray(valid, np.float32)}


def _draws(rng, rows: int):
    """The noise and t that JAX's DDPM train step draws from ``rng`` for one
    chunk of ``rows`` volumes."""
    key_noise, key_t = jax.random.split(rng)
    noise = np.array(jax.random.normal(key_noise, (rows, 1) + SHAPE, jnp.float32))
    return noise, np.array(jax.random.randint(key_t, (rows,), 0, 1000))


def _port_step(tm, remat: bool):
    optimizer, schedule = make_adamw(tm.parameters(), LR, WD, WARMUP, TOTAL)
    return make_denoise_train_step(tm, DDPMScheduler.create(**SCHED), optimizer, schedule,
                                   variant="diffusion", conditioning_mode="concatenate",
                                   latent_norm=None, remat=remat, device="cpu")


def _two_steps(step, batches, draws):
    """Two steps on ``batches`` with ``draws``: per step the (loss_sum,
    count), every gradient and every parameter after it; and the number of
    the UNet's forwards."""
    forwards = []
    step.model.register_forward_pre_hook(lambda *_: forwards.append(1))
    out = []
    for batch, (noise, t) in zip(batches, draws):
        loss_sum, count = step.step({k: torch.from_numpy(v.copy()) for k, v in batch.items()},
                                    noise=torch.from_numpy(noise), t=torch.from_numpy(t))
        out.append((float(loss_sum), float(count),
                    {n: p.grad.clone() for n, p in step.model.named_parameters()},
                    {n: p.detach().clone() for n, p in step.model.named_parameters()}))
    return out, len(forwards)


def test_train_steps_match_jax(models):
    """Two DDPM steps at batch 3 (the middle row masked), JAX's noise and t
    replayed: loss, count, every gradient (the FiLM projections included)
    and the AdamW update against ``optax.adamw`` on the same gradients."""
    import optax

    from fmdm_tpu.train.common import make_adamw as jax_make_adamw

    jm, _, tm0 = models
    tm = copy.deepcopy(tm0).train()
    jstep = jax_make_step(jm, JaxDDPM.create(**SCHED), _gradient_reader(), variant="diffusion",
                          conditioning_mode="concatenate", latent_norm=None)
    step = _port_step(tm, remat=False)
    adamw, _ = jax_make_adamw(LR, WD, WARMUP, TOTAL)
    opt_state = adamw.init(_tree(tm.named_parameters()))

    @jax.jit
    def apply_adamw(grads, opt_state, params):
        updates, opt_state = adamw.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for i in range(2):
        batch = _batch(41 + i, [1.0, 0.0, 1.0])
        rng = jax.random.PRNGKey(43 + i)
        before = _tree(tm.named_parameters())
        reader = _gradient_reader()
        _, state, want_sum, want_count = jstep(
            _tree(tm.named_parameters()), reader.init(before),
            {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        noise, t = _draws(rng, 3)
        got_sum, got_count = step.step({k: torch.from_numpy(v.copy()) for k, v in batch.items()},
                                       noise=torch.from_numpy(noise), t=torch.from_numpy(t))
        assert float(got_count) == float(want_count) == 2.0
        assert float(got_sum) == pytest.approx(float(want_sum), rel=1e-5)
        _assert_grads_match(tm, state["g"])
        assert all(float(p.grad.abs().max()) > 0 for n, p in tm.named_parameters()
                   if "emb_layers" in n)
        grads = unflatten_params({n: jnp.asarray(p.grad.numpy().copy())
                                  for n, p in tm.named_parameters()})
        after, opt_state = apply_adamw(grads, opt_state, before)
        want = flatten_params(after)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_remat_steps_equal_the_steps_without_it(models):
    """``training.remat`` recomputes the UNet's forward in the backward (a
    second forward per step): the same two steps give the same losses, gradients and parameters (the
    forward recomputed is the same arithmetic, so to rounding)."""
    _, _, tm0 = models
    batches = [_batch(45 + i, [1.0, 1.0, 0.0]) for i in range(2)]
    draws = [_draws(jax.random.PRNGKey(47 + i), 3) for i in range(2)]
    plain, plain_forwards = _two_steps(_port_step(copy.deepcopy(tm0).train(), remat=False),
                                       batches, draws)
    remat, remat_forwards = _two_steps(_port_step(copy.deepcopy(tm0).train(), remat=True),
                                       batches, draws)
    assert (plain_forwards, remat_forwards) == (2, 4)   # the forward again in each backward
    for (loss, count, grads, params), (r_loss, r_count, r_grads, r_params) in zip(plain, remat):
        assert (r_loss, r_count) == pytest.approx((loss, count), rel=1e-6)
        for name, g in grads.items():
            torch.testing.assert_close(r_grads[name], g, rtol=0,
                                       atol=1e-6 * float(g.abs().max()), msg=name)
            torch.testing.assert_close(r_params[name], params[name], rtol=0, atol=1e-7, msg=name)


def test_two_dpm_steps_on_volumes_match_jax(models):
    """The first 2 steps of a 50-step DPM-Solver++ (order 2) schedule through
    ``SamplingEngine`` at (2, 1, 4, 8, 8), concatenate conditioning, from the
    same initial noise: the second step is the second-order update."""
    jm, params, tm = models
    jsched, tsched = JaxDPM.create(**DPM), DPMSolverMultistepScheduler.create(**DPM)
    timesteps = tsched.set_timesteps(50)[:2]
    np.testing.assert_array_equal(timesteps, jsched.set_timesteps(50)[:2])
    rng = np.random.default_rng(48)
    shape = (2, 1) + SHAPE
    init, cond = _normal(rng, *shape), _normal(rng, *shape)
    want = np.asarray(JaxEngine(jm, jsched, timesteps, conditioning_mode="concatenate")(
        params, shape, jax.random.PRNGKey(0), conditioning_batch=jnp.asarray(cond),
        init_sample=jnp.asarray(init)))
    timing = {}
    got = SamplingEngine(tm.eval(), tsched, timesteps, conditioning_mode="concatenate",
                         device="cpu")(shape, conditioning_batch=torch.from_numpy(cond),
                                       init_sample=torch.from_numpy(init), timing=timing)
    assert got.shape == shape and timing["model_calls"] == 2
    # two f32 model calls and solver steps, sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_flow_matching_trains_on_windowed_volumes(tmp_path):
    """``tests/test_3d_training.py``'s case through the port: depth-4
    windows of an 8-slice volume (as many as JAX's dataset makes, each
    window the same), read as (1, D, H, W) volumes, one epoch of
    ``flow_matching_lib.train`` on the CPU: a checkpoint and a finite loss
    in ``metrics.csv``."""
    import json

    from fmdm_tpu_torch.train.flow_matching_lib import train

    root = _make_volume_root(tmp_path)
    ds = LDCTDataset(file_path=str(root), window_size=4, use_tensor_cache=False, load_ldct=True)
    jds = JaxLDCTDataset(file_path=str(root), window_size=4, use_tensor_cache=False,
                         load_ldct=True)
    assert len(ds) == len(jds) == 5
    for i in (0, 4):
        for key in ("target", "image"):
            np.testing.assert_array_equal(np.asarray(ds[i][key]), np.asarray(jds[i][key]))

    class Volumes:
        """The windows as one-channel volumes: (window, H, W) -> (1, D, H, W)."""

        def __init__(self, ds):
            self.ds, self.data = ds, ds.data
            self.target_key, self.conditioning_key = ds.target_key, ds.conditioning_key

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            s = dict(self.ds[i])
            for key in ("target", "image"):
                if s.get(key) is not None and s[key].ndim == 3:
                    s[key] = s[key][None]
            return s

    unet = {"unet_impl": "efficient_nd", "spatial_dims": 3, "in_channels": 1, "out_channels": 1,
            "model_channels": 8, "num_res_blocks": 1, "channel_mult": [1, 2],
            "attention_resolutions": [2], "num_heads": 2, "dim_head": 4, "use_linear_attn": True}
    cfg = {"training": {"data_root": str(root), "dataset": "ldct",
                        "output_dir": str(tmp_path / "run3d"), "train_batch_size": 2,
                        "num_epochs": 1, "learning_rate": 1e-3, "scheduler": "flowmatch",
                        "num_train_timesteps": 20, "num_inference_steps": 3,
                        "conditioning": "concatenate", "channels": 1, "save_model_epochs": 1,
                        "seed": 5, "save_images": False},
           "model": {"unet": unet, "scheduler": {"name": "flowmatch", "num_train_timesteps": 20},
                     "model_type": "flow_matching"}}
    path = tmp_path / "cfg3d.json"
    path.write_text(json.dumps(cfg))
    run_dir = train(Volumes(ds), path, device="cpu")
    assert (run_dir / "flow_last.pt").exists()
    rows = (run_dir / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 2
    assert np.isfinite(float(rows[1].split(",")[1]))
