"""The port's bf16 flow-matching training against ``fmdm_tpu``'s over a
trajectory, on the CPU.

A narrow UNet of the flagship's block kinds (``TINY_UNET``: a plain and an
attention level each way, the mid attention, GroupNorm groups of 2
channels; the flagship's six levels compile for ~45 s in JAX, this for ~12)
trains 16 flow-matching steps on each side from the same weights, each side
carrying its own parameters and AdamW state: JAX's jitted
``make_denoise_train_step`` under ``optax.adamw`` at its cosine-warmup rate,
the port's ``DenoiseTrainStep`` under ``torch.optim.AdamW`` at its own, both
in bf16 (``compute_dtype``) over f32 weights. A 4-step warmup puts the
rate's peak inside the trajectory. Every step gets a new batch and the noise
and t that JAX draws from that step's key. This holds the optimizer, the
schedule, the flow target and t and the bf16 cast together, step after
step.

The two sides round in bf16 at other places by design (JAX's GroupNorm
rounds before SiLU, the port's once after; ``ROADMAP.md`` Queue 3). In bf16
the worst step's loss is 1.0e-3 apart and the parameters end 4.6e-2 of
JAX's trajectory's length apart; the same trajectory in f32
(``compute="float32"`` on both sides, not run here so that the file keeps
inside its time: a second JAX compile) ends 6.6e-7 and 4.1e-4 apart. The
tolerances allow 2x the bf16 distances, which refuses these faults of the
port (each planted in a copy): a flow target without its ``(1 - t)``
factor (4.7e-2, 0.72; the test plants this one itself and checks that it
fails), the model's t scaled by N in place of N - 1 (2.3e-3, 0.125), and
the warmup's rate one step ahead (1.2e-2 in the loss).
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlow
from fmdm_tpu.train.common import make_adamw as jax_make_adamw
from fmdm_tpu.train.common import make_denoise_train_step as jax_make_step
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.schedulers import FlowMatchEulerDiscreteScheduler
from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_models import TINY_UNET, _pair

STEPS, WARMUP, BATCH, RES = 16, 4, 2, 16
LR, WD = 1e-4, 0.0   # the flow flagship config's learning_rate and weight_decay
TOTAL = 24           # the cosine runs on past the last step, so no step has rate 0
N_TRAIN = 1000
LOSS_TOL = 2e-3      # |port - jax| / |jax| of each step's loss
PARAM_TOL = 0.1      # ||port - jax|| / ||jax - start|| of all parameters after the last step


def trajectory_errors(got, want, port, jax_side, begin):
    """(worst relative loss error over the steps, the parameters' distance
    over the length of JAX's trajectory)."""
    loss_err = np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want))
    return float(loss_err.max()), float(np.linalg.norm(port - jax_side)
                                        / np.linalg.norm(jax_side - begin))


def draws(i: int):
    """Step ``i``'s batch (slices in [-1, 1], as the data layer gives them),
    its JAX key, and the noise and t that JAX's step draws from that key."""
    rng = np.random.default_rng(60 + i)
    shape = (BATCH, 1, RES, RES)
    batch = {"target": rng.uniform(-1, 1, shape).astype(np.float32),
             "image": rng.uniform(-1, 1, shape).astype(np.float32),
             "valid": np.ones(BATCH, np.float32)}
    key = jax.random.PRNGKey(70 + i)
    key_noise, key_t = jax.random.split(key)
    noise = np.array(jax.random.normal(key_noise, shape, jnp.float32))
    t = np.array(jax.random.uniform(key_t, (BATCH,), jnp.float32))
    return batch, key, noise, t


def jax_trajectory(params: dict, compute: str = "bfloat16"):
    """(losses, parameters as one vector) of STEPS steps of JAX's step in
    ``compute`` from ``params`` (name -> numpy array, the port's order)."""
    jm = JaxFactory().build(TINY_UNET, conditioning="concatenate", channels=1)
    adamw, _ = jax_make_adamw(LR, WD, WARMUP, TOTAL)
    jstep = jax_make_step(jm, JaxFlow.create(num_train_timesteps=N_TRAIN), adamw,
                          variant="flow_matching", conditioning_mode="concatenate",
                          latent_norm=None, compute_dtype=getattr(jnp, compute))
    tree = unflatten_params({n: jnp.asarray(v) for n, v in params.items()})
    opt_state = jax.jit(adamw.init)(tree)
    losses = []
    for i in range(STEPS):
        batch, key, _, _ = draws(i)
        tree, opt_state, loss_sum, _ = jstep(
            tree, opt_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        losses.append(float(loss_sum))
    flat = flatten_params(tree)
    return losses, np.concatenate([np.asarray(flat[n], np.float32).ravel() for n in params])


def port_trajectory(params: dict, chunk_loss=None, compute: str = "bfloat16"):
    """(losses, parameters as one vector) of STEPS steps of the port's step
    in ``compute`` from ``params``, on JAX's draws; ``chunk_loss(step, x0,
    cond, valid, noise, t)`` replaces the step's own when given."""
    tm = DiffusionUNetFactory().build(TINY_UNET, conditioning="concatenate", channels=1,
                                      device="cpu")
    tm.load_state_dict({n: torch.from_numpy(v.copy()) for n, v in params.items()})
    tm.train()
    optimizer, schedule = make_adamw(tm.parameters(), LR, WD, WARMUP, TOTAL)
    step = make_denoise_train_step(
        tm, FlowMatchEulerDiscreteScheduler.create(num_train_timesteps=N_TRAIN), optimizer,
        schedule, variant="flow_matching", conditioning_mode="concatenate", latent_norm=None,
        compute_dtype=getattr(torch, compute), device="cpu")
    if chunk_loss is not None:
        step.chunk_loss = lambda *args: chunk_loss(step, *args)
    losses = []
    for i in range(STEPS):
        batch, _, noise, t = draws(i)
        loss_sum, _ = step.step({k: torch.from_numpy(v) for k, v in batch.items()},
                                noise=torch.from_numpy(noise), t=torch.from_numpy(t))
        losses.append(float(loss_sum))
    assert step.global_step == STEPS
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    return losses, np.concatenate([p.detach().numpy().ravel() for p in tm.parameters()])


def without_one_minus_t(step, x0, cond, valid, noise, t):
    """The flow step's loss with a planted fault: x0 + t * noise in place of
    (1 - t) * x0 + t * noise."""
    tb = t.reshape((-1,) + (1,) * (x0.dim() - 1))
    model_input = torch.cat([(x0 + tb * noise).to(torch.bfloat16), cond.to(torch.bfloat16)], 1)
    model_t = (t * (N_TRAIN - 1)).to(torch.int32)
    pred = step.model(model_input, model_t).float()
    per_sample = torch.square(pred - (noise - x0)).mean(dim=(1, 2, 3))
    loss_sum = (per_sample * valid).sum()
    return loss_sum / valid.sum(), loss_sum, valid.sum()


def start_params() -> dict:
    """The start of both trajectories: JAX's layout of numpy weights drawn
    from a seed, loaded into the port (name -> array, the port's order)."""
    jm = JaxFactory().build(TINY_UNET, conditioning="concatenate", channels=1)
    tm = DiffusionUNetFactory().build(TINY_UNET, conditioning="concatenate", channels=1,
                                      device="cpu")
    _, tm = _pair(jm, tm, seed=50)
    return {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}


def test_bf16_flow_trajectory_follows_jax():
    params = start_params()
    begin = np.concatenate([v.ravel() for v in params.values()])
    want, jax_side = jax_trajectory(params)
    got, port = port_trajectory(params)
    assert np.isfinite(got).all() and np.isfinite(port).all()
    # the trajectory moved
    assert np.linalg.norm(jax_side - begin) > 0
    loss_err, param_err = trajectory_errors(got, want, port, jax_side, begin)
    assert loss_err <= LOSS_TOL, (got, want)
    assert param_err <= PARAM_TOL, param_err
    # the control: the same check refuses a flow target without its (1 - t)
    got, port = port_trajectory(params, without_one_minus_t)
    loss_err, param_err = trajectory_errors(got, want, port, jax_side, begin)
    assert loss_err > LOSS_TOL or param_err > PARAM_TOL, (loss_err, param_err)
