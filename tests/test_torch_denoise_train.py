"""The port's denoising train step against ``fmdm_tpu.train.common``'s, on the
CPU in f32.

The model is the flagship's block topology at reduced width
(``REDUCED_UNET``) at 32², weights drawn with numpy and loaded into both
sides. JAX's jitted ``make_denoise_train_step`` runs as it is; its averaged
gradient is read through an ``optax.GradientTransformation`` that returns
zero updates and keeps the gradients in its state. The port gets the noise
and t that JAX draws from the same key: ``split(rng)`` into the noise's and
t's keys, after ``split(rng, n_chunks)`` per chunk when there are several.
Each tolerance says what it allows for.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.schedulers import DDPMScheduler as JaxDDPM
from fmdm_tpu.schedulers import FlowMatchEulerDiscreteScheduler as JaxFlow
from fmdm_tpu.train.common import cosine_warmup_schedule as jax_cosine_warmup
from fmdm_tpu.train.common import make_adamw as jax_make_adamw
from fmdm_tpu.train.common import make_denoise_train_step as jax_make_step
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.schedulers import DDPMScheduler, FlowMatchEulerDiscreteScheduler
from fmdm_tpu_torch.train.common import (
    cosine_warmup_schedule, make_adamw, make_denoise_train_step)
from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer
from tests.test_torch_models import REDUCED_UNET, TINY_UNET, _pair

CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "LDCT"
RES = 32
LR, WD, WARMUP, TOTAL = 1e-3, 1e-2, 1, 3   # step 0 at rate 0, step 1 at the full rate
SCHED = dict(beta_start=0.0001, beta_end=0.02)
SCHEDULERS = {"diffusion": (JaxDDPM, DDPMScheduler),
              "flow_matching": (JaxFlow, FlowMatchEulerDiscreteScheduler)}


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The suite runs in several processes on a few cores, each beside JAX's
    compiler: keep torch's own thread pool small while these tests run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _gradient_reader():
    """An optax transformation that applies nothing and keeps the gradients."""
    def init(params):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), {"g": updates}

    return optax.GradientTransformation(init, update)


def _tree(named):
    """A JAX tree of copies of the port's parameters (the JAX step donates
    its inputs, and the port's optimizer updates its tensors in place)."""
    return unflatten_params({n: jnp.asarray(p.detach().numpy().copy()) for n, p in named})


def jax_draws(rng, variant: str, rows: int, n_chunks: int, n_train: int):
    """The noise and t of ``make_denoise_train_step`` for a padded batch of
    ``rows`` (1, RES, RES) samples, as numpy arrays."""
    keys = [rng] if n_chunks == 1 else list(jax.random.split(rng, n_chunks))
    chunk = rows // n_chunks
    noise, t = [], []
    for key in keys:
        key_noise, key_t = jax.random.split(key)
        noise.append(np.array(jax.random.normal(key_noise, (chunk, 1, RES, RES), jnp.float32)))
        if variant == "diffusion":
            t.append(np.array(jax.random.randint(key_t, (chunk,), 0, n_train)))
        else:
            t.append(np.array(jax.random.uniform(key_t, (chunk,), jnp.float32)))
    return np.concatenate(noise), np.concatenate(t)


def _batch(seed: int, valid):
    rng = np.random.default_rng(seed)
    b = len(valid)
    return {"target": rng.standard_normal((b, 1, RES, RES)).astype(np.float32),
            "image": rng.standard_normal((b, 1, RES, RES)).astype(np.float32),
            "valid": np.asarray(valid, np.float32)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _models(unet_cfg, seed):
    jm = JaxFactory().build(unet_cfg, conditioning="concatenate", channels=1)
    tm = DiffusionUNetFactory().build(unet_cfg, conditioning="concatenate", channels=1,
                                      device="cpu")
    _, tm = _pair(jm, tm, seed=seed)
    return jm, tm.train()


def _assert_grads_match(tm, want_grads):
    """Gradients: sums over a few dozen layers' products, chunks summed, at
    rtol 1e-3 and an atol of 1e-4 of the tensor's largest gradient. Some are
    zero up to rounding (a bias whose shift a GroupNorm of one-channel groups
    removes next): those get an atol of 1e-6 of the model's largest gradient."""
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    flat = {n: np.asarray(g) for n, g in flatten_params(want_grads).items()}
    assert grads.keys() == flat.keys()
    floor = 1e-6 * max(float(np.abs(g).max()) for g in flat.values())
    for name, g in flat.items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g).max()) + floor, err_msg=name)


def check_train_step_against_jax(variant: str, grad_accum: int) -> None:
    """Batch 3 with its middle row masked; grad_accum 2 makes chunks of 2,
    the second padded with one zero row. At each of two steps JAX starts from
    the port's parameters: loss_sum, count and every averaged gradient are
    held against JAX's, and the parameters after the step against
    ``optax.adamw`` at JAX's cosine-warmup rate (its state carried over both
    steps) applied to the same gradients: elementwise f32 arithmetic, so
    within an ulp or two of a parameter. (The flow-matching cases live in
    ``test_torch_flow_train.py``, so that the test runner's workers share
    the JAX compiles.)"""
    jax_cls, port_cls = SCHEDULERS[variant]
    jm, tm = _models(REDUCED_UNET, seed=30)
    jstep = jax_make_step(jm, jax_cls.create(**SCHED), _gradient_reader(), variant=variant,
                          conditioning_mode="concatenate", latent_norm=None,
                          grad_accum=grad_accum)
    optimizer, schedule = make_adamw(tm.parameters(), LR, WD, WARMUP, TOTAL)
    step = make_denoise_train_step(tm, port_cls.create(**SCHED), optimizer, schedule,
                                   variant=variant, conditioning_mode="concatenate",
                                   latent_norm=None, grad_accum=grad_accum, device="cpu")
    adamw, _ = jax_make_adamw(LR, WD, WARMUP, TOTAL)
    opt_state = adamw.init(_tree(tm.named_parameters()))
    n_chunks, rows = (1, 3) if grad_accum == 1 else (2, 4)
    for i in range(2):
        batch = _batch(31 + i, [1.0, 0.0, 1.0])
        rng = jax.random.PRNGKey(40 + i)
        before = _tree(tm.named_parameters())
        reader = _gradient_reader()
        _, state, want_sum, want_count = jstep(_tree(tm.named_parameters()),
                                               reader.init(before), _jax_batch(batch), rng)
        noise, t = jax_draws(rng, variant, rows, n_chunks, 1000)
        got_sum, got_count = step.step(_torch_batch(batch), noise=torch.from_numpy(noise),
                                       t=torch.from_numpy(t))
        assert float(got_count) == float(want_count) == 2.0
        # a scalar sum over the batch of f32 means
        assert float(got_sum) == pytest.approx(float(want_sum), rel=1e-5)
        _assert_grads_match(tm, state["g"])

        grads = unflatten_params({n: jnp.asarray(p.grad.numpy().copy())
                                  for n, p in tm.named_parameters()})
        updates, opt_state = adamw.update(grads, opt_state, before)
        want = flatten_params(optax.apply_updates(before, updates))
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    assert step.global_step == 2


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax_over_two_steps(grad_accum):
    check_train_step_against_jax("diffusion", grad_accum)


def test_cosine_warmup_schedule_matches_jax():
    for base, warmup, total in ((1e-4, 500, 62500), (1e-3, 1, 3), (2e-4, 0, 10)):
        jax_schedule = jax_cosine_warmup(base, warmup, total)
        port = cosine_warmup_schedule(base, warmup, total)
        steps = sorted({0, 1, warmup // 2, max(warmup - 1, 0), warmup, warmup + 1,
                        (warmup + total) // 2, total - 1, total, total + 5})
        for s in steps:
            # JAX evaluates the schedule in f32, the port in float64: a few
            # f32 ulps of base_lr apart where the cosine nears -1
            assert port(s) == pytest.approx(float(jax_schedule(s)), rel=1e-6, abs=1e-7 * base), s


def test_ema_follows_jax_over_two_steps():
    """JAX's EMA step replays the port's update through its optimizer slot,
    so both shadows follow the same parameters: e += (1 - decay) (p - e),
    elementwise in f32."""
    decay = 0.9
    jm, tm = _models(TINY_UNET, seed=32)
    optimizer, schedule = make_adamw(tm.parameters(), LR, WD, 0, 4)
    step = make_denoise_train_step(tm, DDPMScheduler.create(**SCHED), optimizer, schedule,
                                   variant="diffusion", conditioning_mode="concatenate",
                                   latent_norm=None, ema_decay=decay, device="cpu")
    # the optimizer's state carries the update to apply (an argument of the
    # jitted step, so each call applies its own)
    replay = optax.GradientTransformation(lambda params: {}, lambda u, state, p=None: (state, state))
    jstep = jax_make_step(jm, JaxDDPM.create(**SCHED), replay, variant="diffusion",
                          conditioning_mode="concatenate", latent_norm=None, ema_decay=decay)
    ema = _tree(tm.named_parameters())
    for i in range(2):
        batch = _batch(33 + i, [1.0, 1.0])
        before = _tree(tm.named_parameters())
        step.step(_torch_batch(batch), generator=torch.Generator().manual_seed(i))
        after = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
        update = unflatten_params({n: jnp.asarray(after[n]) - v for n, v in
                                   flatten_params(before).items()})
        params, _, ema, _, _ = jstep(before, update, ema, _jax_batch(batch), jax.random.PRNGKey(i))
        np.testing.assert_allclose(np.concatenate([np.asarray(v).ravel() for v in
                                                   flatten_params(params).values()]),
                                   np.concatenate([after[n].ravel() for n in
                                                   flatten_params(params)]), rtol=1e-6, atol=1e-7)
        ema_flat = flatten_params(ema)
        for (name, _), shadow in zip(tm.named_parameters(), step.ema):
            np.testing.assert_allclose(shadow.numpy(), np.asarray(ema_flat[name]), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        ema = jax.tree_util.tree_map(jnp.copy, ema)


def _small_step(seed: int, **kw):
    _, tm = _models(TINY_UNET, seed=seed)
    optimizer, schedule = make_adamw(tm.parameters(), LR, 0.0, 0, 4)
    return tm, make_denoise_train_step(tm, DDPMScheduler.create(**SCHED), optimizer, schedule,
                                       variant="diffusion", conditioning_mode="concatenate",
                                       latent_norm=None, device="cpu", **kw)


def test_remat_gives_the_gradients_of_the_plain_step():
    batch = _batch(35, [1.0, 1.0, 1.0])
    noise = torch.from_numpy(np.random.default_rng(36).standard_normal(
        (4, 1, RES, RES)).astype(np.float32))
    t = torch.tensor([10, 500, 999, 3])
    grads = []
    for remat in (False, True):
        tm, step = _small_step(37, remat=remat, grad_accum=2)
        step.step(_torch_batch(batch), noise=noise, t=t)
        grads.append([p.grad.clone() for p in tm.parameters()])
    # the recomputed forward is the same CPU arithmetic
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)


def test_bf16_compute_runs_near_jax():
    """compute_dtype bf16 casts the model's input and computes the UNet in
    bf16 on f32 parameters; the gradients stay f32. The two sides round at
    other places by design (JAX's GroupNorm rounds to bf16 before SiLU, the
    port's once after; ROADMAP Queue 3), so the loss is held at 2e-2 and the
    gradient as a whole (all parameters in one vector) at 5e-2 of its norm."""
    jm, tm = _models(TINY_UNET, seed=38)
    optimizer, schedule = make_adamw(tm.parameters(), LR, 0.0, 0, 4)
    step = make_denoise_train_step(tm, DDPMScheduler.create(**SCHED), optimizer, schedule,
                                   variant="diffusion", conditioning_mode="concatenate",
                                   latent_norm=None, compute_dtype=torch.bfloat16, device="cpu")
    jstep = jax_make_step(jm, JaxDDPM.create(**SCHED), _gradient_reader(), variant="diffusion",
                          conditioning_mode="concatenate", latent_norm=None,
                          compute_dtype=jnp.bfloat16)
    batch = _batch(39, [1.0, 1.0])
    rng = jax.random.PRNGKey(7)
    params = _tree(tm.named_parameters())
    _, state, want_sum, _ = jstep(params, _gradient_reader().init(params), _jax_batch(batch), rng)
    noise, t = jax_draws(rng, "diffusion", 2, 1, 1000)
    got_sum, _ = step.step(_torch_batch(batch), noise=torch.from_numpy(noise),
                           t=torch.from_numpy(t))
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    assert float(got_sum) == pytest.approx(float(want_sum), rel=2e-2)
    flat = flatten_params(state["g"])
    got = np.concatenate([p.grad.numpy().ravel() for _, p in tm.named_parameters()])
    want = np.concatenate([np.asarray(flat[n]).ravel() for n, _ in tm.named_parameters()])
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)


def test_step_checks_its_arguments():
    tm, step = _small_step(40)
    batch = _torch_batch(_batch(41, [1.0, 1.0, 1.0]))
    with pytest.raises(ValueError, match="noise"):
        step.step(batch, noise=torch.zeros(2, 1, RES, RES))
    with pytest.raises(ValueError, match="t is"):
        step.step(batch, t=torch.zeros(2, dtype=torch.int64))
    optimizer, schedule = make_adamw(tm.parameters(), LR, 0.0, 0, 4)
    kw = dict(variant="diffusion", conditioning_mode="concatenate", latent_norm=None,
              device="cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        make_denoise_train_step(tm, DDPMScheduler.create(), optimizer, schedule, ema_decay=1.5,
                                **kw)
    with pytest.raises(ValueError, match="variant"):
        make_denoise_train_step(tm, DDPMScheduler.create(), optimizer, schedule,
                                **dict(kw, variant="score"))
    # the mesh is ported: a one-card mesh builds a step, anything else refuses
    from fmdm_tpu_torch.parallel import DataMesh

    one = make_denoise_train_step(tm, DDPMScheduler.create(), optimizer, schedule,
                                  mesh=DataMesh((torch.device("cpu"),)), **kw)
    assert one.mesh is None   # one process: today's path
    with pytest.raises(TypeError, match="DataMesh"):
        make_denoise_train_step(tm, DDPMScheduler.create(), optimizer, schedule, mesh=object(),
                                **kw)
    with pytest.raises(ValueError, match="one card per process"):
        make_denoise_train_step(tm, DDPMScheduler.create(), optimizer, schedule,
                                mesh=DataMesh((torch.device("cpu"),) * 2), **kw)


def _reduced_config(name: str, **training):
    cfg = json.loads((CONFIGS / name).read_text())
    cfg["model"]["unet"].update(block_out_channels=[32, 32, 64, 64, 128, 128])
    cfg["training"].update(training)
    return cfg


@pytest.mark.parametrize("name,variant,scheduler,mixed,dtype", [
    ("LDCT_ddpm_diffusers_nd.json", "diffusion", DDPMScheduler, "no", torch.float32),
    ("LDCT_flow_matching_diffusers_nd.json", "flow_matching", FlowMatchEulerDiscreteScheduler,
     "bf16", torch.bfloat16),
])
def test_build_denoise_trainer_from_the_flagship_configs(name, variant, scheduler, mixed, dtype):
    cfg = _reduced_config(name, gradient_accumulation_steps=2, ema_decay=0.99,
                          mixed_precision=mixed)
    model, sched, step = build_denoise_trainer(cfg, variant=variant, num_samples=20,
                                               device="cpu")
    assert isinstance(sched, scheduler) and step.scheduler is sched and step.model is model
    assert (step.grad_accum, step.ema_decay, step.compute_dtype) == (2, 0.99, dtype)
    assert step.conditioning_mode == "concatenate"
    # 500 epochs of ceil(20 / 8) steps, 500 of them warmup
    assert step.lr_schedule(250) == pytest.approx(0.5e-4)
    assert step.lr_schedule(1500) == pytest.approx(0.0, abs=1e-12)
    batch = {"target": torch.randn(3, 1, RES, RES), "image": torch.randn(3, 1, RES, RES),
             "valid": torch.ones(3)}
    loss_sum, count = step.step(batch, generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(loss_sum)) and float(count) == 3.0


def test_build_denoise_trainer_refuses_what_is_not_ported():
    cfg = _reduced_config("LDCT_ddpm_diffusers_nd.json")
    with pytest.raises(ValueError, match="model_type"):
        build_denoise_trainer(cfg, variant="flow_matching", num_samples=4, device="cpu")
    # the parallel flags are taken: the run loop's plan applies them over the
    # ranks, and raises JAX's errors for what JAX refuses
    from fmdm_tpu_torch.train.common import parallel_plan

    for key, value in (("fsdp", True), ("tensor_parallel", 2), ("sequence_parallel", 2)):
        cfg = _reduced_config("LDCT_ddpm_diffusers_nd.json", **{key: value})
        _, _, step = build_denoise_trainer(cfg, variant="diffusion", num_samples=4, device="cpu")
        assert step.mesh is None
    cpu = torch.device("cpu")
    assert parallel_plan({"fsdp": True}, 4, cpu).kind == "dp"   # one process: nothing to cut
    with pytest.raises(ValueError, match="composes with plain DP only"):
        parallel_plan({"sequence_parallel": 2, "tensor_parallel": 2}, 4, cpu)
    with pytest.raises(ValueError, match="composes with plain DP only"):
        parallel_plan({"sequence_parallel": 2, "fsdp": True}, 4, cpu)
    for key in ("tensor_parallel", "sequence_parallel"):
        with pytest.raises(ValueError, match="must divide the device count 1"):
            parallel_plan({key: 2}, 4, cpu)
