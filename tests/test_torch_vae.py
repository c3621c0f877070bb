"""The port's KL-VAE against the JAX package's, on the CPU in f32.

The model is the topology of ``configs/LDCT/LDCT_autoencoder_kl.json`` (four
stages, two ResBlocks each, the mid attention of 4 heads x 64 kept) cut to
resolution 32 and narrow widths. Weights are drawn with numpy in the shapes
of the JAX parameter tree (every one of them, the zero-initialized output
projections included, so every gradient path carries signal), loaded into the
JAX model as a tree and into the port with ``load_jax_params`` (strict).

The train step's JAX side is built from the JAX model's own methods and
``optax.adamw``, following the closure of ``fmdm_tpu/train/vae_impl.py``
(:297-342 losses, :353-408 the step) line by line, with the posterior noise
given to both sides. Each tolerance says what it allows for.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fmdm_tpu.models.factories import VAEFactory as JaxVAEFactory
from fmdm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from fmdm_tpu.nn import blocks as jblocks
from fmdm_tpu.nn import vae_modules as jvae
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.sample import vae_utils as jvae_utils
from fmdm_tpu.train.vae_impl import _make_lr_schedule as jax_lr_schedule
from fmdm_tpu_torch.models.factories import VAEFactory
from fmdm_tpu_torch.models.vae import VQVAE, AutoencoderKL
from fmdm_tpu_torch.nn import blocks, vae_modules
from fmdm_tpu_torch.sample import vae_utils
from fmdm_tpu_torch.train.vae_impl import KLTrainStep, kl_scale_at, make_lr_schedule
from fmdm_tpu_torch.utils.weights import load_jax_params

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "LDCT" / "LDCT_autoencoder_kl.json"
FULL_MODEL = json.loads(CONFIG.read_text())["model"]
REDUCED_MODEL = dict(FULL_MODEL, resolution=32, base_ch=16, down_channels=[16, 32, 32, 64],
                     attn_heads=4, attn_dim_head=8)
# f32 through a few dozen layers, sums in another order
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def random_flat_params(jax_module, seed: int):
    """numpy weights in the JAX tree's shapes: U(±1/√fan_in) for conv/linear
    weights, 1±0.1 / ±0.1 for GroupNorm affines, U(±0.1) for other biases."""
    rng = np.random.default_rng(seed)
    flat = {}
    shapes = flatten_params(jax.eval_shape(jax_module.init, jax.random.PRNGKey(0)))
    for name, leaf in shapes.items():
        shape = leaf.shape
        if len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            value = rng.uniform(-bound, bound, shape)
        elif "norm" in name.split(".")[-2]:
            value = (1.0 if name.endswith("weight") else 0.0) + 0.1 * rng.standard_normal(shape)
        else:
            value = rng.uniform(-0.1, 0.1, shape)
        flat[name] = value.astype(np.float32)
    return flat


def _pair(jax_module, torch_module, seed):
    flat = random_flat_params(jax_module, seed)
    load_jax_params(torch_module, flat)
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), torch_module


def _jax_kl():
    kw = {k: v for k, v in REDUCED_MODEL.items() if k not in ("latent_type", "model_type")}
    return JaxAutoencoderKL(**kw)


def _port_kl():
    return VAEFactory().build(REDUCED_MODEL, device="cpu")


def _images(seed, batch):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (batch, 1, 32, 32)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_spatial_self_attention_matches_jax():
    # 4 heads of d=8 over 6x6 tokens: the raw-reshape head split is checked
    # with a non-trivial proj_out (zero at init, random here)
    jb = jblocks.SpatialSelfAttention(32, heads=4, dim_head=8)
    params, tb = _pair(jb, blocks.SpatialSelfAttention(32, heads=4, dim_head=8, device="cpu"), 1)
    x = np.random.default_rng(2).standard_normal((2, 32, 6, 6)).astype(np.float32)
    with torch.no_grad():
        got = tb(_t(x))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(jb(params, jnp.asarray(x))), **F32_TOL)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encoder_and_decoder_match_jax(part):
    params, tm = _pair(_jax_kl(), _port_kl(), seed=3)
    jmodule = getattr(_jax_kl(), part)
    shape = (2, 1, 32, 32) if part == "encoder" else (2, 4, 4, 4)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(jmodule(params[part], jnp.asarray(x)))
    with torch.no_grad():
        got = getattr(tm, part)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_encode_decode_reconstruct_match_jax():
    jm = _jax_kl()
    params, tm = _pair(jm, _port_kl(), seed=5)
    images = _images(6, 2)
    latents = np.random.default_rng(7).standard_normal((2, 4, 4, 4)).astype(np.float32)
    with torch.no_grad():
        got = (vae_utils.encode_vae_batch(tm, _t(images)),
               vae_utils.decode_vae_batch(tm, _t(latents)),
               vae_utils.reconstruct_vae_batch(tm, _t(images)),
               tm.encode(_t(images * 2 - 1), normalize=True),
               tm.decode(_t(latents), denorm=True))
    want = (jvae_utils.encode_vae_batch(jm, params, jnp.asarray(images)),
            jvae_utils.decode_vae_batch(jm, params, jnp.asarray(latents)),
            jvae_utils.reconstruct_vae_batch(jm, params, jnp.asarray(images)),
            jm.encode(params, jnp.asarray(images) * 2 - 1, normalize=True),
            jm.decode(params, jnp.asarray(latents), denorm=True))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


def test_posterior_sample_and_kl_match_jax():
    moments = np.random.default_rng(8).standard_normal((2, 8, 4, 4)).astype(np.float32) * 3
    noise = np.random.default_rng(9).standard_normal((2, 4, 4, 4)).astype(np.float32)
    jp, tp = jvae.DiagonalGaussian(jnp.asarray(moments)), vae_modules.DiagonalGaussian(_t(moments))
    np.testing.assert_allclose(tp.sample(_t(noise)).numpy(),
                               np.asarray(jp.mu + jp.std * jnp.asarray(noise)), rtol=1e-6)
    other = vae_modules.DiagonalGaussian(_t(moments[:, ::-1].copy()))
    jother = jvae.DiagonalGaussian(jnp.asarray(moments[:, ::-1].copy()))
    for got, want in ((tp.kl(), jp.kl()), (tp.kl(other), jp.kl(jother)),
                      (tp.nll(_t(noise)), jp.nll(jnp.asarray(noise)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert tp.sample(generator=gen).shape == (2, 4, 4, 4)
    assert torch.equal(vae_modules.DiagonalGaussian(_t(moments), deterministic=True).sample(),
                       tp.mode())


def test_vae_factory_full_width_names_and_shapes_equal_jax():
    """The shipped config at full width: every dotted name and shape of the
    JAX tree, and nothing else, loads with strict=True (meta device)."""
    jm = JaxVAEFactory().build_from_json(CONFIG)
    shapes = {k: tuple(v.shape) for k, v in
              flatten_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0))).items()}
    tm = VAEFactory().build_from_json(CONFIG, device="meta")
    assert isinstance(tm, AutoencoderKL)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == shapes
    tm.load_state_dict({k: torch.empty(s, device="meta") for k, s in shapes.items()},
                       strict=True, assign=True)
    assert shapes["encoder.mid_attn.qkv.weight"] == (768, 512, 1)  # 4 heads x 64, T = 32²
    assert shapes["decoder.ups.3.up.conv.conv.weight"] == (512, 512, 3, 3)


def test_vq_and_unported_training_options_raise():
    """VQ builds, and the perceptual, VQ, bce and GAN recipes, a VQ model's
    discriminator and rmsnorm are ported; fsdp, tensor and sequence
    parallelism are taken by the step (the run loop's plan applies them),
    and the combination JAX's VAE trainer refuses raises its ValueError."""
    vq = VAEFactory().build(dict(REDUCED_MODEL, latent_type="vq"), device="cpu")
    assert isinstance(vq, VQVAE)
    assert type(vq.make_discriminator(device="cpu")).__name__ == "PatchDiscriminator"
    block = blocks.ResBlockND(8, None, 0.0, norm_type="rmsnorm", device="cpu")
    assert type(block.norm1).__name__ == "RMSNormND"
    model = _port_kl()
    from fmdm_tpu_torch.train.common import parallel_plan

    for option in ({"fsdp": True}, {"tensor_parallel": 2}, {"sequence_parallel": 2}):
        assert KLTrainStep(model, option).mesh is None
    with pytest.raises(ValueError, match="composes with plain DP only"):
        parallel_plan({"sequence_parallel": 2, "tensor_parallel": 2}, 4, torch.device("cpu"),
                      vae=True)
    for option in ({"perceptual_weight": 0.1}, {"reg_type": "vq"}, {"recon_type": "bce"},
                   {"recon_type": "focal"}, {"gan_weight": 0.5}):
        KLTrainStep(model, option)
        KLTrainStep(vq, option)
    assert KLTrainStep(model, {"gan_weight": 0.5}).discriminator is not None


@pytest.mark.parametrize("scheduler", [
    None,
    {"name": "StepLR", "params": {"step_size": 2, "gamma": 0.5}},
    {"name": "CosineAnnealingLR", "params": {"T_max": 3, "eta_min": 1e-5}},
    {"name": "ExponentialLR", "params": {"gamma": 0.7}},
])
def test_lr_schedules_match_jax(scheduler):
    cfg = {"scheduler": scheduler} if scheduler else {}
    ours, theirs = make_lr_schedule(1e-3, cfg, 4, 3), jax_lr_schedule(1e-3, cfg, 4, 3)
    for step in range(15):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6)


def test_kl_anneal_matches_the_jax_loop():
    # vae_impl.py:513-515
    assert [kl_scale_at(1e-2, 4, s) for s in range(6)] == pytest.approx(
        [2.5e-3, 5e-3, 7.5e-3, 1e-2, 1e-2, 1e-2])
    assert kl_scale_at(1e-2, 0, 7) == 1e-2


# the step's config: KL annealed over 3 steps, a per-step StepLR decay and
# decoupled weight decay, so two steps exercise every term
TRAINING = {"learning_rate": 1e-3, "weight_decay": 0.01, "kl_weight": 1e-2, "kl_anneal_steps": 3,
            "recon_type": "l1", "epochs": 2,
            "scheduler": {"name": "StepLR", "params": {"step_size": 1, "gamma": 0.5}}}


def _jax_step_fns(model):
    """vae_impl.py:297-342 and :353-408 for reg_type "kl", recon "l1", no
    perceptual or GAN loss, with the posterior noise given (jitted)."""
    def recon_loss_fn(rec_img, raw, valid):
        mask = valid.reshape((-1,) + (1,) * (raw.ndim - 1))
        denom = jnp.maximum(jnp.sum(valid), 1.0) * math.prod(raw.shape[1:])
        return jnp.sum(jnp.abs(rec_img - raw) * mask) / denom

    def forward_losses(gen_p, raw, valid, noise, kl_scale):
        inputs = model.image_to_model_range(raw)
        posterior = model.encode(gen_p, inputs)
        rec = model.decode(gen_p, posterior.mu + posterior.std * noise)  # posterior.sample
        kl_term = jnp.mean(posterior.kl())
        rec_img = model.raw_output_to_image(rec, recon_type="l1")
        recon = recon_loss_fn(rec_img, raw, valid)
        total = recon + kl_scale * kl_term
        return total, {"loss": total, "recon": recon, "kl": kl_term}

    return jax.jit(jax.value_and_grad(forward_losses, argnums=0, has_aux=True))


def _jax_grads(gen_grad, params, raw, valid, noise, kl_scale, n_chunks):
    """The step's padding, chunk loop (the lax.scan body) and gradient
    average: (summed metrics, count, averaged gradients)."""
    chunk = max(1, -(-raw.shape[0] // n_chunks))
    pad = n_chunks * chunk - raw.shape[0]
    if pad:
        wrap = jnp.arange(pad) % raw.shape[0]
        raw = jnp.concatenate([raw, jnp.take(raw, wrap, axis=0)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), valid.dtype)])
    g_acc = jax.tree_util.tree_map(lambda p: jnp.zeros_like(p, jnp.float32), params)
    m_acc = {k: jnp.zeros((), jnp.float32) for k in ("loss", "recon", "kl")}
    count = jnp.float32(0.0)
    for i in range(n_chunks):
        rows = slice(i * chunk, (i + 1) * chunk)
        (_, metrics), grads = gen_grad(params, raw[rows], valid[rows], noise[rows], kl_scale)
        c = jnp.sum(valid[rows])
        g_acc = jax.tree_util.tree_map(lambda a, g: a + g * c, g_acc, grads)
        m_acc = {k: m_acc[k] + metrics[k] * c for k in m_acc}
        count = count + c
    return m_acc, count, jax.tree_util.tree_map(lambda g: g / jnp.maximum(count, 1.0), g_acc)


def _tree(named):
    """A JAX tree of copies (a CPU array may alias the numpy buffer, and the
    optimizer updates the torch tensors in place)."""
    return unflatten_params({n: jnp.asarray(t.detach().numpy().copy()) for n, t in named})


def test_train_step_matches_jax_over_two_steps():
    """Batch 3 in n_chunks=2: the second chunk holds one wrap-padded row,
    masked out of the loss and the counts. At each of two steps, the JAX side
    starts from the port's parameters: the metrics and the averaged gradients
    are compared with JAX's, and the parameters after the step with
    ``optax.adamw`` (its state carried over both steps) applied to the same
    gradients. Adam's first step moves every weight by about lr·sign(g), so
    a gradient at rounding level on the two sides may take either sign; that
    is why the update is held against optax on shared gradients and not
    against a JAX trajectory."""
    jm = _jax_kl()
    _, tm = _pair(jm, _port_kl(), seed=10)
    schedule = jax_lr_schedule(TRAINING["learning_rate"], TRAINING, 2, 1)
    optimizer = optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8,
                            weight_decay=TRAINING["weight_decay"])
    opt_state = optimizer.init(_tree(tm.named_parameters()))
    trainer = KLTrainStep(tm, TRAINING, steps_per_epoch=1, n_chunks=2)
    gen_grad = _jax_step_fns(jm)
    rng = np.random.default_rng(11)
    for step in range(2):
        raw = _images(12 + step, 3)
        valid = np.ones(3, np.float32)
        noise = rng.standard_normal((4, 4, 4, 4)).astype(np.float32)
        kl_scale = kl_scale_at(TRAINING["kl_weight"], TRAINING["kl_anneal_steps"], step)
        before = _tree(tm.named_parameters())
        want_m, want_count, want_g = _jax_grads(
            gen_grad, before, jnp.asarray(raw), jnp.asarray(valid), jnp.asarray(noise),
            jnp.float32(kl_scale), n_chunks=2)
        got_m, got_count = trainer.step(_t(raw), _t(valid), noise=_t(noise))
        assert float(got_count) == float(want_count) == 3.0
        for k in ("loss", "recon", "kl"):
            # scalar sums over two chunks, f32
            assert float(got_m[k]) == pytest.approx(float(want_m[k]), rel=1e-5), k
        # gradients: sums over 2 chunks of a few dozen layers' products
        grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
        for name, g in flatten_params(want_g).items():
            g = np.asarray(g)
            np.testing.assert_allclose(grads[name], g, rtol=1e-3,
                                       atol=1e-4 * float(np.abs(g).max()) + 1e-8, err_msg=name)
        # AdamW with the StepLR rate and decoupled decay against optax.adamw
        # on the same gradients: elementwise f32 arithmetic, so within an ulp
        # or two of the parameter (|p| < 1), 1e-4 of an update
        updates, opt_state = optimizer.update(
            unflatten_params({n: jnp.asarray(g) for n, g in grads.items()}), opt_state, before)
        want = flatten_params(optax.apply_updates(before, updates))
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_eval_step_matches_jax():
    jm = _jax_kl()
    params, tm = _pair(jm, _port_kl(), seed=14)
    raw, valid = _images(15, 3), np.array([1.0, 0.0, 1.0], np.float32)
    trainer = KLTrainStep(tm, TRAINING)
    got, count = trainer.eval(_t(raw), _t(valid))
    # vae_impl.py:441-451 at the posterior's mode
    inputs = jm.image_to_model_range(jnp.asarray(raw))
    rec, mu, logvar = jax.jit(lambda p, x: (lambda r, q: (r, q.mu, q.logvar))(
        *jm(p, x, sample_posterior=False)))(params, inputs)
    mask = jnp.asarray(valid).reshape(-1, 1, 1, 1)
    recon = jnp.sum(jnp.abs(jm.raw_output_to_image(rec) - raw) * mask) / (2.0 * 32 * 32)
    kl = jnp.mean(0.5 * jnp.sum(mu ** 2 + jnp.exp(logvar) - 1.0 - logvar, axis=(1, 2, 3)))
    want = {"recon": recon * 2, "kl": kl * 2,
            "loss": (recon + kl_scale_at(1e-2, 3, 0) * kl) * 2}
    assert float(count) == 2.0
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5), k
