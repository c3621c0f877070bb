"""The port's GAN step against the JAX package's, on the CPU in f32: the
BatchNorm of the discriminators (batch statistics in train mode, the stored
and never-updated running statistics in eval mode, in 1, 2 and 3 D), both
discriminators (their state-dict names against ``flatten_params`` and their
forwards), the two-optimizer train step over two steps of two chunks with
the perceptual loss on a surrogate VGG16 file (losses, gradients, both
models' parameters after each update, each step from the same weights), the no-leak rule (D's gradients are those of
its own loss alone), the gate (``gan_start``, ``gan_start_steps``), the eval
step's ``g_gan``/``d_gan``, and checkpoints: the port's round trip and a
resume from the JAX package's GAN checkpoint (its discriminator's optax
state at a constant rate: 2n + 1 leaves).

Tolerances: BatchNorm and the discriminators' forwards within 1e-6 of the
output's largest magnitude (reductions and convolutions summed in another
order; 2e-6 in 3 D, where each 4x4x4 convolution sums 64 taps per
channel); the step's losses within 1e-5 relative; each step's averaged
gradients within 1e-3 relative or a noise floor: 5e-4 of the tensor's
largest gradient (the L1 terms' kinks) or 1e-5 of the model's, whichever is
larger; parameters after each update within 1e-5 of the tensor's largest
magnitude plus what Adam's normalization makes of the gradients'
differences: the rate times their relative error, up to twice the summed
rates where a gradient lies at the noise floor (the attention key biases
and the conv biases before a BatchNorm, whose gradients are 0 in exact
arithmetic); BatchNorm's running statistics exactly.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fmdm_tpu.models.vae import VQVAE as JaxVQVAE
from fmdm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from fmdm_tpu.nn import layers as jlayers
from fmdm_tpu.nn import losses as jlosses
from fmdm_tpu.nn import vae_modules as jvae_modules
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.train import vae_impl as jvae
from fmdm_tpu.utils import checkpoint as jckpt
from fmdm_tpu_torch.models.factories import VAEFactory
from fmdm_tpu_torch.nn import layers as tlayers
from fmdm_tpu_torch.nn import losses as tlosses
from fmdm_tpu_torch.nn import vae_modules as tvae_modules
from fmdm_tpu_torch.train import vae_impl as tvae
from fmdm_tpu_torch.utils import checkpoint as tckpt
from fmdm_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_vae import REDUCED_MODEL, random_flat_params

FWD_TOL = 1e-6
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=FWD_TOL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _jax_tree(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def disc_flat_params(jax_disc, seed: int, stats: bool = False):
    """A discriminator's numpy weights: U(±1/√fan_in) convs, BatchNorm
    affines 1±0.1 / ±0.1, running statistics 0 and 1 (what JAX keeps them
    at), or drawn (``stats``) to exercise the eval formula."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, leaf in flatten_params(jax_disc.init(jax.random.PRNGKey(0))).items():
        shape, kind = leaf.shape, name.rsplit(".", 1)[1]
        if len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            value = rng.uniform(-bound, bound, shape)
        elif name.endswith("conv.bias"):
            value = rng.uniform(-0.1, 0.1, shape)
        elif kind == "weight":
            value = 1.0 + 0.1 * rng.standard_normal(shape)
        elif kind == "bias":
            value = 0.1 * rng.standard_normal(shape)
        elif kind == "running_mean":
            value = 0.2 * rng.standard_normal(shape) if stats else np.zeros(shape)
        else:
            value = rng.uniform(0.5, 2.0, shape) if stats else np.ones(shape)
        flat[name] = value.astype(np.float32)
    return flat


# ---------------------------------------------------------------------------
# BatchNorm and the discriminators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 6, 9), (3, 6, 5, 7), (2, 6, 3, 4, 5)],
                         ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax_and_never_updates_its_statistics(shape, train):
    rng = np.random.default_rng(len(shape))
    flat = {"weight": rng.uniform(0.5, 1.5, 6), "bias": rng.uniform(-0.5, 0.5, 6),
            "running_mean": rng.uniform(-0.5, 0.5, 6), "running_var": rng.uniform(0.5, 2.0, 6)}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    x = (rng.standard_normal(shape) * 2 + 0.7).astype(np.float32)
    bn = load_jax_params(tlayers.BatchNorm(6, device="cpu"), flat)
    assert list(bn.state_dict()) == list(flat) == list(
        jlayers.BatchNorm(6).init(jax.random.PRNGKey(0)))
    want = jlayers.BatchNorm(6)(_jax_tree(flat), jnp.asarray(x), train=train)
    got = bn(_t(x), train=train)
    _close(got.detach().numpy(), want)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(bn, name), _t(flat[name]))
        assert not getattr(bn, name).requires_grad
    got.sum().backward()
    assert bn.running_mean.grad is None and bn.running_var.grad is None
    assert bn.weight.grad is not None
    xb = _t(x).bfloat16()
    assert torch.equal(bn(xb, train=train), bn(xb.float(), train=train).bfloat16())


DISCRIMINATORS = {
    "patch_2d": (tvae_modules.PatchDiscriminator, jvae_modules.PatchDiscriminator, 2, 64),
    "patch_1d": (tvae_modules.PatchDiscriminator, jvae_modules.PatchDiscriminator, 1, 128),
    "patch_3d": (tvae_modules.PatchDiscriminator, jvae_modules.PatchDiscriminator, 3, 32),
    "magvit_2d": (tvae_modules.MagvitDiscriminatorND, jvae_modules.MagvitDiscriminatorND, 2, 64),
    "magvit_1d": (tvae_modules.MagvitDiscriminatorND, jvae_modules.MagvitDiscriminatorND, 1, 128),
    "magvit_3d": (tvae_modules.MagvitDiscriminatorND, jvae_modules.MagvitDiscriminatorND, 3, 64),
}


@pytest.mark.parametrize("name", list(DISCRIMINATORS))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminators_match_jax(name, train):
    tcls, jcls, nd, side = DISCRIMINATORS[name]
    base = 4 if nd == 3 else 16
    jd = jcls(in_channels=2, base_channels=base, spatial_dims=nd)
    td = tcls(in_channels=2, base_channels=base, spatial_dims=nd, device="cpu")
    flat = disc_flat_params(jd, 3, stats=True)
    assert list(td.state_dict()) == list(flat)          # names and order
    assert "model.3.running_mean" in flat and "model.0.conv.weight" in flat
    load_jax_params(td, flat)
    x = np.random.default_rng(4).standard_normal((3, 2) + (side,) * nd).astype(np.float32)
    want = jax.jit(lambda p, xi: jd(p, xi, train=train))(_jax_tree(flat), jnp.asarray(x))
    got = td(_t(x), train=train)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.detach().numpy(), want, 2 * FWD_TOL if nd == 3 else FWD_TOL)


def test_magvit_2d_alias_and_bad_dims():
    td = tvae_modules.MagvitDiscriminator(in_channels=3, base_channels=8, device="cpu")
    assert list(td.state_dict()) == list(flatten_params(
        jvae_modules.MagvitDiscriminator(in_channels=3, base_channels=8).init(
            jax.random.PRNGKey(0))))
    with pytest.raises(ValueError, match="spatial_dims"):
        tvae_modules.PatchDiscriminator(spatial_dims=4, device="cpu")


@pytest.mark.parametrize("latent_type,kind,cls", [
    ("kl", None, tvae_modules.PatchDiscriminator),
    ("vq", "patchgan", tvae_modules.PatchDiscriminator),
    ("vq", "default", tvae_modules.PatchDiscriminator),
    ("vq", "magvit", tvae_modules.MagvitDiscriminatorND),
])
def test_models_make_their_discriminators(latent_type, kind, cls):
    cfg = dict(REDUCED_MODEL, latent_type=latent_type, out_channels=3, codebook_size=8)
    if kind is not None:
        cfg["discriminator_type"] = kind
    model = VAEFactory().build(cfg, device="cpu")
    disc = model.make_discriminator(device="cpu")
    assert type(disc) is cls and disc.model[0].conv.weight.shape[1] == 3
    jkw = {k: v for k, v in cfg.items() if k not in ("latent_type", "model_type")}
    jm = (JaxVQVAE if latent_type == "vq" else JaxAutoencoderKL)(**jkw)
    assert list(disc.state_dict()) == list(flatten_params(
        jm.make_discriminator().init(jax.random.PRNGKey(0))))


def test_an_unknown_discriminator_raises_jax_error():
    model = VAEFactory().build(dict(REDUCED_MODEL, latent_type="vq", codebook_size=8,
                                    discriminator_type="stylegan"), device="cpu")
    with pytest.raises(ValueError, match="Unknown discriminator_type 'stylegan'"):
        model.make_discriminator(device="cpu")


# ---------------------------------------------------------------------------
# the two-optimizer step
# ---------------------------------------------------------------------------

# the KL-VAE's topology at 16² in two stages of 64 channels (groups of 2+
# channels), its discriminator at base 64 (the default)
GAN_MODEL = dict(REDUCED_MODEL, resolution=16, base_ch=64, down_channels=[64, 64],
                 attn_heads=2, attn_dim_head=8)
GAN_STEP = {"learning_rate": 1e-4, "weight_decay": 0.0, "epochs": 2, "kl_weight": 1e-2,
            "recon_type": "l1", "gan_weight": 0.5, "gan_start": 0, "disc_lr": 2e-4,
            "perceptual_weight": 0.5, "seed": 4}


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    return tlosses.write_surrogate_vgg16(tmp_path_factory.mktemp("vgg") / "vgg16.npz", seed=7)


def _jax_kl(model_cfg):
    return JaxAutoencoderKL(**{k: v for k, v in model_cfg.items()
                               if k not in ("latent_type", "model_type")})


def _jax_gan_step_fns(jm, jd, training, perceptual):
    """vae_impl.py:315-409 for a KL model with the GAN on: the generator's
    value_and_grad (D's parameters a constant), D's, and the eval step."""
    pw, gw = float(training["perceptual_weight"]), float(training["gan_weight"])
    pparams = perceptual.load_params()

    def forward_losses(gen_p, disc_p, raw, valid, noise, kl_scale, train_mode):
        inputs = jm.image_to_model_range(raw)
        posterior = jm.encode(gen_p, inputs)
        z = posterior.mu + posterior.std * noise if train_mode else posterior.mode()
        rec = jm.decode(gen_p, z)
        rec_img = jm.raw_output_to_image(rec, recon_type="l1")
        mask = valid.reshape((-1,) + (1,) * (raw.ndim - 1))
        denom = jnp.maximum(jnp.sum(valid), 1.0) * math.prod(raw.shape[1:])
        recon = jnp.sum(jnp.abs(rec_img - raw) * mask) / denom
        perc = perceptual(pparams, rec_img, raw)
        kl_term = jnp.mean(posterior.kl())
        g_gan = jlosses.generator_hinge_loss(jd(disc_p, rec_img, train=train_mode))
        total = recon + pw * perc + kl_scale * kl_term + gw * g_gan
        return total, ({"loss": total, "recon": recon, "perceptual": perc, "kl": kl_term,
                        "g_gan": g_gan}, rec_img)

    def disc_loss_fn(disc_p, rec_img, raw):
        return jlosses.discriminator_hinge_loss(
            jd(disc_p, raw, train=True), jd(disc_p, jax.lax.stop_gradient(rec_img), train=True))

    def eval_step(gen_p, disc_p, raw, valid, kl_scale):
        _, (metrics, rec_img) = forward_losses(gen_p, disc_p, raw, valid, None, kl_scale, False)
        return dict(metrics, d_gan=disc_loss_fn(disc_p, rec_img, raw))

    gen_grad = jax.jit(jax.value_and_grad(forward_losses, argnums=0, has_aux=True),
                       static_argnums=(6,))
    return gen_grad, jax.jit(jax.value_and_grad(disc_loss_fn)), jax.jit(eval_step)


def _jax_step(fns, gen_p, disc_p, raw, valid, noise, kl_scale, n_chunks):
    """vae_impl.py:353-409: pad, accumulate both models' gradients over the
    chunks with the valid counts as weights, average."""
    gen_grad, disc_grad, _ = fns
    chunk = max(1, -(-raw.shape[0] // n_chunks))
    pad = n_chunks * chunk - raw.shape[0]
    if pad:
        raw = jnp.concatenate([raw, jnp.take(raw, jnp.arange(pad) % raw.shape[0], axis=0)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), valid.dtype)])
    g_acc = jax.tree_util.tree_map(jnp.zeros_like, gen_p)
    d_acc = jax.tree_util.tree_map(jnp.zeros_like, disc_p)
    m_acc, count = {}, 0.0
    for i in range(n_chunks):
        rows = slice(i * chunk, (i + 1) * chunk)
        (_, (metrics, rec_img)), g = gen_grad(gen_p, disc_p, raw[rows], valid[rows],
                                              noise[rows], kl_scale, True)
        d_loss, dg = disc_grad(disc_p, rec_img, raw[rows])
        c = jnp.sum(valid[rows])
        g_acc = jax.tree_util.tree_map(lambda a, b: a + b * c, g_acc, g)
        d_acc = jax.tree_util.tree_map(lambda a, b: a + b * c, d_acc, dg)
        m_acc = {k: m_acc.get(k, 0.0) + v * c for k, v in dict(metrics, d_gan=d_loss).items()}
        count = count + c
    avg = lambda tree: jax.tree_util.tree_map(lambda a: a / jnp.maximum(count, 1.0), tree)
    return m_acc, count, avg(g_acc), avg(d_acc)


# rtol; atol as a share of the tensor's largest gradient (the perceptual and
# recon L1 terms flip a rounding-level difference's sign at their kinks) and
# of the model's (a conv bias before a BatchNorm has gradient 0 in exact
# arithmetic: all of it is rounding noise)
GRAD_TOL = (1e-3, 5e-4, 1e-5)


def _param_tol(tensor, floor, g_min, lr_sum):
    """Elementwise: 1e-5 of the tensor's largest magnitude, plus what Adam's
    normalization makes of a gradient error: an update of ±rate moves by
    about rate times the gradient's relative error, at most (floor / |g|,
    and GRAD_TOL's rtol) of each step, at most twice the summed rates, as
    where a step's gradient lies at the noise floor."""
    rel = np.minimum(1.0, floor / np.maximum(g_min, 1e-30) + GRAD_TOL[0])
    return PARAM_TOL * max(float(np.abs(tensor).max()), 1e-30) + 2 * lr_sum * rel


def _gan_pair(model_cfg, training):
    jm = _jax_kl(model_cfg)
    jd = jm.make_discriminator()
    flat = random_flat_params(jm, 10)
    dflat = disc_flat_params(jd, 11)
    tm = load_jax_params(VAEFactory().build(model_cfg, device="cpu"), flat)
    trainer = tvae.VAETrainStep(tm, training, n_chunks=2)
    load_jax_params(trainer.discriminator, dflat)
    return jm, jd, flat, dflat, tm, trainer


def test_gan_train_step_matches_jax_over_two_steps(vgg_npz, monkeypatch):
    monkeypatch.setenv("FMDM_VGG16_WEIGHTS", vgg_npz)
    training = GAN_STEP
    jm, jd, flat, dflat, tm, trainer = _gan_pair(GAN_MODEL, training)
    assert trainer.perceptual is not None and trainer.perceptual.enabled
    fns = _jax_gan_step_fns(jm, jd, training, jlosses.PerceptualLoss(resize=True))
    schedule = jvae._make_lr_schedule(training["learning_rate"], training, 2, 1)
    gen_opt = optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    disc_opt = optax.adamw(training["disc_lr"], b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    gen_p, disc_p = _jax_tree(flat), _jax_tree(dflat)
    gen_s, disc_s = gen_opt.init(gen_p), disc_opt.init(disc_p)
    assert len(jax.tree_util.tree_leaves(disc_s)) == 2 * len(dflat) + 1   # no schedule count
    rng = np.random.default_rng(12)
    lr_sum = {"gen": 0.0, "disc": 0.0}
    floors, g_min = {}, {}
    for step in range(2):
        raw = rng.uniform(0.0, 1.0, (3, 1, 16, 16)).astype(np.float32)
        valid = np.ones(3, np.float32)
        noise = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
        want_m, want_count, g, dg = _jax_step(fns, gen_p, disc_p, jnp.asarray(raw),
                                              jnp.asarray(valid), jnp.asarray(noise),
                                              jnp.float32(training["kl_weight"]), 2)
        updates, gen_s = gen_opt.update(g, gen_s, gen_p)
        gen_p = optax.apply_updates(gen_p, updates)
        d_updates, disc_s = disc_opt.update(dg, disc_s, disc_p)
        disc_p = optax.apply_updates(disc_p, d_updates)
        got_m, got_count = trainer.step(_t(raw), _t(valid), noise=_t(noise),
                                        kl_scale=training["kl_weight"], disc_active=True)
        lr_sum["gen"] += training["learning_rate"]
        lr_sum["disc"] += training["disc_lr"]
        assert float(got_count) == float(want_count) == 3.0
        assert set(got_m) == set(want_m) | {"vq"}
        for k, v in want_m.items():
            assert float(got_m[k]) == pytest.approx(float(v), rel=LOSS_TOL), (step, k)
        assert float(got_m["g_gan"]) != 0 and float(got_m["d_gan"]) > 0
        assert float(got_m["perceptual"]) > 0
        for what, module, tree, grads in (("gen", tm, gen_p, g),
                                          ("disc", trainer.discriminator, disc_p, dg)):
            want_flat, want_g = flatten_params(tree), flatten_params(grads)
            model_max = max(float(jnp.abs(v).max()) for v in want_g.values())
            for name, p in module.named_parameters():
                if not p.requires_grad:
                    continue
                wg = np.asarray(want_g[name])
                floor = max(GRAD_TOL[1] * float(np.abs(wg).max()), GRAD_TOL[2] * model_max)
                np.testing.assert_allclose(p.grad.numpy(), wg, rtol=GRAD_TOL[0], atol=floor,
                                           err_msg=f"step {step}: grad {name}")
                floors[name] = max(floors.get(name, 0.0), floor)
                g_min[name] = np.minimum(g_min.get(name, np.inf), np.abs(wg))
            for name, p in module.state_dict().items():
                w = np.asarray(want_flat[name])
                tol = (_param_tol(w, floors[name], g_min[name], lr_sum[what]) if name in floors
                       else 0.0)
                assert np.all(np.abs(p.numpy() - w) <= tol), f"step {step}: {name}"
        # the next step starts both sides from the same weights (each keeps
        # its optimizer's state), so that a noise-floor element's ±rate
        # does not shift the next step's losses
        gen_p = _jax_tree({n: v.numpy() for n, v in tm.state_dict().items()})
        disc_p = _jax_tree({n: v.numpy() for n, v in trainer.discriminator.state_dict().items()})
    # BatchNorm's running statistics never move
    for name, p in trainer.discriminator.state_dict().items():
        if "running" in name:
            assert torch.equal(p, _t(dflat[name]))
    assert trainer.global_step == 2
    # the eval step: g_gan on the running statistics, d_gan on batch statistics
    raw = rng.uniform(0.0, 1.0, (2, 1, 16, 16)).astype(np.float32)
    want = fns[2](gen_p, disc_p, jnp.asarray(raw), jnp.ones(2), jnp.float32(0.01))
    got, count = trainer.eval(_t(raw), torch.ones(2), 0.01, disc_active=True)
    for k in ("loss", "recon", "perceptual", "kl", "g_gan", "d_gan"):
        assert float(got[k]) / 2 == pytest.approx(float(want[k]), rel=LOSS_TOL), k


def _accumulated_disc_grads(trainer, raw, noise):
    trainer._accumulate(raw, torch.ones(raw.shape[0]), noise, None, 0.0, True)
    return {n: p.grad.clone() for n, p in trainer.discriminator.named_parameters()
            if p.grad is not None}


def test_no_generator_gradient_leaks_into_the_discriminator():
    training = dict(GAN_STEP, perceptual_weight=0.0)
    *_, tm, trainer = _gan_pair(GAN_MODEL, training)
    trainer.n_chunks = 1
    rng = np.random.default_rng(20)
    raw = _t(rng.uniform(0.0, 1.0, (2, 1, 16, 16)).astype(np.float32))
    noise = _t(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    got = _accumulated_disc_grads(trainer, raw, noise)
    assert set(got) == {n for n, p in trainer.discriminator.named_parameters()
                        if p.requires_grad}   # not the running statistics
    # D's loss alone, on the same reconstruction
    trainer.disc_optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        rec, _ = tm(tm.image_to_model_range(raw), noise=noise)
    d_loss = trainer.disc_loss(tm.raw_output_to_image(rec), raw)
    d_loss.backward()
    for n, p in trainer.discriminator.named_parameters():
        if p.requires_grad:
            assert torch.equal(p.grad, got[n]), n
    # and a heavier generator GAN term changes nothing of them
    trainer.gan_weight = 50.0
    for n, g in _accumulated_disc_grads(trainer, raw, noise).items():
        assert torch.equal(g, got[n]), n
    # while the generator's gradient does carry the GAN term
    assert all(p.requires_grad for p in trainer._disc_trainable)


@pytest.mark.parametrize("cfg,epoch,step,want", [
    ({"gan_start": 2}, 1, 100, False), ({"gan_start": 2}, 2, 0, True),
    ({"gan_start": 0, "gan_start_steps": 5}, 9, 4, False),
    ({"gan_start": 0, "gan_start_steps": 5}, 1, 5, True),
    ({"gan_start": 0, "gan_weight": 0.0}, 3, 3, False),
], ids=["before_epoch", "at_epoch", "before_steps", "at_steps", "no_weight"])
def test_the_gate_matches_jax(cfg, epoch, step, want):
    training = dict(GAN_STEP, perceptual_weight=0.0, **cfg)
    model = VAEFactory().build(dict(REDUCED_MODEL, resolution=16, base_ch=8,
                                    down_channels=[8, 8]), device="cpu")
    trainer = tvae.VAETrainStep(model, training)
    assert (trainer.discriminator is not None) == (training["gan_weight"] > 0)
    assert trainer.disc_is_active(epoch, step) == want == jvae._disc_is_active(
        trainer.discriminator is not None, training["gan_weight"], training["gan_start"],
        training.get("gan_start_steps"), epoch, step)


def test_a_step_with_the_gate_off_leaves_the_discriminator_alone():
    training = dict(GAN_STEP, perceptual_weight=0.0)
    *_, tm, trainer = _gan_pair(GAN_MODEL, training)
    before = {k: v.clone() for k, v in trainer.discriminator.state_dict().items()}
    gen_before = {k: v.clone() for k, v in tm.state_dict().items()}
    m, _ = trainer.step(torch.rand(3, 1, 16, 16), torch.ones(3),
                        generator=torch.Generator().manual_seed(0), disc_active=False)
    assert float(m["g_gan"]) == 0 and float(m["d_gan"]) == 0
    assert all(torch.equal(v, before[k]) for k, v in trainer.discriminator.state_dict().items())
    assert all(p.grad is None for p in trainer.discriminator.parameters())
    assert not all(torch.equal(v, gen_before[k]) for k, v in tm.state_dict().items())
    assert trainer.disc_optimizer.state == {}


def test_the_discriminator_draws_from_seed_plus_one():
    model = VAEFactory().build(dict(REDUCED_MODEL, resolution=16, base_ch=8,
                                    down_channels=[8, 8]), device="cpu")
    a = tvae.VAETrainStep(model, dict(GAN_STEP, perceptual_weight=0.0, seed=4)).discriminator
    b = tlayers.init_weights(model.make_discriminator(device="cpu"),
                             torch.Generator().manual_seed(5))
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    opt = tvae.VAETrainStep(model, dict(GAN_STEP, perceptual_weight=0.0, disc_lr=None))
    group = opt.disc_optimizer.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        GAN_STEP["learning_rate"], (0.9, 0.999), 1e-8, 0.0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

CKPT_MODEL = dict(REDUCED_MODEL, resolution=16, base_ch=8, down_channels=[8, 16],
                  num_res_blocks=1, attn_heads=2, attn_dim_head=4)


def _gan_config(tmp_path, epochs, out=None):
    from tests.test_torch_train_cli import write_ldct_root

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                      "ldm_autoencoder_kl.json").read_text())
    cfg["model"].update(CKPT_MODEL, in_channels=1, out_channels=1)
    root = tmp_path / "data"
    if not root.exists():
        write_ldct_root(root)
    cfg["training"].update(data_root=str(root), img_size=16,
                           output_dir=str(out or tmp_path / "run"),
                           epochs=epochs, batch_size=2, num_workers=0, use_tensor_cache=False,
                           visual_samples=2, gan_start=0, perceptual_weight=0.0, save_every=1,
                           seed=3)
    path = tmp_path / f"cfg{epochs}.json"
    path.write_text(json.dumps(cfg))
    return path, cfg


def _first_step_states(monkeypatch):
    """Record the discriminator and its optimizer as a run's first step sees them."""
    seen = {}
    step = tvae.VAETrainStep.step

    def recording(self, *args, **kwargs):
        if not seen:
            seen["disc"] = {k: v.clone() for k, v in self.discriminator.state_dict().items()}
            seen["opt"] = {id(p): {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                           for p, s in self.disc_optimizer.state.items()}
            seen["params"] = dict(self.discriminator.named_parameters())
            seen["active"] = kwargs.get("disc_active")
        return step(self, *args, **kwargs)

    monkeypatch.setattr(tvae.VAETrainStep, "step", recording)
    return seen


def test_the_training_loop_saves_and_resumes_the_discriminator(tmp_path, monkeypatch):
    path, cfg = _gan_config(tmp_path, 1)
    run = tvae.train(*_datasets(cfg, path), path, device="cpu")
    payload = tckpt.load_checkpoint(run / "vae_last.pt")
    head = (run / "metrics.csv").read_text().splitlines()[0].split(",")
    assert head[-2:] == ["g_gan", "d_gan"]
    saved = payload["extra_state"]["disc_params"]
    disc_opt = payload["disc_optimizer"]
    assert {int(s["step"]) for s in disc_opt["state"].values()} == {3}   # 6 slices, batch 2
    assert len(disc_opt["state"]) == 16          # 22 parameters, 6 running statistics
    path2, _ = _gan_config(tmp_path, 2, out=run)
    seen = _first_step_states(monkeypatch)
    tvae.train(*_datasets(cfg, path2), path2, resume=str(run / "vae_last.pt"), device="cpu")
    assert seen["active"] is True
    assert all(torch.equal(v, saved[k]) for k, v in seen["disc"].items())
    assert {int(s["step"]) for s in seen["opt"].values()} == {3}
    second = tckpt.load_checkpoint(run / "vae_last.pt")
    assert {int(s["step"]) for s in second["disc_optimizer"]["state"].values()} == {6}


def _datasets(cfg, path):
    from fmdm_tpu_torch.data.dataset_utils import build_train_val_datasets
    from fmdm_tpu_torch.utils.config import load_json_config

    train, _ = build_train_val_datasets(load_json_config(path))
    return (train,)


def test_a_jax_gan_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    path, cfg = _gan_config(tmp_path, 2)
    jm = _jax_kl(dict(cfg["model"]))
    jd = jm.make_discriminator()
    gen_p = _jax_tree(random_flat_params(jm, 30))
    disc_p = _jax_tree(disc_flat_params(jd, 31))
    schedule = jvae._make_lr_schedule(1e-4, cfg["training"], 2, 3)
    gen_opt = optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    disc_opt = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    rnd = lambda tree, seed: jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.random.default_rng(seed).standard_normal(a.shape), a.dtype), tree)
    gen_s = gen_opt.update(rnd(gen_p, 1), gen_opt.init(gen_p), gen_p)[1]
    disc_s = disc_opt.init(disc_p)
    for i in range(3):
        disc_s = disc_opt.update(rnd(disc_p, 2 + i), disc_s, disc_p)[1]
    n_disc = len(jax.tree_util.tree_leaves(disc_p))
    assert len(jax.tree_util.tree_leaves(disc_s)) == 2 * n_disc + 1
    ckpt = tmp_path / "jax_vae_last.pt"
    jckpt.save_checkpoint({"model": gen_p, "optimizer": gen_s, "disc_optimizer": disc_s,
                           "extra_state": {"disc_params": disc_p}, "scheduler": {"last_epoch": 1},
                           "scaler": None, "epoch": 1, "best_metric": 1.0}, ckpt)
    seen = _first_step_states(monkeypatch)
    tvae.train(*_datasets(cfg, path), path, resume=str(ckpt), device="cpu")
    want = flatten_params(disc_p)
    assert list(seen["disc"]) == list(want)
    for k, v in seen["disc"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)
    mu = flatten_params(disc_s[0].mu)
    nu = flatten_params(disc_s[0].nu)
    for name, p in seen["params"].items():
        state = seen["opt"][id(p)]
        assert int(state["step"]) == 3
        np.testing.assert_array_equal(state["exp_avg"].numpy(), np.asarray(mu[name]), err_msg=name)
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(), np.asarray(nu[name]),
                                      err_msg=name)


def test_the_disc_optimizer_reader_refuses_a_wrong_leaf_count():
    disc = tvae_modules.PatchDiscriminator(base_channels=8, device="cpu")
    opt = torch.optim.AdamW(disc.parameters())
    n = len(list(disc.parameters()))
    entry = {f"leaf_{i}": np.zeros(()) for i in range(2 * n)}
    entry["__treedef__"] = np.zeros(1, np.uint8)
    with pytest.raises(ValueError, match=f"{2 * n + 1} at a constant rate"):
        tckpt.load_optimizer_state(opt, entry, disc, constant_rate=True)
    entry = {f"leaf_{i}": np.zeros(()) for i in range(2 * n + 1)}
    entry["__treedef__"] = np.zeros(1, np.uint8)
    with pytest.raises(ValueError, match=f"{2 * n + 2} with a schedule"):
        tckpt.load_optimizer_state(opt, entry, disc)
