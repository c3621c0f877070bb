"""The port's VQ-VAE and the VAE train step's new recipes against the JAX
package's, on the CPU in f32.

- Both quantizers on the same codebook and input, in 1, 2 and 3 D: the
  codes bitwise, the quantized values, losses and perplexity within 1e-6,
  the EMA update within 1e-6 of its largest value, and the classic
  quantizer's gradients.
- The nine ``vq`` configs build with the JAX tree's names and shapes, the
  EMA codebook's three buffers included; ``load_jax_params`` carries them.
- The train step of ``VQVAE`` (EMA and classic; :func:`check_train_step`,
  which ``tests/test_torch_vae_losses.py`` also runs for the KL model's
  bce_focal and perceptual recipes), at batch 3 in 2 chunks (one
  wrap-padded row): against
  the JAX closure of ``fmdm_tpu/train/vae_impl.py`` (:297-342 losses,
  :353-408 the step, ``_split_ema``/``_merge_ema`` threading the EMA
  state), with the posterior noise given to both. Held as
  ``tests/test_torch_vae.py`` holds the KL step: metrics within 1e-5, the
  averaged gradients within 1e-3 relative and 1e-4 of their largest, the
  update against ``optax.adamw`` on the port's own gradients; the EMA
  buffers after the step within 1e-5 of their largest (the encoder's f32
  rounding enters the per-code sums).
- The VQ run loop: one epoch and a second in both packages from JAX's
  initial weights, then both resuming JAX's epoch-1 snapshot, whose
  ``optax.adamw`` state covers the trainable tree without the EMA buffers.
"""

import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fmdm_tpu.models.factories import VAEFactory as JaxVAEFactory
from fmdm_tpu.models.vae import VQVAE as JaxVQVAE
from fmdm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from fmdm_tpu.nn import losses as jlosses
from fmdm_tpu.nn import vae_modules as jvae_modules
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.train import vae_impl as jvae
from fmdm_tpu_torch.models.factories import VAEFactory
from fmdm_tpu_torch.models.vae import VQVAE
from fmdm_tpu_torch.nn import vae_modules as tvae_modules
from fmdm_tpu_torch.nn.layers import init_weights
from fmdm_tpu_torch.train import vae_impl as tvae
from fmdm_tpu_torch.utils import checkpoint as tckpt
from fmdm_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_train_loop import (assert_runs_match, read_metrics, run_files, tiny,
                                         truncate_to_epoch, write_cfg)
from tests.test_torch_train_vae_loop import share_initial_weights
from tests.test_torch_vae import random_flat_params

REPO = Path(__file__).resolve().parents[1]
VQ_CONFIGS = sorted(REPO.glob("configs/**/*vq*.json"))
# LDCT_vqvae.json's topology cut to 2 stages at 16² and a codebook of 32;
# widths of 64, so every GroupNorm group holds 2 channels (one-channel
# groups zero the preceding biases' gradients: rounding noise, on both sides)
VQ_MODEL = {"in_channels": 1, "out_channels": 1, "resolution": 16, "base_ch": 64,
            "down_channels": [64, 64], "num_res_blocks": 1, "attn_resolutions": [],
            "z_channels": 16, "embed_dim": 16, "dropout": 0.0, "use_attention": False,
            "spatial_dims": 2, "latent_type": "vq", "model_type": "vae", "codebook_size": 32,
            "vq_beta": 0.25, "vq_ema_decay": 0.99, "vq_ema_eps": 1e-5, "quantizer_type": "ema"}
STEP = {"learning_rate": 1e-3, "weight_decay": 0.01, "epochs": 2, "kl_weight": 1e-2,
        "codebook_weight": 1.0, "recon_type": "l1"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_model(model_cfg):
    """The JAX model of a config's model section (its factory reads a file)."""
    kw = {k: v for k, v in model_cfg.items() if k not in ("latent_type", "model_type")}
    return (JaxVQVAE if model_cfg["latent_type"] == "vq" else JaxAutoencoderKL)(**kw)


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------

def _codebook_state(k, d, seed):
    rng = np.random.default_rng(seed)
    return {"embedding": rng.standard_normal((k, d)).astype(np.float32),
            "ema_cluster_size": rng.uniform(0.0, 3.0, k).astype(np.float32),
            "ema_w": rng.standard_normal((k, d)).astype(np.float32)}


@pytest.mark.parametrize("shape", [(3, 8, 5, 6), (2, 8, 7), (2, 8, 3, 4, 5)],
                         ids=["2d", "1d", "3d"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ema_quantizer_matches_jax(shape, train):
    state = _codebook_state(48, 8, 1)
    z = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jq = jvae_modules.VectorQuantizerEMA(48, 8)
    want = jq({k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(z), train=train)
    tq = tvae_modules.VectorQuantizerEMA(48, 8, device="cpu")
    tq.load_state_dict({k: _t(v) for k, v in state.items()})
    got = tq(_t(z), train=train)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert got.codes.shape == (shape[0],) + shape[2:]
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(want.quantized), rtol=1e-6,
                               atol=1e-6)
    for a, b in ((got.vq_loss, want.vq_loss), (got.perplexity, want.perplexity)):
        assert float(a) == pytest.approx(float(b), rel=1e-6)
    if not train:
        assert got.new_state is None and want.new_state is None
        return
    assert got.new_state.keys() == want.new_state.keys()
    for k, v in want.new_state.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got.new_state[k].numpy(), v, rtol=0,
                                   atol=1e-6 * float(np.abs(v).max()), err_msg=k)
    # returned, not applied
    assert all(torch.equal(getattr(tq, k), _t(v)) for k, v in state.items())


def test_ema_quantizer_does_not_update_at_decay_zero():
    tq = tvae_modules.VectorQuantizerEMA(16, 4, decay=0.0, device="cpu")
    assert tq(torch.randn(2, 4, 3, 3), train=True).new_state is None


@pytest.mark.parametrize("shape", [(3, 8, 5, 6), (2, 8, 3, 4, 5)], ids=["2d", "3d"])
def test_classic_quantizer_and_its_gradients_match_jax(shape):
    """The loss is vq_loss plus a random weighting of the straight-through
    output: the gradient reaches z through both, and the codebook through
    the codebook loss."""
    emb = _codebook_state(40, 8, 3)["embedding"]
    rng = np.random.default_rng(4)
    z = rng.standard_normal(shape).astype(np.float32)
    weight = rng.standard_normal(shape).astype(np.float32)
    jq = jvae_modules.VectorQuantizer(40, 8)

    def jloss(params, zz):
        out = jq(params, zz)
        return out.vq_loss + jnp.sum(out.quantized * weight), out

    (want_loss, want), (want_ge, want_gz) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                               has_aux=True)(
        {"embedding": jnp.asarray(emb)}, jnp.asarray(z))
    tq = tvae_modules.VectorQuantizer(40, 8, device="cpu")
    tq.load_state_dict({"embedding": _t(emb)})
    zt = _t(z).requires_grad_(True)
    got = tq(zt)
    (got.vq_loss + torch.sum(got.quantized * _t(weight))).backward()
    got = got._replace(vq_loss=got.vq_loss.detach(), perplexity=got.perplexity.detach())
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert got.new_state is None
    assert float(got.vq_loss) == pytest.approx(float(want.vq_loss), rel=1e-6)
    assert float(got.perplexity) == pytest.approx(float(want.perplexity), rel=1e-6)
    np.testing.assert_allclose(got.quantized.detach().numpy(), np.asarray(want.quantized),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want_gz), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tq.embedding.grad.numpy(), np.asarray(want_ge["embedding"]),
                               rtol=1e-5, atol=1e-7)


def test_nearest_codes_take_the_first_of_tied_minima():
    emb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    z = torch.tensor([[0.5, 0.5], [2.0, 0.0]])
    assert tvae_modules._nearest_codes(z, emb).tolist() == [0, 0]
    assert np.asarray(jvae_modules._nearest_codes(jnp.asarray(z.numpy()),
                                                  jnp.asarray(emb.numpy()))[0]).tolist() == [0, 0]


# ---------------------------------------------------------------------------
# the model and its weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", VQ_CONFIGS, ids=lambda p: str(p.relative_to(REPO / "configs")))
def test_vq_configs_state_dict_equals_jax(path):
    jm = JaxVAEFactory().build_from_json(path)
    shapes = {k: tuple(v.shape) for k, v in
              flatten_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0))).items()}
    tm = VAEFactory().build_from_json(path, device="meta")
    assert isinstance(tm, VQVAE)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == shapes
    cfg = json.loads(path.read_text())["model"]
    trainable = {k for k, _ in tm.named_parameters()}
    buffers = {"codebook.embedding", "codebook.ema_cluster_size", "codebook.ema_w"}
    if cfg["quantizer_type"] == "ema":
        assert trainable == set(shapes) - buffers
    else:
        assert trainable == set(shapes) and "codebook.embedding" in trainable
    # the GAN step is ported: the config's discriminator has JAX's names and shapes
    disc = tm.make_discriminator(device="meta")
    assert type(disc).__name__ == type(jm.make_discriminator()).__name__
    assert {k: tuple(v.shape) for k, v in disc.state_dict().items()} == {
        k: tuple(v.shape) for k, v in flatten_params(jax.eval_shape(
            jm.make_discriminator().init, jax.random.PRNGKey(0))).items()}


def test_vq_weights_carry_over_with_the_codebook_buffers():
    """load_jax_params takes the EMA buffers; encode, the forward and decode
    then match JAX; init_weights starts ema_w as a copy of the codebook,
    as JAX's init does."""
    jm = _jax_model(VQ_MODEL)
    flat = random_flat_params(jm, 5)
    flat["codebook.ema_cluster_size"] = np.abs(flat["codebook.ema_cluster_size"])
    tm = load_jax_params(VAEFactory().build(VQ_MODEL, device="cpu"), flat)
    for k in ("codebook.embedding", "codebook.ema_cluster_size", "codebook.ema_w"):
        assert torch.equal(tm.state_dict()[k], _t(flat[k]))
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    x = np.random.default_rng(6).uniform(-1, 1, (2, 1, 16, 16)).astype(np.float32)
    want_rec, want_aux, want_enc = jax.jit(
        lambda p, v: (*jm(p, v), jm.encode(p, v, normalize=True)))(params, jnp.asarray(x))
    with torch.no_grad():
        rec, aux = tm(_t(x))
        enc = tm.encode(_t(x), normalize=True)
    np.testing.assert_array_equal(aux["codes"].numpy(), np.asarray(want_aux["codes"]))
    assert aux["ema_update"] is None and want_aux["ema_update"] is None
    np.testing.assert_allclose(rec.numpy(), np.asarray(want_rec), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), rtol=1e-4, atol=1e-5)
    fresh = init_weights(VAEFactory().build(VQ_MODEL, device="cpu"), torch.Generator().manual_seed(0))
    jparams = jm.init(jax.random.PRNGKey(0))["codebook"]
    assert torch.equal(fresh.codebook.ema_w, fresh.codebook.embedding)
    assert float(fresh.codebook.ema_cluster_size.abs().sum()) == 0.0
    assert bool(jnp.all(jparams["ema_w"] == jparams["embedding"]))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_gen_grad(jm, training, perceptual=None):
    """``jax.value_and_grad`` of vae_impl.py:297-342's ``forward_losses``
    for ``training`` (no GAN), the KL posterior sampled from the given
    noise; returns (value_and_grad, is_ema)."""
    recon_type = training["recon_type"]
    is_vq = hasattr(jm, "codebook")
    pw = float(training.get("perceptual_weight", 0.0))
    cw = float(training.get("codebook_weight", 1.0)) if is_vq else 0.0
    pparams = perceptual.load_params() if perceptual is not None else None

    def recon_loss_fn(rec, rec_img, raw, valid):
        mask = valid.reshape((-1,) + (1,) * (raw.ndim - 1))
        denom = jnp.maximum(jnp.sum(valid), 1.0) * math.prod(raw.shape[1:])
        if recon_type == "l1":
            return jnp.sum(jnp.abs(rec_img - raw) * mask) / denom
        if recon_type == "bce":
            bce = jnp.maximum(rec, 0) - rec * raw + jnp.log1p(jnp.exp(-jnp.abs(rec)))
            return jnp.sum(bce * mask) / denom
        per = jlosses.bce_focal_loss(rec, raw, alpha=0.25, gamma=2.0, reduction="none")
        return jnp.sum(per * mask) / denom

    def forward_losses(gen_p, ema_s, raw, valid, noise, kl_scale):
        merged = jvae._merge_ema(gen_p, ema_s)
        inputs = jm.image_to_model_range(raw)
        new_ema = None
        if is_vq:
            rec, aux = jm(merged, inputs, train=True)
            vq_loss, kl_term, new_ema = aux["vq_loss"], jnp.zeros((), jnp.float32), aux["ema_update"]
        else:
            posterior = jm.encode(merged, inputs)
            rec = jm.decode(merged, posterior.mu + posterior.std * noise)
            vq_loss, kl_term = jnp.zeros((), jnp.float32), jnp.mean(posterior.kl())
        rec_img = jm.raw_output_to_image(rec, recon_type=recon_type)
        recon = recon_loss_fn(rec, rec_img, raw, valid)
        perc = (perceptual(pparams, rec_img, raw) if perceptual is not None
                else jnp.zeros((), jnp.float32))
        total = recon + pw * perc + kl_scale * kl_term + cw * vq_loss
        return total, ({"loss": total, "recon": recon, "perceptual": perc, "kl": kl_term,
                        "vq": vq_loss}, new_ema)

    return (jax.jit(jax.value_and_grad(forward_losses, argnums=0, has_aux=True)),
            is_vq and jm.quantizer_type == "ema")


def _jax_step(gen_grad, gen_p, ema_s, raw, valid, noise, kl_scale, n_chunks):
    """vae_impl.py:353-401: pad, run the chunks threading the EMA state,
    average: (metrics sums, count, averaged gradients, EMA state after)."""
    chunk = max(1, -(-raw.shape[0] // n_chunks))
    pad = n_chunks * chunk - raw.shape[0]
    if pad:
        wrap = jnp.arange(pad) % raw.shape[0]
        raw = jnp.concatenate([raw, jnp.take(raw, wrap, axis=0)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), valid.dtype)])
    g_acc = jax.tree_util.tree_map(lambda p: jnp.zeros_like(p, jnp.float32), gen_p)
    m_acc, count = {}, jnp.float32(0.0)
    for i in range(n_chunks):
        rows = slice(i * chunk, (i + 1) * chunk)
        (_, (metrics, new_ema)), grads = gen_grad(gen_p, ema_s, raw[rows], valid[rows],
                                                  noise[rows], kl_scale)
        c = jnp.sum(valid[rows])
        g_acc = jax.tree_util.tree_map(lambda a, g: a + g * c, g_acc, grads)
        m_acc = {k: m_acc.get(k, 0.0) + v * c for k, v in metrics.items()}
        count = count + c
        if new_ema is not None:
            ema_s = new_ema
    return m_acc, count, jax.tree_util.tree_map(lambda g: g / jnp.maximum(count, 1.0), g_acc), ema_s


def check_train_step(model_cfg, training, perceptual=None):
    """One port step against JAX's on the same weights, batch, noise and KL
    scale; ``perceptual`` is JAX's loss when the term is on."""
    jm = _jax_model(model_cfg)
    flat = random_flat_params(jm, 10)
    if "codebook.ema_cluster_size" in flat:
        flat["codebook.ema_cluster_size"] = np.abs(flat["codebook.ema_cluster_size"])
    tm = load_jax_params(VAEFactory().build(model_cfg, device="cpu"), flat)
    trainer = tvae.VAETrainStep(tm, training, n_chunks=2)
    assert tvae.KLTrainStep is tvae.VAETrainStep
    gen_grad, is_ema = _jax_gen_grad(jm, training, perceptual)
    side = model_cfg["resolution"]
    rng = np.random.default_rng(11)
    raw = rng.uniform(0.0, 1.0, (3, 1, side, side)).astype(np.float32)
    valid = np.ones(3, np.float32)
    latent = (model_cfg["embed_dim"], side // 2 ** (len(model_cfg["down_channels"]) - 1))
    noise = rng.standard_normal((4, latent[0], latent[1], latent[1])).astype(np.float32)

    before = {n: jnp.asarray(t.detach().numpy().copy()) for n, t in tm.state_dict().items()}
    gen_p, ema_s = jvae._split_ema(unflatten_params(before), is_ema)
    want_m, want_count, want_g, want_ema = _jax_step(
        gen_grad, gen_p, ema_s, jnp.asarray(raw), jnp.asarray(valid), jnp.asarray(noise),
        jnp.float32(training["kl_weight"]), n_chunks=2)
    got_m, got_count = trainer.step(_t(raw), _t(valid), noise=_t(noise),
                                    kl_scale=training["kl_weight"])
    assert float(got_count) == float(want_count) == 3.0
    for k, v in want_m.items():
        assert float(got_m[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-12), k
    if perceptual is not None:
        assert float(got_m["perceptual"]) > 0
        # the VGG is the loss's: in neither the model's state dict nor AdamW
        assert not any("features" in k for k in tm.state_dict())
        assert {id(p) for g in trainer.optimizer.param_groups for p in g["params"]} == {
            id(p) for p in tm.parameters()}
    grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    want_flat = flatten_params(want_g)
    assert grads.keys() == want_flat.keys()
    for name, g in want_flat.items():
        g = np.asarray(g)
        np.testing.assert_allclose(grads[name], g, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-8, err_msg=name)
    if is_ema:
        for k, v in want_ema.items():
            v = np.asarray(v)
            np.testing.assert_allclose(getattr(tm.codebook, k).numpy(), v, rtol=0,
                                       atol=1e-5 * float(np.abs(v).max()), err_msg=k)
    schedule = jvae._make_lr_schedule(training["learning_rate"], training, 2, 1)
    optimizer = optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8,
                            weight_decay=training["weight_decay"])
    g_tree = unflatten_params({n: jnp.asarray(g) for n, g in grads.items()})
    g_tree.update({k: {} for k in gen_p if k not in g_tree})   # an EMA split's empty codebook
    updates, _ = optimizer.update(g_tree, optimizer.init(gen_p), gen_p)
    want_p = flatten_params(optax.apply_updates(gen_p, updates))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_p[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("quantizer", ["ema", "classic"])
def test_vq_train_step_matches_jax(quantizer):
    check_train_step(dict(VQ_MODEL, quantizer_type=quantizer), STEP)


def test_trial_restores_the_ema_codebook():
    model = init_weights(VAEFactory().build(VQ_MODEL, device="cpu"), torch.Generator().manual_seed(2))
    trainer = tvae.VAETrainStep(model, STEP)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.trial(torch.rand(3, 1, 16, 16), torch.ones(3), torch.Generator().manual_seed(0))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    trainer.step(torch.rand(3, 1, 16, 16), torch.ones(3))
    assert not torch.equal(model.codebook.embedding, before["codebook.embedding"])
    assert torch.equal(model.codebook.ema_cluster_size, model.codebook.ema_cluster_size)


def test_eval_step_leaves_the_codebook_alone():
    model = init_weights(VAEFactory().build(VQ_MODEL, device="cpu"), torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sums, count = tvae.VAETrainStep(model, STEP).eval(torch.rand(2, 1, 16, 16), torch.ones(2))
    assert float(count) == 2 and float(sums["vq"]) > 0 and float(sums["kl"]) == 0
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


# ---------------------------------------------------------------------------
# the run loop
# ---------------------------------------------------------------------------

LR = 1e-4


def loop_cfg(tmp: Path, **training) -> dict:
    return {"training": {"output_dir": str(tmp / "ckpt"), "epochs": 2, "batch_size": 4,
                         "learning_rate": LR, "weight_decay": 0.01, "reg_type": "vq",
                         "recon_type": "l1", "codebook_weight": 1.0, "save_every": 1, "seed": 4,
                         "img_size": 16, "save_images": True, "visual_samples": 4,
                         "num_workers": 0, "gradient_accumulation_steps": 2, **training},
            "model": dict(VQ_MODEL)}


def _train_both(tmp: Path, cfg: dict, *, resume=None):
    runs = {}
    for pkg, lib in (("jax", jvae), ("port", tvae)):
        pkg_cfg = copy.deepcopy(cfg)
        if resume is None:
            pkg_cfg["training"]["output_dir"] = str(tmp / f"{pkg}_ckpt")
        else:
            pkg_cfg["training"]["output_dir"] = str(
                truncate_to_epoch(resume[0], tmp / f"{pkg}_resumed", 1))
        runs[pkg] = lib.train(tiny(pkg, tmp / "data"), write_cfg(tmp / f"{pkg}.json", pkg_cfg),
                              val_dataset=tiny(pkg, tmp / "data", train=False, n=6),
                              resume=None if resume is None else str(resume[1]),
                              **({"device": "cpu"} if pkg == "port" else {}))
    return runs["jax"], runs["port"]


def constant_rate(_step):
    return LR


@pytest.fixture(scope="module")
def vq_runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("vq_loop")
    cfg = loop_cfg(tmp)
    try:
        with pytest.MonkeyPatch.context() as mp:
            share_initial_weights(mp)
            jax_run, port_run = _train_both(tmp, cfg)
    finally:
        torch.set_num_threads(threads)
    return {"tmp": tmp, "cfg": cfg, "jax": jax_run, "port": port_run}


def test_vq_train_matches_jax(vq_runs):
    """10 digits at batch 4 in 2 chunks (a last batch of 2 wrap-padded to
    the chunks' rows), two epochs, validation on 6 others."""
    jax_run, port_run = vq_runs["jax"], vq_runs["port"]
    assert_runs_match(jax_run, port_run, "vae_last.pt", constant_rate)
    head, rows = read_metrics(port_run)
    assert head == "epoch,loss,recon,vq" and [r[0] for r in rows] == [1, 2]
    assert {"vae_best.pt", "epochs/epoch0002/epoch.pt", "epochs/epoch0001/gen.png"} <= set(
        run_files(port_run))
    payload = tckpt.load_checkpoint(port_run / "vae_last.pt")
    assert int(payload["optimizer"]["state"][0]["step"]) == 6
    assert {"codebook.embedding", "codebook.ema_w", "codebook.ema_cluster_size"} <= set(
        payload["model"])
    # the codebook moved with the data: counts summed over two epochs
    assert float(payload["model"]["codebook.ema_cluster_size"].sum()) > 0


def test_vq_resume_of_a_jax_run_matches_jax(vq_runs):
    tmp = vq_runs["tmp"] / "resume"
    snapshot = vq_runs["jax"] / "epochs" / "epoch0001" / "epoch.pt"
    jax_run, port_run = _train_both(tmp, vq_runs["cfg"], resume=(vq_runs["jax"], snapshot))
    assert_runs_match(jax_run, port_run, "vae_last.pt", constant_rate)
    assert int(tckpt.load_checkpoint(port_run / "vae_last.pt")["optimizer"]["state"][0]["step"]) == 6
