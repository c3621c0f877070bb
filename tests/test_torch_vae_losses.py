"""The port's VAE losses and their resampling ops against the JAX package's,
on the CPU in f32: ``resize_bilinear`` (downsampling, where JAX
antialiases, and upsampling, in 1, 2 and 3 D), ``max_pool_nd``, the bce /
focal / bce-focal losses, the hinge losses, ``vq_regularizer``, and the
VGG16 perceptual loss on a surrogate ``.npz`` of random weights (the
pretrained file is not in the repository), with its gate off giving 0.

Tolerances: elementwise f32 arithmetic within 1e-6; the hinge losses and
``vq_regularizer``, means of terms of both signs (or of near-cancelling
squares) summed in another order, within 1e-5; the resize's contractions in
another order within 1e-6 on images in [0, 1]; the VGG's convolutions
within 1e-5 relative.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from fmdm_tpu.nn import losses as jlosses
from fmdm_tpu.ops import resample as jresample
from fmdm_tpu_torch.nn import losses as tlosses
from fmdm_tpu_torch.ops import resample as tresample
from fmdm_tpu_torch.train.vae_impl import VAETrainStep
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_vae import REDUCED_MODEL
from tests.test_torch_vqvae import STEP, check_train_step

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,size", [
    ((2, 3, 256, 256), (224, 224)),      # the perceptual loss's resize: antialiased
    ((2, 3, 32, 32), (224, 224)),        # upsampling
    ((2, 3, 33), (20,)), ((2, 3, 33), (70,)),
    ((1, 2, 9, 10, 11), (5, 13, 4)), ((1, 2, 9, 10, 11), (19, 20, 23)),
], ids=["2d-down-224", "2d-up-224", "1d-down", "1d-up", "3d-mixed", "3d-up"])
def test_resize_bilinear_matches_jax(shape, size):
    x = np.random.default_rng(len(shape) + size[0]).uniform(0.0, 1.0, shape).astype(np.float32)
    want = np.asarray(jresample.resize_bilinear(jnp.asarray(x), size))
    got = tresample.resize_bilinear(_t(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resize_without_antialias_would_not_match():
    """Why the port does not call F.interpolate: without antialiasing its
    downsampling is another filter, far outside the tolerance."""
    x = np.random.default_rng(0).uniform(0.0, 1.0, (1, 1, 256, 256)).astype(np.float32)
    want = np.asarray(jresample.resize_bilinear(jnp.asarray(x), (224, 224)))
    plain = F.interpolate(_t(x), size=(224, 224), mode="bilinear", align_corners=False)
    assert float(np.abs(plain.numpy() - want).max()) > 0.05


@pytest.mark.parametrize("shape,kernel,stride,padding", [
    ((2, 3, 8, 8), 2, None, 0), ((2, 3, 9, 9), 3, 2, 1), ((2, 3, 10), 2, None, 0),
    ((1, 2, 4, 6, 8), 2, 2, 0), ((1, 2, 5, 6, 7), 3, 1, 1), ((2, 3, 7, 9), (2, 3), (1, 2), (1, 0)),
])
def test_max_pool_nd_matches_jax(shape, kernel, stride, padding):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(jresample.max_pool_nd(jnp.asarray(x), kernel, stride, padding))
    got = tresample.max_pool_nd(_t(x), kernel, stride, padding).numpy()
    np.testing.assert_array_equal(got, want)


def _logits_and_targets(seed=4):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((2, 1, 6, 6))).astype(np.float32)
    return logits, rng.uniform(0.0, 1.0, logits.shape).astype(np.float32)


@pytest.mark.parametrize("name", ["focal_loss", "bce_focal_loss"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_focal_losses_and_gradients_match_jax(name, reduction):
    logits, targets = _logits_and_targets()
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    want = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(targets), reduction=reduction))
    x = _t(logits).requires_grad_(True)
    got = tfn(x, _t(targets), reduction=reduction)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    got.sum().backward()
    want_g = jax.grad(lambda z: jnp.sum(jfn(z, jnp.asarray(targets), reduction=reduction)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)


def test_bce_hinge_and_vq_regularizer_match_jax():
    logits, targets = _logits_and_targets(5)
    np.testing.assert_allclose(
        tlosses._bce_with_logits(_t(logits), _t(targets)).numpy(),
        np.asarray(jlosses._bce_with_logits(jnp.asarray(logits), jnp.asarray(targets))),
        rtol=1e-6, atol=1e-7)
    real, fake = logits[0], logits[1]
    pairs = ((tlosses.discriminator_hinge_loss(_t(real), _t(fake)),
              jlosses.discriminator_hinge_loss(jnp.asarray(real), jnp.asarray(fake))),
             (tlosses.generator_hinge_loss(_t(fake)), jlosses.generator_hinge_loss(jnp.asarray(fake))))
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    for latents_shape in ((3, 4, 5, 5), (2, 3, 7), (2, 2, 3, 4, 5)):
        z = np.random.default_rng(6).standard_normal(latents_shape).astype(np.float32) + 0.3
        assert float(tlosses.vq_regularizer(_t(z))) == pytest.approx(
            float(jlosses.vq_regularizer(jnp.asarray(z))), rel=1e-5)


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg16_surrogate.npz"
    return tlosses.write_surrogate_vgg16(path, seed=7)


def test_surrogate_weights_have_torchvision_names(vgg_npz):
    keys = set(np.load(vgg_npz).files)
    convs = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    assert keys == {f"features.{i}.{k}" for i in convs for k in ("weight", "bias")}
    assert np.load(vgg_npz)["features.28.weight"].shape == (512, 512, 3, 3)


@pytest.mark.parametrize("channels", [1, 3], ids=["grey-tiled", "rgb"])
def test_perceptual_loss_and_gradient_match_jax(vgg_npz, channels):
    """resize=False at 16² (the pools take it to 2² by layer 22): the loss
    and its gradient in the reconstruction."""
    rng = np.random.default_rng(8 + channels)
    recon, target = (rng.uniform(0.0, 1.0, (2, channels, 16, 16)).astype(np.float32)
                     for _ in range(2))
    jp = jlosses.PerceptualLoss(resize=False, weights_path=vgg_npz)
    params = jp.load_params()
    want, want_g = jax.value_and_grad(lambda r: jp(params, r, jnp.asarray(target)))(
        jnp.asarray(recon))
    tp = tlosses.PerceptualLoss(resize=False, weights_path=vgg_npz, device="cpu")
    x = _t(recon).requires_grad_(True)
    got = tp(x, _t(target))
    got.backward()
    assert float(got.detach()) > 0
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-5 * float(np.abs(np.asarray(want_g)).max()))
    # frozen, and only the convs up to layer 22 are built
    assert not any(p.requires_grad for p in tp.parameters())
    assert len(tp.features) == 23 and "21.weight" in tp.features.state_dict()


def test_perceptual_gate_off_gives_zero_and_the_trainer_warns(monkeypatch, tmp_path, caplog):
    monkeypatch.delenv("FMDM_VGG16_WEIGHTS", raising=False)
    tp = tlosses.PerceptualLoss(resize=True, device="cpu")
    jp = jlosses.PerceptualLoss(resize=True)
    x = torch.rand(1, 1, 8, 8)
    assert not tp.enabled and not jp.enabled and tp.features is None
    assert float(tp(x, x + 1)) == float(jp(jp.load_params(), jnp.asarray(x.numpy()),
                                           jnp.asarray(x.numpy() + 1))) == 0.0
    monkeypatch.setenv("FMDM_VGG16_WEIGHTS", str(tmp_path / "absent.npz"))
    assert not tlosses.PerceptualLoss(device="cpu").enabled
    with caplog.at_level(logging.WARNING):
        VAETrainStep(torch.nn.Conv2d(1, 1, 1), {"perceptual_weight": 0.1})
    assert "PerceptualLoss disabled" in caplog.text


# the KL-VAE's topology at 16² in two stages of 64 channels: norm_out's
# groups hold 2 channels (a one-channel group zeroes the last convs' bias
# gradients, leaving rounding noise on both sides)
KL_STEP_MODEL = dict(REDUCED_MODEL, resolution=16, base_ch=64, down_channels=[64, 64],
                     attn_heads=2, attn_dim_head=8)


@pytest.mark.parametrize("recipe", [{"recon_type": "bce_focal"}, {"recon_type": "bce"},
                                    {"perceptual_weight": 0.5}],
                         ids=["bce_focal", "bce", "perceptual"])
def test_kl_train_step_matches_jax(recipe, vgg_npz, monkeypatch):
    perceptual = None
    if recipe.get("perceptual_weight"):
        monkeypatch.setenv("FMDM_VGG16_WEIGHTS", vgg_npz)
        perceptual = jlosses.PerceptualLoss(resize=True)
    check_train_step(KL_STEP_MODEL, dict(STEP, **recipe), perceptual)


# every recipe the training CLI refused before: each config's model cut to
# two stages at 16², 1 epoch over a synthetic LDCT root of 6 slices
CLI_RECIPES = {
    "MNIST/mnist_autoencoder_kl_mini.json": {},                 # bce
    "LDCT/LDCT_autoencoder_kl_bce_focal.json": {},
    "LDCT/LDCT_fmboost_autoencoder_kl.json": {},                # perceptual
    "LDCT/LDCT_vqvae.json": {"codebook_size": 32},              # VQ, EMA codebook
    "LDCT/LDCT_vqvae_original.json": {"codebook_size": 32},     # VQ, classic
}


@pytest.mark.parametrize("name", list(CLI_RECIPES))
def test_cli_trains_the_ported_recipes_on_the_cpu(name, vgg_npz, tmp_path, monkeypatch):
    from fmdm_tpu_torch.train import __main__ as tmain
    from tests.test_torch_train_cli import write_ldct_root

    monkeypatch.setenv("FMDM_VGG16_WEIGHTS", vgg_npz)
    cfg = json.loads((REPO / "configs" / name).read_text())
    cfg["model"].update(resolution=16, base_ch=8, down_channels=[8, 16], num_res_blocks=1,
                        z_channels=4, embed_dim=4, attn_heads=2, attn_dim_head=4,
                        **CLI_RECIPES[name])
    cfg["training"].pop("dataset", None)
    cfg["training"].update(data_root=str(write_ldct_root(tmp_path / "data")), img_size=16,
                           output_dir=str(tmp_path / "run"), epochs=1, batch_size=4,
                           num_workers=0, use_tensor_cache=False, visual_samples=2)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    tmain.main(["--config", str(path), "--device", "cpu"])
    run = tmp_path / "run_run1"
    assert {"vae_last.pt", "vae_best.pt", "epochs/epoch0001/recon.png"} <= {
        str(p.relative_to(run)) for p in run.rglob("*") if p.is_file()}
    head, row = (run / "metrics.csv").read_text().splitlines()
    training = cfg["training"]
    assert head.split(",")[-1] == ("perceptual" if training["perceptual_weight"] > 0 else "vq")
    assert all(np.isfinite(float(v)) for v in row.split(",")[1:])
    if training["perceptual_weight"] > 0:
        assert float(row.split(",")[-1]) > 0
