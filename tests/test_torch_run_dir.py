"""The port's run-dir path against the JAX package's: checkpoints written by
either package load into the other's ``build_diffusion_model`` (``model``
and ``ema``), run configs (``train_config.json`` and the legacy diffusers
layout), checkpoint resolution, the legacy key remap, ``decode_diffusion_batch``
with a scheduler override, ``start_step``, ``last_n_steps`` and
``init_from_reference`` (JAX's noise replayed into the port), and the port's
PSNR and SSIM against the JAX package's goldens.

The UNet is the flagship's LDCT config cut to two levels of 16 and 32
channels at 16² (one attention level), f32. A forward is a few dozen f32
layers whose sums run in another order: held at 1e-5 relative to the
output's largest value. A decode chains 3-5 of them through a scheduler:
held at 1e-4 relative to the sample's largest value.
"""

import copy
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import tests.test_ssim_goldens as ssim_goldens
from fmdm_tpu.nn.module import flatten_params as jax_flatten, unflatten_params as jax_unflatten
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.sample import sampling_utils as jsu
from fmdm_tpu.utils import checkpoint as jckpt
from fmdm_tpu_torch.nn.layers import init_weights
from fmdm_tpu_torch.sample import diffusion_utils as tdu
from fmdm_tpu_torch.sample import sampling_utils as tsu
from fmdm_tpu_torch.utils import checkpoint as tckpt
from fmdm_tpu_torch.utils import evaluation as tev
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_models import random_flat_params

REPO = Path(__file__).resolve().parents[1]
LDCT = json.loads((REPO / "configs" / "LDCT" / "LDCT_ddpm_diffusers_nd.json").read_text())
SMALL_UNET = dict(LDCT["model"]["unet"], sample_size=16, layers_per_block=1, norm_num_groups=8,
                  block_out_channels=[16, 32], down_block_types=["DownBlock2D", "AttnDownBlock2D"],
                  up_block_types=["AttnUpBlock2D", "UpBlock2D"])
SHAPE = (2, 1, 16, 16)
FORWARD_TOL = 1e-5
DECODE_TOL = 1e-4


def _cfg():
    cfg = copy.deepcopy(LDCT)
    cfg["model"]["unet"] = dict(SMALL_UNET)
    return cfg


@pytest.fixture
def use_ema(monkeypatch):
    """Select the EMA tree in both packages for one test (module state)."""
    def select(enabled):
        monkeypatch.setattr(jdu, "_USE_EMA", enabled)
        monkeypatch.setattr(tdu, "_USE_EMA", enabled)
    return select


@functools.lru_cache(maxsize=1)
def _jax_model_and_forward():
    cfg = _cfg()
    jm = jdu.DiffusionUNetFactory().build(cfg["model"]["unet"], "concatenate", 1)
    return jm, jax.jit(lambda p, x, t: jm(p, x, t))


def _jax_model(cfg):
    assert cfg["model"]["unet"] == SMALL_UNET
    return _jax_model_and_forward()[0]


def _jax_forward(params, x, t):
    return np.asarray(_jax_model_and_forward()[1](params, jnp.asarray(x), jnp.asarray(t)))


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    return x, np.array([10, 700], np.int32)


def _assert_close(got, want, tol):
    err = float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())
    assert err <= tol, f"max|port-jax|/max|jax| = {err:.3e} > {tol:g}"


def _jax_state(jm, seed):
    """The JAX payload of a trained run: random weights, an EMA tree of other
    weights and AdamW's state after one update."""
    params = jax_unflatten(random_flat_params(jm, seed))
    ema = jax_unflatten(random_flat_params(jm, seed + 1))
    opt = optax.adamw(1e-4)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    _, opt_state = jax.jit(opt.update)(grads, opt.init(params), params)
    return {"model": params, "ema": ema, "optimizer": opt_state,
            "lr_scheduler": {"last_epoch": 1}, "scaler": None, "epoch": 1, "best_metric": 0.5}


@pytest.mark.parametrize("tree", ["model", "ema"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, use_ema, tree):
    cfg = _cfg()
    jm = _jax_model(cfg)
    state = _jax_state(jm, seed=11)
    path = tmp_path / "diff_last.pt"
    jckpt.save_checkpoint(state, path)
    use_ema(tree == "ema")
    model = tdu.build_diffusion_model(cfg, path, device="cpu")
    want_flat = jax_flatten(state[tree])
    got = model.state_dict()
    assert got.keys() == want_flat.keys() and model.weights_source == (str(path), tree)
    for k, v in want_flat.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    x, t = _inputs()
    want = _jax_forward(state[tree], x, t)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    _assert_close(out, want, FORWARD_TOL)
    # JAX's optax state stays a raw numpy mapping, its treedef never unpickled
    payload = tckpt.load_checkpoint(path)
    opt = payload["optimizer"]
    assert tckpt.is_jax_tree_map(opt) and opt[tckpt.TREEDEF].dtype == np.uint8
    with pytest.raises(ValueError, match="JAX package"):
        tckpt.load_optimizer_state(torch.optim.AdamW(model.parameters()), opt)
    assert payload["epoch"] == 1 and tckpt.maybe_load_checkpoint(path)[:2] == (2, 0.5)


def test_reading_a_jax_checkpoint_imports_no_jax(tmp_path):
    """The port reads every entry of a JAX checkpoint in a process that never
    imports JAX: the pickled treedefs stay bytes."""
    jm = _jax_model(_cfg())
    path = tmp_path / "diff_last.pt"
    jckpt.save_checkpoint(_jax_state(jm, seed=12), path)
    code = ("import sys\n"
            "from fmdm_tpu_torch.utils.checkpoint import load_checkpoint, load_model_params\n"
            f"p = load_checkpoint({str(path)!r})\n"
            "assert sorted(p) == ['best_metric', 'ema', 'epoch', 'lr_scheduler', 'model', "
            "'optimizer', 'scaler'], sorted(p)\n"
            f"assert load_model_params({str(path)!r}).keys() == p['model'].keys()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fmdm_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("tree", ["model", "ema"])
def test_port_checkpoint_loads_into_jax(tmp_path, use_ema, tree):
    cfg = _cfg()
    model = tdu.build_diffusion_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(5))
    ema = copy.deepcopy(model)
    init_weights(ema, torch.Generator().manual_seed(6))
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()
    path = tmp_path / "diff_last.pt"
    tckpt.save_checkpoint_with_mirrors(
        {"model": model, "ema": ema.state_dict(), "optimizer": optimizer, "epoch": 3,
         "best_metric": 0.25}, path, [tmp_path / "diff_best.pt"])
    assert tsu.resolve_checkpoint(tmp_path, "diffusion").name == "diff_best.pt"
    use_ema(tree == "ema")
    source = model if tree == "model" else ema
    _, params = jdu.build_diffusion_model(cfg, tmp_path / "diff_best.pt")
    flat = jax_flatten(params)
    assert flat.keys() == source.state_dict().keys()
    for k, v in source.state_dict().items():
        assert np.array_equal(np.asarray(flat[k]), v.numpy()), k
    x, t = _inputs(4)
    want = _jax_forward(params, x, t)
    with torch.no_grad():
        out = source(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    _assert_close(out, want, FORWARD_TOL)
    # the JAX package keeps the port's optimizer entry as it is; the port
    # loads it back into an optimizer
    assert jckpt.load_checkpoint(path)["optimizer"]["param_groups"][0]["lr"] == 1e-4
    fresh = torch.optim.AdamW(model.parameters(), lr=1.0)
    tckpt.load_optimizer_state(fresh, tckpt.load_checkpoint(path)["optimizer"])
    assert fresh.state_dict()["param_groups"][0]["lr"] == 1e-4
    assert int(fresh.state_dict()["state"][0]["step"]) == 1


def test_use_ema_without_an_ema_tree_raises(tmp_path, use_ema):
    cfg = _cfg()
    model = tdu.build_diffusion_model(cfg, device="cpu")
    tckpt.save_checkpoint({"model": model, "epoch": 1}, tmp_path / "diff_last.pt")
    use_ema(True)
    for build in (lambda p: tdu.build_diffusion_model(cfg, p, device="cpu"),
                  lambda p: jdu.build_diffusion_model(cfg, p)):
        with pytest.raises(ValueError, match="no 'ema' tree"):
            build(tmp_path / "diff_last.pt")


_LEGACY_NAMES = ((".to_q.", ".query."), (".to_k.", ".key."), (".to_v.", ".value."),
                 (".to_out.0.", ".proj_attn."), (".conv1.conv.", ".conv1."),
                 (".conv2.conv.", ".conv2."), (".emb_layers.", ".time_emb_proj."),
                 (".skip_connection.conv.", ".conv_shortcut."),
                 (".downsamplers.0.op.conv.", ".downsamplers.0.conv."),
                 (".upsamplers.0.conv.conv.", ".upsamplers.0.conv."))


def test_legacy_checkpoint_loads_through_the_key_remap(tmp_path):
    """A bare state dict under diffusers' names loads into both packages
    under ``load_legacy``, to the same weights."""
    cfg = _cfg()
    cfg["model"]["unet"]["load_legacy"] = True
    model = tdu.build_diffusion_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(8))
    legacy = {}
    for k, v in model.state_dict().items():
        for new, old in _LEGACY_NAMES:
            k = k.replace(new, old)
        legacy[k] = v
    assert tdu.remap_legacy_unet_keys(legacy).keys() == jdu.remap_legacy_unet_keys(legacy).keys() \
        == model.state_dict().keys()
    torch.save(legacy, tmp_path / "legacy.pt")
    got = tdu.build_diffusion_model(cfg, tmp_path / "legacy.pt", device="cpu").state_dict()
    _, params = jdu.build_diffusion_model(cfg, tmp_path / "legacy.pt")
    for k, v in jax_flatten(params).items():
        assert torch.equal(got[k], model.state_dict()[k]) and np.array_equal(np.asarray(v),
                                                                             got[k].numpy()), k
    with pytest.raises(RuntimeError, match="shape mismatch"):
        tdu.load_legacy_unet_state(model.state_dict(), {"conv_in.weight": np.zeros((1, 1))})
    with pytest.raises(RuntimeError, match="key mismatch"):
        tdu.load_legacy_unet_state(model.state_dict(), {"nope.weight": np.zeros(1)})


def _write_legacy_folder(root: Path):
    (root / "scheduler").mkdir(parents=True)
    (root / "unet").mkdir()
    (root / "model_index.json").write_text(json.dumps({"_class_name": "DDPMPipeline"}))
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "DDIMScheduler", "_diffusers_version": "0.20", "num_train_timesteps": 500,
         "beta_start": 0.0002, "clip_sample": False, "trained_betas": None}))
    (root / "unet" / "config.json").write_text(json.dumps(
        {"in_channels": 2, "out_channels": 1, "sample_size": 64, "layers_per_block": 1,
         "block_out_channels": [32, 64], "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
         "up_block_types": ["AttnUpBlock2D", "UpBlock2D"], "norm_eps": 1e-6}))


@pytest.mark.parametrize("layout", ["train_config", "legacy", "missing"])
def test_load_run_config_matches_jax(tmp_path, layout):
    if layout == "train_config":
        (tmp_path / "train_config.json").write_text(json.dumps(_cfg()))
    elif layout == "legacy":
        _write_legacy_folder(tmp_path)
    if layout == "missing":
        for load in (tsu.load_run_config, jsu.load_run_config):
            with pytest.raises(FileNotFoundError):
                load(tmp_path)
        return
    got, want = tsu.load_run_config(tmp_path), jsu.load_run_config(tmp_path)
    assert got == want and Path(got["__config_path__"]).exists()


@pytest.mark.parametrize("files,model_type", [
    (("diff_last.pt",), "diffusion"),
    (("diff_last.pt", "diff_best.pt"), "diffusion"),
    (("unet/diffusion_pytorch_model.safetensors", "other.pt"), "diffusion"),
    (("flow_last.pt", "diff_best.pt"), "flow_matching"),
    (("a.pt", "b.pt"), "latent"),
    (("vae_last.pt",), "diffusion"),
])
def test_resolve_checkpoint_preference_matches_jax(tmp_path, files, model_type):
    for name in files:
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_bytes(b"x")
    try:
        want = jsu.resolve_checkpoint(tmp_path, model_type)
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            tsu.resolve_checkpoint(tmp_path, model_type)
        return
    assert tsu.resolve_checkpoint(tmp_path, model_type) == want
    assert tckpt.latest_checkpoint(tmp_path, "diff") == jckpt.latest_checkpoint(tmp_path, "diff")


def test_run_dir_helpers_match_jax(tmp_path):
    class Data:
        def __len__(self):
            return 10

    for num in (None, 0, 4, 10, 20):
        assert tsu.resolve_sample_indices(Data(), num, seed=3) == \
            jsu.resolve_sample_indices(Data(), num, seed=3)
    assert tsu.resolve_output_root(tmp_path, None, True) == jsu.resolve_output_root(tmp_path, None, True)
    assert tsu.resolve_output_root(tmp_path, "o", False) is None
    exp = tsu.create_experiment_dir(tmp_path / "exp", "sample", "dpmsolver++", None, 700, 50, 8,
                                    seed=42, batch_size=4)
    assert exp.exists() and exp.name.split("_", 2)[2] == "sample_dpmsolverpppp_start700_ns8_seed42_bs4"
    for writer, args in ((tsu.append_eval_metrics, {"samples": 2, "psnr": 3.0}),
                         (tsu.write_eval_metrics, {"mse": 0.5}),
                         (tsu.append_per_image_eval_metrics, [{"a": 1}, {"b": 2}])):
        ours = writer(tmp_path / "t", args).read_text()
        theirs = getattr(jsu, writer.__name__)(tmp_path / "j", args).read_text()
        assert ours == theirs


@pytest.mark.parametrize("override,kw,stochastic", [
    ("ddim", dict(num_inference_steps=5), False),
    ("unipc?solver_order=3,use_karras_sigmas=true", dict(num_inference_steps=6, last_n_steps=4),
     False),
    ("dpmsolversde", dict(num_inference_steps=4, start_step=700, init_from_reference=True), True),
    (None, dict(num_inference_steps=10, last_n_steps=3), True),   # the config's DDPM
    ("dpmsolver++?algorithm_type=sde-dpmsolver++", dict(num_inference_steps=8, start_step=500,
                                                        init_from_reference=True), True),
])
def test_decode_matches_jax(monkeypatch, override, kw, stochastic):
    """The JAX decode splits its key into the reference noise's and the
    engine's; the engine into the start noise's and the steps', one key per
    step of the (aligned) schedule. The port gets those draws."""
    monkeypatch.setattr(jdu, "_DP_SAMPLING", False)
    cfg = _cfg()
    jm = _jax_model(cfg)
    flat = random_flat_params(jm, 13)
    params = jax_unflatten(flat)
    model = tdu.build_diffusion_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    rng = np.random.default_rng(14)
    cond = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    ref = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(15)
    training, model_cfg = cfg["training"], cfg["model"]
    want = np.asarray(jdu.decode_diffusion_batch(
        jm, params, training, model_cfg, SHAPE, jnp.asarray(cond), rng=key,
        reference_batch=jnp.asarray(ref), scheduler_override=override, **kw))

    k_ref, k_sample = jax.random.split(key)
    k_init, k_steps = jax.random.split(k_sample)
    engine = next(reversed(jdu._ENGINE_CACHE.values()))
    n = len(engine.timesteps)
    noise = lambda k: torch.from_numpy(np.array(jax.random.normal(k, SHAPE, jnp.float32)))
    init = noise(k_ref if kw.get("init_from_reference") else k_init)
    steps = [noise(k) for k in jax.random.split(k_steps, n)] if stochastic else None
    timing = {}
    got = tdu.decode_diffusion_batch(
        model, training, model_cfg, SHAPE, torch.from_numpy(cond), timing=timing,
        reference_batch=torch.from_numpy(ref), scheduler_override=override, init_noise=init,
        step_noise=steps, device="cpu", **kw)
    assert timing["model_calls"] == n and tuple(got.shape) == SHAPE
    _assert_close(got.numpy(), want, DECODE_TOL)


def test_decode_engine_cache_is_keyed_by_scheduler_and_weights(monkeypatch):
    monkeypatch.setattr(tdu, "_ENGINE_CACHE", {})
    cfg = _cfg()
    model = tdu.build_diffusion_model(cfg, device="cpu")
    cond = torch.zeros(SHAPE)

    def decode(override):
        return tdu.decode_diffusion_batch(model, cfg["training"], cfg["model"], SHAPE, cond,
                                          generator=torch.Generator().manual_seed(0),
                                          num_inference_steps=2, scheduler_override=override,
                                          device="cpu")

    first = decode("dpmsolver++")
    assert torch.equal(decode("dpmsolver++"), first) and len(tdu._ENGINE_CACHE) == 1
    assert not torch.equal(decode("dpmsolver++?thresholding=true,sample_max_value=0.1"), first)
    assert len(tdu._ENGINE_CACHE) == 2
    # Karras sigmas stashed by set_timesteps are part of the fingerprint
    decode("dpmsolver++?use_karras_sigmas=true")
    assert len(tdu._ENGINE_CACHE) == 3
    with torch.no_grad():
        next(model.parameters()).add_(1.0)   # new weights: a new engine
    assert not torch.equal(decode("dpmsolver++"), first) and len(tdu._ENGINE_CACHE) == 4
    for i in range(10):
        decode(f"ddim?eta={i / 10}")
    assert len(tdu._ENGINE_CACHE) == tdu._ENGINE_CACHE_MAX == 8


def test_unported_options_refuse_and_defaults_pass(monkeypatch):
    for off in (None, ()):
        tdu.set_deep_cache(off)
    tdu.set_quantize(None)
    with pytest.raises(NotImplementedError, match="item 6"):
        tdu.set_deep_cache((3, 1))
    with pytest.raises(NotImplementedError, match="item 11"):
        tdu.set_quantize("int8")
    with pytest.raises(ValueError):
        tdu.set_quantize("int4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cfg = _cfg()
    with pytest.raises(NotImplementedError, match="item 10"):
        tdu.decode_diffusion_batch(None, cfg["training"], cfg["model"], SHAPE)
    for backend in ("orbax", "torch_async"):
        with pytest.raises(NotImplementedError, match="item 12"):
            tckpt.set_checkpoint_backend(backend)


def test_encode_and_visual_batch_match_jax():
    from fmdm_tpu_torch.schedulers import DDPMScheduler

    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([3, 900])
    sched = DDPMScheduler.create()
    got = tdu.encode_diffusion_batch(sched, torch.from_numpy(x0), torch.from_numpy(t),
                                     noise=torch.from_numpy(noise))
    assert torch.equal(got, sched.add_noise(torch.from_numpy(x0), torch.from_numpy(noise),
                                            torch.from_numpy(t)))

    class Data:
        data = [{"Case": c} for c in "aabbbc"]

        def __len__(self):
            return 6

        def __getitem__(self, i):
            return {"target": np.full((1, 4, 4), i, np.float32), "image": np.ones((1, 4, 4))}

    targets, cond = tdu.prepare_diffusion_visual_batch(Data(), 2, seed=4)
    want_t, want_c = jdu.prepare_diffusion_visual_batch(Data(), 2, seed=4)
    assert np.array_equal(targets.numpy(), np.asarray(want_t)) and cond.shape == want_c.shape
    for batch, cfg in ((np.zeros((2, 3, 4)), {"unet": {"cross_attention_dim": 4}}),
                       (np.zeros((2, 4, 4)), {"unet": {"cross_attention_dim": 4}}),
                       (None, {})):
        assert tdu.warn_attention_conditioning_shape(batch, cfg) == \
            jdu.warn_attention_conditioning_shape(batch, cfg)


@pytest.mark.parametrize("name", sorted(n for n in dir(ssim_goldens) if n.startswith("test_")))
def test_port_ssim_meets_the_jax_goldens(monkeypatch, name):
    """Each golden of tests/test_ssim_goldens.py, run on the port's SSIM."""
    monkeypatch.setattr(ssim_goldens, "ssim", tev.ssim)
    monkeypatch.setattr(ssim_goldens, "compute_ssim_sample", tev.compute_ssim_sample)
    getattr(ssim_goldens, name)()


def test_psnr_grid_and_ssim_match_jax(tmp_path):
    from fmdm_tpu.utils import evaluation as jev

    rng = np.random.default_rng(1)
    a, b = rng.random((2, 3, 12, 12)), rng.random((2, 3, 12, 12))
    for mse in (0.0, 1e-3, 0.5):
        assert tev.psnr_from_mse(mse) == jev.psnr_from_mse(mse)
    assert tev.compute_ssim_sample(a[0], b[0]) == jev.compute_ssim_sample(a[0], b[0])
    assert tev.compute_ssim_sample(a[0, 0], b[0, 0]) == jev.compute_ssim_sample(a[0, 0], b[0, 0])
    assert tev.compute_ssim_sample(a[0], b[0, :2]) is None
    grid = tev.make_grid(np.concatenate([a, b]), 2, 2)
    assert np.array_equal(grid, jev.make_grid(np.concatenate([a, b]), 2, 2))
    tev.save_image(grid, tmp_path / "g.png")
    assert (tmp_path / "g.png").exists() or (tmp_path / "g.npy").exists()
