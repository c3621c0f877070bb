"""FSDP and tensor parallelism of the port (``parallel/fsdp.py``,
``parallel/tp.py``, the trainers' ``parallel_plan``) on the CPU, against the
JAX package.

In process: every parameter's placement rule equals JAX's
``fsdp_leaf_spec``, ``fsdp_tp_leaf_spec`` and ``tp_param_specs`` on the
reduced flagship UNet and KL-VAE (the parameters that take no gradient, the
discriminator's BatchNorm statistics, stay whole in the port); the two-axis
meshes' errors and batch-divisor search equal JAX's.

One cluster of four gloo ranks (``tests/torch_parallel_worker.py``, mode
``fsdp_tp``), spawned once: the denoise step under ``fsdp`` (4 ranks),
``tensor_parallel: 2`` (data 2 x model 2) and both, and the KL-VAE + GAN step
under ``fsdp`` and ``tensor_parallel: 2``, each on its rows of one global
batch of 4 and the JAX package's draws. Each is held against one process's
step on the global batch (the parameters after the step within 1e-6 plus
what AdamW's normalization makes of the gradients' difference, the
gradients within 1e-6 of the model's largest, or for the GAN step
``tests/test_torch_gan.py``'s tolerance) and against the JAX package's step
on the same global batch over two CPU devices at the one-process tests'
tolerances (``tests/test_torch_data_parallel.py``'s ``GRAD_TOLS``). The
placements on the ranks, each rank's state bytes, and ``train()`` one epoch
per flag, whose checkpoints the JAX package loads, are checked too."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxUNetFactory
from fmdm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.parallel import fsdp as jfsdp
from fmdm_tpu.parallel import mesh as jmesh
from fmdm_tpu.parallel import tp as jtp
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.schedulers import DDPMScheduler as JaxDDPM
from fmdm_tpu.train.common import device_put_batch
from fmdm_tpu.train.common import make_denoise_train_step as jax_make_step
from fmdm_tpu.utils import checkpoint as jckpt
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory, VAEFactory
from fmdm_tpu_torch.parallel import fsdp as tfsdp
from fmdm_tpu_torch.parallel import mesh as tmesh
from fmdm_tpu_torch.parallel import tp as ttp
from tests import torch_parallel_worker as worker
from tests.torch_parallel_worker import run_cluster
from tests.test_torch_data_parallel import GRAD_TOLS, _NoPerceptual, _assert_grads_close
from tests.test_torch_denoise_train import _gradient_reader
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_gan import LOSS_TOL as GAN_LOSS_TOL
from tests.test_torch_gan import _jax_gan_step_fns, disc_flat_params
from tests.test_torch_gan import _jax_step as jax_gan_step
from tests.test_torch_models import random_flat_params as unet_flat_params
from tests.test_torch_train_cli import small_cfg, write_ldct_root
from tests.test_torch_vae import random_flat_params as vae_flat_params
from tests.torch_dp_worker import compare

PARAM_GRAD_TOL = 1e-6


# ---------------------------------------------------------------------------
# The JAX side: weights, one global batch, JAX's draws and its steps
# ---------------------------------------------------------------------------

def jax_side():
    """(the workers' inputs, JAX's steps): the denoise and the KL-VAE + GAN
    weights, one global batch of 4 each and the JAX package's draws, and a
    function that runs the JAX package's steps on them over two CPU
    devices."""
    mesh = jmesh.create_mesh(2)
    shard = lambda a: jmesh.shard_batch(mesh, jnp.asarray(a))
    tree = lambda flat: unflatten_params({n: jnp.asarray(v) for n, v in flat.items()})
    rng = np.random.default_rng(30)
    inputs = {}

    jm = JaxUNetFactory().build(dict(worker.UNET), "concatenate", 1)
    flat = unet_flat_params(jm, 31)
    batch = {"target": rng.standard_normal((4, 1, 16, 16)).astype(np.float32),
             "image": rng.standard_normal((4, 1, 16, 16)).astype(np.float32),
             "valid": np.array([1.0, 1.0, 1.0, 0.0], np.float32)}
    key = jax.random.PRNGKey(32)
    k_noise, k_t = jax.random.split(key)
    inputs["denoise"] = dict(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        weights={n: torch.from_numpy(v) for n, v in flat.items()},
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, (4, 1, 16, 16), jnp.float32))),
        t=torch.from_numpy(np.array(jax.random.randint(k_t, (4,), 0, worker.N_TRAIN))))

    cfg = worker.VAE
    jk = JaxAutoencoderKL(**{k: v for k, v in cfg.items() if k not in ("latent_type",
                                                                       "model_type")})
    jd = jk.make_discriminator()
    gflat, dflat = vae_flat_params(jk, 33), disc_flat_params(jd, 34)
    side = cfg["resolution"] // 2
    vae = {"raw": rng.uniform(0.0, 1.0, (4, 1, 16, 16)).astype(np.float32),
           "valid": np.ones(4, np.float32),
           "noise": rng.standard_normal((4, cfg["embed_dim"], side, side)).astype(np.float32)}
    inputs["vae"] = dict({k: torch.from_numpy(v) for k, v in vae.items()}, weights=gflat,
                         disc_weights=dflat)

    def steps():
        jstep = jax_make_step(jm, JaxDDPM.create(num_train_timesteps=worker.N_TRAIN),
                              _gradient_reader(), variant="diffusion",
                              conditioning_mode="concatenate", latent_norm=None)
        reader = _gradient_reader()
        _, st, loss_sum, count = jstep(tree(flat), reader.init(tree(flat)),
                                       device_put_batch(mesh, batch), key)
        fns = _jax_gan_step_fns(jk, jd, dict(worker.VAE_STEP, perceptual_weight=0.0),
                                _NoPerceptual())
        m, vcount, g, dg = jax_gan_step(fns, tree(gflat), tree(dflat), shard(vae["raw"]),
                                        shard(vae["valid"]), shard(vae["noise"]),
                                        jnp.float32(worker.KL_SCALE), 1)
        return {"denoise": {"grads": flatten_params(st["g"]), "loss_sum": float(loss_sum),
                            "count": float(count)},
                "vae": {"grads": flatten_params(g), "disc_grads": flatten_params(dg),
                        "metrics": {k: float(v) for k, v in m.items()}, "count": float(vcount)}}

    return inputs, steps


def train_configs(tmp: Path) -> Path:
    """The LDCT DDPM and KL-VAE configs at 16² over a synthetic root, one
    epoch each, the VAE's mid attention at 64 tokens."""
    root = write_ldct_root(tmp / "data")
    cfgs = {"ddpm": small_cfg("diffusion", root, tmp / "ckpt"),
            "vae": small_cfg("vae", root, tmp / "ckpt")}
    cfgs["ddpm"]["training"].update(save_images=False)
    path = tmp / "configs.json"
    path.write_text(json.dumps(cfgs))
    return path


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_tp")
    inputs, steps = jax_side()
    result, want = run_cluster("fsdp_tp", 4, tmp, inputs, steps,
                               FMDM_PAR_CONFIGS=str(train_configs(tmp)))
    return result, want, inputs


# ---------------------------------------------------------------------------
# Placement rules, in process
# ---------------------------------------------------------------------------

def _models():
    """The reduced flagship UNet and KL-VAE (+ its discriminator), port side."""
    unet = DiffusionUNetFactory().build(dict(worker.UNET), "concatenate", 1, device="cpu")
    vae = VAEFactory().build(dict(worker.VAE), device="cpu")
    return {"unet": unet, "vae": vae, "disc": vae.make_discriminator(device="cpu")}


def _jax(spec) -> tuple:
    """A PartitionSpec as the port writes it: a tuple, () for whole."""
    spec = tuple(spec)
    return spec if any(a is not None for a in spec) else ()


@pytest.mark.parametrize("model", ["unet", "vae", "disc"])
@pytest.mark.parametrize("rule,sizes", [("fsdp", (2,)), ("fsdp", (4,)), ("tp", (2,)),
                                        ("fsdp_tp", (2, 2)), ("fsdp_tp", (4, 2))])
def test_placement_rules_equal_jax(model, rule, sizes):
    module = _models()[model]
    if rule == "fsdp":
        got = tfsdp.fsdp_param_specs(module, *sizes)
        want = lambda shape: jfsdp.fsdp_leaf_spec(shape, *sizes)
    elif rule == "tp":
        got = ttp.tp_param_specs(module, *sizes)
        want = lambda shape: jtp._leaf_spec("", shape, sizes[0], "model")
    else:
        got = tfsdp.fsdp_tp_param_specs(module, *sizes)
        want = lambda shape: jfsdp.fsdp_tp_leaf_spec(shape, *sizes)
    sliced = 0
    for name, p in module.named_parameters():
        if not p.requires_grad:   # BatchNorm's statistics: whole in the port
            assert ".running_" in name and got[name] == ()
            continue
        assert got[name] == _jax(want(tuple(p.shape))), name
        sliced += bool(got[name])
    assert sliced > len(got) // 2


def test_two_axis_meshes_equal_jax():
    eight = ["cpu"] * 8
    for sp in (1, 2, 4, 8):
        for batch in (1, 2, 4, 6, 8, 16):
            try:
                want = jmesh.create_dp_sp_mesh(batch, sp)
            except ValueError as err:
                with pytest.raises(ValueError, match=str(err).split("(")[0]):
                    tmesh.create_dp_sp_mesh(batch, sp, devices=eight)
                continue
            got = tmesh.create_dp_sp_mesh(batch, sp, devices=eight)
            assert got.shape == tuple(want.devices.shape) and got.axis_names == want.axis_names
    for tp in (1, 2, 3, 4, 8):
        for batch in (1, 3, 4, 6, 8):
            try:
                want = jtp.create_dp_tp_mesh_global(batch, tp)
            except ValueError as err:
                with pytest.raises(ValueError, match=str(err)):
                    tmesh.create_dp_tp_mesh_global(batch, tp, devices=eight)
                continue
            got = tmesh.create_dp_tp_mesh_global(batch, tp, devices=eight)
            assert got.shape == tuple(want.devices.shape) and got.axis_names == want.axis_names
    with pytest.raises(ValueError, match="must divide the device count 1"):
        tmesh.create_dp_tp_mesh_global(4, 2, devices=["cpu"])


# ---------------------------------------------------------------------------
# The steps over four ranks
# ---------------------------------------------------------------------------

CASES = [("denoise", "fsdp"), ("denoise", "tp"), ("denoise", "tp_fsdp"), ("vae", "fsdp"),
         ("vae", "tp")]


@pytest.mark.parametrize("model,kind", CASES)
def test_steps_equal_one_process_on_the_global_batch(cluster, model, kind):
    result, _, _ = cluster
    got, ref = result[model][kind], result["one_process"][model]
    assert got["count"] == ref["count"]
    if model == "denoise":
        res = compare(got["params"], ref["params"], got["grads"], ref["grads"], worker.LR, kind)
        assert res[f"{kind}_param_excess"] <= 0.0 and res[f"{kind}_grad"] <= PARAM_GRAD_TOL
        assert abs(got["loss_sum"] - ref["loss_sum"]) <= PARAM_GRAD_TOL * abs(ref["loss_sum"])
        res = compare(got["ema"], ref["ema"], got["grads"], ref["grads"], worker.LR, "ema")
        assert res["ema_param_excess"] <= 0.0
        return
    for prefix, lr in (("", worker.LR), ("disc_", worker.VAE_STEP["disc_lr"])):
        res = compare(got[f"{prefix}params"], ref[f"{prefix}params"], got[f"{prefix}grads"],
                      ref[f"{prefix}grads"], lr, kind, gan=True)
        assert res[f"{kind}_param_excess"] <= 0.0 and res[f"{kind}_grad_excess"] <= 0.0, prefix
    scale = max(abs(v) for v in ref["metrics"].values())
    for name, want in ref["metrics"].items():
        assert abs(got["metrics"][name] - want) <= PARAM_GRAD_TOL * scale, name


@pytest.mark.parametrize("model,kind", CASES)
def test_steps_match_jax_on_the_global_batch(cluster, model, kind):
    result, want, _ = cluster
    got, want = result[model][kind], want[model]
    assert got["count"] == want["count"] == {"denoise": 3.0, "vae": 4.0}[model]
    rtol, atol_of = GRAD_TOLS["denoise" if model == "denoise" else "gan"]
    _assert_grads_close(got["grads"], want["grads"], rtol, atol_of, (kind, "G"))
    if model == "denoise":
        assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)
        return
    _assert_grads_close(got["disc_grads"], want["disc_grads"], rtol, atol_of, (kind, "D"))
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=GAN_LOSS_TOL, abs=1e-12), k


@pytest.mark.parametrize("model,kind", CASES)
def test_placements_on_the_ranks(cluster, model, kind):
    """Rank 0's shards: FSDP's dim is JAX's where JAX cuts, dim 0 (uneven,
    padded by FSDP2) where JAX keeps the tensor whole; tensor parallelism's
    slice is half of dim 0 where JAX's rule cuts it."""
    result, _, _ = cluster
    models = _models()
    for key, module in (("placements", models["unet" if model == "denoise" else "vae"]),
                        ("disc_placements", models["disc"])):
        if key not in result[model][kind]:
            continue
        placed = result[model][kind][key]
        for name, p in module.named_parameters():
            dim, shape = placed[name]
            full = tuple(p.shape)
            if not p.requires_grad:
                assert dim is None and shape == full, name
                continue
            if kind == "fsdp":
                spec = _jax(jfsdp.fsdp_leaf_spec(full, 4))
                want_dim = spec.index("data") if spec else 0
                assert dim == want_dim, name
                cut = list(full)
                cut[want_dim] = -(-full[want_dim] // 4)
                assert shape == tuple(cut), name
                continue
            tp_cut = list(full)
            if _jax(jtp._leaf_spec("", full, 2, "model")):
                tp_cut[0] //= 2
            if kind == "tp":
                assert dim is None and shape == tuple(tp_cut), name
            else:
                spec = _jax(jfsdp.fsdp_tp_leaf_spec(full, 2, 2))
                want_dim = spec.index("data") if "data" in spec else 0
                assert dim == want_dim, name
                tp_cut[want_dim] = -(-tp_cut[want_dim] // 2)
                assert shape == tuple(tp_cut), name


@pytest.mark.parametrize("model,kind,share", [("denoise", "fsdp", 4), ("denoise", "tp", 2),
                                              ("denoise", "tp_fsdp", 4), ("vae", "fsdp", 4),
                                              ("vae", "tp", 2)])
def test_each_rank_holds_its_share_of_the_state(cluster, model, kind, share):
    """Parameters and AdamW's two moments: about 1/share of the whole on
    rank 0 (what stays whole or is padded adds a little)."""
    result, _, _ = cluster
    ref = result["one_process"][model]
    whole = sum(t.numel() * 4 * 3 for key in ("params", "disc_params") for k, t in
                ref.get(key, {}).items() if ".running_" not in k)
    got = result[model][kind]["bytes"]
    assert whole / share <= got <= whole / share * 1.15 + 4096, (got, whole)


@pytest.mark.parametrize("run", ["ddpm_fsdp", "ddpm_tp", "ddpm_tp_fsdp", "vae_fsdp", "vae_tp"])
def test_train_under_each_flag_writes_a_run_jax_loads(cluster, run):
    check_run_loads_in_jax(cluster[0]["train"][run], run)


@pytest.mark.parametrize("run", ["ddpm_fsdp", "ddpm_tp", "ddpm_tp_fsdp", "vae_fsdp", "vae_tp"])
def test_train_runs_no_start_up_trial_of_the_uncut_model(cluster, run):
    """Under a strategy that cuts the model the configured accumulation is
    kept: no trial of the whole model, which may fit a card only when cut."""
    assert cluster[0]["train"][run]["trials"] == 0


def test_a_resumed_run_under_tp_and_fsdp_continues_as_the_straight_one(cluster):
    """One epoch under ``tensor_parallel: 2`` with ``fsdp`` (4 ranks),
    resumed for a second (the checkpoint's whole weights, AdamW state, EMA
    and generator cut onto the ranks again), equals two epochs straight:
    the weights and the moments within 1e-6 of their largest, the same
    optimizer step."""
    from fmdm_tpu_torch.utils import checkpoint as tckpt

    result = cluster[0]["resume"]
    got, want = (tckpt.load_checkpoint(Path(result[k]["run"]) / "diff_last.pt")
                 for k in ("resumed", "straight"))
    assert got["epoch"] == want["epoch"] == 2
    assert Path(result["resumed"]["run"]) == Path(cluster[0]["train"]["ddpm_tp_fsdp"]["run"])
    for name, w in want["model"].items():
        assert float((got["model"][name] - w).abs().max()) <= 1e-6 * max(
            float(w.abs().max()), 1.0), name
    steps = {int(st["step"]) for st in got["optimizer"]["state"].values()}
    assert steps == {int(st["step"]) for st in want["optimizer"]["state"].values()}
    assert steps and min(steps) >= 2
    for i, st in want["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            w = st[key]
            assert float((got["optimizer"]["state"][i][key] - w).abs().max()) <= 1e-6 * max(
                float(w.abs().max()), 1e-12), (i, key)


def check_run_loads_in_jax(out: dict, run: str) -> None:
    """``train()`` one epoch over the ranks: one run dir, its epoch's
    checkpoint written whole by rank 0, read by the JAX package with the
    full shapes of its model's tree; no routing left in force."""
    assert not out["context_after"]
    path = Path(out["run"])
    # the first epoch's snapshot (a later test resumes the run's last checkpoint)
    ckpt = path / "epochs" / "epoch0001" / "epoch.pt"
    payload = jckpt.load_checkpoint(ckpt)
    assert payload["epoch"] == 1
    cfg = json.loads((path / "train_config.json").read_text())
    if run.startswith("vae"):
        from fmdm_tpu.sample.vae_utils import build_vae_model

        _, params = build_vae_model(cfg, ckpt)
    else:
        _, params = jdu.build_diffusion_model(cfg, ckpt)
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    model = flatten_params(payload["model"])
    assert flat.keys() == model.keys()
    for name, value in model.items():
        assert np.array_equal(flat[name], np.asarray(value)), name
    moments = payload["optimizer"]["state"]
    shapes = [tuple(np.shape(v)) for v in model.values()]
    assert all(tuple(np.shape(st["exp_avg"])) in shapes for st in moments.values())
