"""Sequence parallelism of the port (``parallel/sequence.py``, the ring's
entry points in ``ops/kernels/flash_attention.py``, ``sdpa``'s routing in
``ops/attention.py`` and the engines' scoping) on the CPU, against the JAX
package. JAX's Pallas kernels run in interpret mode, as its own tests run
them, over the 8 host devices ``tests/conftest.py`` makes.

In process:

- ``flash_forward_partials`` and ``flash_backward_chunk`` against JAX's on
  both branches (a 128-aligned chunk, JAX's Pallas kernels; a ragged one,
  its einsum formulation), f32 within 2e-5 and bf16 within 3e-2, the chunk
  backward against the GLOBAL (out, lse);
- the ring's one-process form over ``["cpu", "cpu"]``, both impls, f32 and
  bf16, against JAX's ring over two devices: values at
  ``tests/test_sequence_parallel.py``'s 2e-5 (f32) and 3e-2 (bf16),
  gradients of sum(sin(out)) at its 5e-5 (f32) and at 3e-2 of the largest
  (bf16);
- ``sdpa`` under a one-process ``("data", "seq")`` context: the ring at
  ``min_tokens`` and above, the local path below, JAX's values; the sampling
  engine over such a mesh equals the unsplit engine within 1e-4 with the
  ring engaged, an engine without one never sees a trainer's context, and
  ``train()`` clears the context it returns from.

One cluster of two gloo ranks (``tests/torch_parallel_worker.py``, mode
``seq``), spawned once: the ring's rank form on the same cases, ``sdpa``'s
all-to-all routing over a rank mesh, the denoise and KL-VAE + GAN steps
under ``sequence_parallel: 2`` against one process's step and JAX's on the
same global batch (``tests/test_torch_fsdp_tp.py``'s inputs and
tolerances), and ``train()`` one epoch of each under it."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fmdm_tpu.ops import attention as jattn
from fmdm_tpu.parallel import sequence as jseq
from fmdm_tpu_torch.ops import attention as tattn
from fmdm_tpu_torch.parallel import mesh as tmesh
from fmdm_tpu_torch.parallel import sequence as tseq
from tests import torch_parallel_worker as worker
from tests.test_torch_data_parallel import GRAD_TOLS, _assert_grads_close
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_fsdp_tp import (PARAM_GRAD_TOL, check_run_loads_in_jax, jax_side,
                                      run_cluster, train_configs)
from tests.test_torch_gan import LOSS_TOL as GAN_LOSS_TOL
from tests.torch_dp_worker import compare

# the modules (their packages export a function of the same name)
jflash = importlib.import_module("fmdm_tpu.ops.pallas.flash_attention")
tflash = importlib.import_module("fmdm_tpu_torch.ops.kernels.flash_attention")
CPU2 = ["cpu", "cpu"]
TOL = {"f32": (2e-5, 5e-5), "bf16": (3e-2, 3e-2)}   # values, gradients
RINGS = {"flash_f32": ("flash", "f32", (1, 2, 256, 16)),
         "flash_bf16": ("flash", "bf16", (1, 2, 256, 16)),
         "einsum_f32": ("einsum", "f32", (2, 2, 32, 8)),
         "einsum_bf16": ("einsum", "bf16", (2, 2, 32, 8))}
JDTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _draw(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# The JAX ring
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_ring(name: str):
    """JAX's ring over two devices on case ``name``: out, and the
    gradients (dq, dk, dv) against the case's cotangent g."""
    impl, dt, shape = RINGS[name]
    q, k, v, g = (jnp.asarray(_draw(40 + i, shape), JDTYPE[dt]) for i in range(4))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    spec = P(None, None, "data", None)
    ring = jax.shard_map(functools.partial(jseq.ring_attention, axis_name="data", impl=impl),
                         mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                         check_vma=False)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(ring, q, k, v)
        return out, vjp(g)

    out, grads = run(q, k, v, g)
    return {"inputs": [np.array(jnp.asarray(x, jnp.float32)) for x in (q, k, v, g)],
            "out": _np(out), "grads": [_np(x) for x in grads]}


def _ring_inputs() -> dict:
    cases = {}
    for name, (impl, dt, _) in RINGS.items():
        q, k, v, g = (torch.from_numpy(x) for x in jax_ring(name)["inputs"])
        cases[name] = {"q": q, "k": k, "v": v, "g": g, "impl": impl, "dtype": dt}
    return cases


def _routing_inputs() -> dict:
    shape = (2, 2, 64, 8)
    q, k, v, g = (torch.from_numpy(_draw(50 + i, shape)) for i in range(4))
    return {"q": q, "k": k, "v": v, "g": g}


def _assert_ring_close(got: dict, name: str) -> None:
    """Out and gradients of a port ring against JAX's on case ``name``."""
    want = jax_ring(name)
    val_tol, grad_tol = TOL[RINGS[name][1]]
    np.testing.assert_allclose(_np(got["out"]), want["out"], rtol=val_tol, atol=val_tol)
    for key, w in zip(("dq", "dk", "dv"), want["grads"]):
        atol = grad_tol * (1.0 if RINGS[name][1] == "f32" else float(np.abs(w).max()))
        np.testing.assert_allclose(_np(got[key]), w, rtol=grad_tol, atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    inputs, steps = jax_side()
    inputs["rings"] = _ring_inputs()
    inputs["routing"] = _routing_inputs()
    result, want = run_cluster("seq", 2, tmp, inputs, steps,
                               FMDM_PAR_CONFIGS=str(train_configs(tmp)))
    return result, want, inputs


# ---------------------------------------------------------------------------
# The chunk entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("tk", [256, 200])   # JAX's Pallas branch, its einsum branch
def test_chunk_entry_points_match_jax(dt, tk):
    scale = 0.25
    tq = 256
    q = _draw(60, (2, 2, tq, 16))
    k, v = _draw(61, (2, 2, tk + 128, 16)), _draw(62, (2, 2, tk + 128, 16))
    g = _draw(63, (2, 2, tq, 16))
    jx = lambda a: jnp.asarray(a, JDTYPE[dt])
    tx = lambda a: torch.tensor(a).to(TDTYPE[dt])
    val_tol = TOL[dt][0]
    # the global (out, lse) over both chunks, then chunk 0 (tk tokens)
    j_out, j_lse = jflash.flash_forward_partials(jx(q), jx(k), jx(v), scale)
    t_out, t_lse = tflash.flash_forward_partials(tx(q), tx(k), tx(v), scale)
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=val_tol, atol=val_tol)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), rtol=val_tol, atol=val_tol)
    assert t_lse.dtype == torch.float32 and t_lse.shape == (2, 2, tq, 1)
    out, lse = np.asarray(jnp.asarray(j_out, jnp.float32)), np.asarray(j_lse)
    want = jflash.flash_backward_chunk(jx(q), jx(k[..., :tk, :]), jx(v[..., :tk, :]), jx(out),
                                       jnp.asarray(lse), jx(g), scale)
    got = tflash.flash_backward_chunk(tx(q), tx(k[..., :tk, :]), tx(v[..., :tk, :]), tx(out),
                                      torch.tensor(lse), tx(g), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == TDTYPE[dt] and tuple(a.shape) == tuple(b.shape), name
        tol = val_tol * (1.0 if dt == "f32" else float(np.abs(_np(b)).max()))
        np.testing.assert_allclose(_np(a), _np(b), rtol=val_tol, atol=tol, err_msg=name)


def test_block_rule_equals_jax():
    for tk in (1, 17, 128, 200, 384, 512, 640, 768, 1000, 1024, 1536, 2048):
        assert tflash.pick_block_k(tk) == jflash.pick_block_k(tk), tk
        assert tflash.pick_block_k(tk, cap=256) == jflash.pick_block_k(tk, cap=256), tk


def test_flash_hop_eligibility_equals_jax():
    for q_shape, k_shape in (((1, 2, 256, 32), (1, 2, 256, 32)), ((1, 2, 16, 8), (1, 2, 16, 8)),
                             ((1, 2, 256, 32), (1, 2, 200, 32)), ((1, 1, 128, 16), (1, 1, 128, 16)),
                             ((1, 1, 128, 8), (1, 1, 128, 8))):
        want = jseq._flash_hop_eligible(jnp.zeros(q_shape), jnp.zeros(k_shape))
        assert tseq._flash_hop_eligible(torch.zeros(q_shape), torch.zeros(k_shape)) == want


# ---------------------------------------------------------------------------
# The ring, one-process form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RINGS))
def test_one_process_ring_matches_jax(name):
    impl, dt, _ = RINGS[name]
    q, k, v, g = (torch.from_numpy(x).to(TDTYPE[dt]) for x in jax_ring(name)["inputs"])
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = tseq.sequence_parallel_sdpa(q, k, v, devices=CPU2, impl=impl)
    out.backward(g)
    _assert_ring_close({"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}, name)


def test_ring_impls_and_self_test():
    tseq.run_self_tests("cpu")
    with pytest.raises(ValueError, match="Unknown ring impl"):
        tseq.ring_attention([torch.zeros(1, 4, 2)] * 2, [torch.zeros(1, 4, 2)] * 2,
                            [torch.zeros(1, 4, 2)] * 2, devices=CPU2, impl="bogus")
    x = torch.zeros(1, 1, 6, 4)
    with pytest.raises(ValueError, match="must divide the token counts"):
        tseq.sequence_parallel_sdpa(x, x, x, devices=["cpu"] * 4)


def test_custom_scale_matches_jax():
    shape = (1, 1, 32, 8)
    q, k, v = (_draw(70 + i, shape) for i in range(3))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    want = jseq.sequence_parallel_sdpa(*(jnp.asarray(x) for x in (q, k, v)), mesh=mesh,
                                       axis="data", scale=0.25)
    got = tseq.sequence_parallel_sdpa(*(torch.from_numpy(x) for x in (q, k, v)), devices=CPU2,
                                      scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# sdpa's routing and the context's scope
# ---------------------------------------------------------------------------

@pytest.fixture
def ring_calls(monkeypatch):
    calls = []
    real = tseq.ring_attention

    def counting(*args, **kwargs):
        calls.append(kwargs.get("group") is not None)
        return real(*args, **kwargs)

    monkeypatch.setattr(tseq, "ring_attention", counting)
    yield calls
    tattn.clear_sequence_parallel()


def test_sdpa_routes_through_the_ring(ring_calls):
    mesh = tmesh.create_dp_sp_mesh(4, 2, devices=["cpu"] * 4)
    assert mesh.shape == (2, 2) and mesh.axis_names == ("data", "seq")
    tattn.set_sequence_parallel(mesh, "seq", min_tokens=64)
    shape = (4, 2, 64, 16)
    q, k, v = (_draw(80 + i, shape) for i in range(3))
    out = tattn.sdpa(*(torch.from_numpy(x) for x in (q, k, v)))
    assert ring_calls == [False]
    want = jattn.sdpa_xla(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    small = torch.from_numpy(_draw(83, (4, 2, 32, 16)))   # below min_tokens: local
    tattn.sdpa(small, small, small)
    odd = torch.from_numpy(_draw(84, (4, 2, 65, 16)))      # not divisible: local
    tattn.sdpa(odd, odd, odd)
    assert ring_calls == [False]
    with pytest.raises(ValueError, match="has no 'seq' axis"):
        tattn.set_sequence_parallel(tmesh.create_dp_tp_mesh(1, 2, devices=CPU2), "seq")


def _engine_case():
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
    from fmdm_tpu_torch.nn.layers import init_weights
    from fmdm_tpu_torch.schedulers import DDIMScheduler

    unet = {"unet_impl": "diffusers_nd", "sample_size": 16, "in_channels": 1,
            "out_channels": 1, "layers_per_block": 1, "block_out_channels": [8, 16],
            "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
            "up_block_types": ["AttnUpBlock2D", "UpBlock2D"], "norm_num_groups": 4}
    model = DiffusionUNetFactory().build(unet, None, 1, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    sched = DDIMScheduler.create(num_train_timesteps=50)
    return model, sched, sched.set_timesteps(3)


def test_engine_over_a_seq_mesh_equals_the_unsplit_engine(ring_calls):
    """The counterpart of ``tests/test_multichip.py``'s
    ``test_sequence_parallel_sampling_matches_single_device``: the batch over
    the data rows, each row's attention (64 tokens) through the ring over its
    devices, with the mesh's own context (min_tokens 1)."""
    from fmdm_tpu_torch.sample.engine import SamplingEngine

    model, sched, ts = _engine_case()
    single = SamplingEngine(model, sched, ts, device="cpu")((4, 1, 16, 16),
                                                            torch.Generator().manual_seed(7))
    assert ring_calls == []
    mesh = tmesh.create_dp_sp_mesh(4, 2, devices=["cpu"] * 4)
    tattn.set_sequence_parallel(mesh, "seq", min_tokens=1)
    engine = SamplingEngine(model, sched, ts, device="cpu", mesh=mesh)
    out = engine((4, 1, 16, 16), torch.Generator().manual_seed(7))
    # 2 data rows x 3 steps x 4 attention calls (down 1, mid 1, up 2)
    assert len(ring_calls) == 2 * 3 * 4 and not any(ring_calls)
    np.testing.assert_allclose(out.numpy(), single.numpy(), rtol=1e-4, atol=1e-4)
    assert tattn.get_sequence_parallel()[0] is mesh


def test_vae_engine_over_a_seq_mesh_equals_the_unsplit_engine(ring_calls):
    """``_make_dp_fn`` over a (data 2, seq 2) mesh: the batch over the data
    rows, each row's mid attention (64 tokens, min_tokens 16 set for this
    mesh) through the ring."""
    from fmdm_tpu_torch.models.factories import VAEFactory
    from fmdm_tpu_torch.nn.layers import init_weights
    from fmdm_tpu_torch.sample import autoencoder_like
    from fmdm_tpu_torch.sample.vae_utils import reconstruct_vae_batch

    vae = VAEFactory().build(dict(worker.VAE, base_ch=16, down_channels=[16, 16]), device="cpu")
    init_weights(vae, torch.Generator().manual_seed(2)).eval()
    images = np.random.default_rng(3).uniform(0, 1, (3, 1, 16, 16)).astype(np.float32)
    core = lambda m, x: reconstruct_vae_batch(m, x)
    one = autoencoder_like._make_dp_fn(core, vae, 3, torch.device("cpu"))(images)
    mesh = tmesh.create_dp_sp_mesh(4, 2, devices=["cpu"] * 4)
    tattn.set_sequence_parallel(mesh, "seq", min_tokens=worker.MIN_TOKENS)
    split = autoencoder_like._make_dp_fn(core, vae, 3, torch.device("cpu"), mesh)(images)
    assert len(ring_calls) == 2 * 2   # 2 data rows x the encoder's and decoder's mid attention
    np.testing.assert_allclose(split.numpy(), one.numpy(), rtol=1e-5, atol=1e-5)


def test_engine_isolated_from_a_foreign_context(ring_calls):
    """A trainer's process-global routing never reaches an engine over
    another mesh, or none, and survives the call untouched."""
    from fmdm_tpu_torch.sample.engine import SamplingEngine

    model, sched, ts = _engine_case()
    train_mesh = tmesh.create_dp_sp_mesh(4, 2, devices=["cpu"] * 4)
    tattn.set_sequence_parallel(train_mesh, "seq", min_tokens=1)
    for mesh in (None, tmesh.create_mesh(devices=["cpu"] * 3)):
        out = SamplingEngine(model, sched, ts, device="cpu", mesh=mesh)(
            (3, 1, 16, 16), torch.Generator().manual_seed(1))
        assert torch.isfinite(out).all()
    assert ring_calls == []
    ctx = tattn.get_sequence_parallel()
    assert ctx is not None and ctx[0] is train_mesh and ctx[2] == 1


def test_train_clears_the_context(tmp_path, ring_calls):
    """``train()`` returns with no routing in force, whatever was set before
    (JAX's ``train`` clears it in a ``finally``)."""
    import json

    from fmdm_tpu_torch.data.mnist import MNISTDataset
    from fmdm_tpu_torch.train import denoise_lib

    ds = MNISTDataset(tmp_path / "data", img_size=8)
    ds.images, ds.labels, ds.data = ds.images[:4], ds.labels[:4], ds.data[:4]
    unet = {"unet_impl": "diffusers_nd", "block_out_channels": [8, 16], "norm_num_groups": 4,
            "layers_per_block": 1, "down_block_types": ["DownBlock2D", "DownBlock2D"],
            "up_block_types": ["UpBlock2D", "UpBlock2D"]}
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"training": {"batch_size": 4, "seed": 0, "save_images": False,
                                            "output_dir": str(tmp_path / "run")},
                               "model": {"unet": unet, "model_type": "diffusion"}}))
    tattn.set_sequence_parallel(tmesh.create_dp_sp_mesh(4, 2, devices=CPU2), "seq")
    denoise_lib.train(ds, cfg, variant="diffusion", max_steps_per_epoch=1, device="cpu")
    assert tattn.get_sequence_parallel() is None
    bad = json.loads(cfg.read_text())
    bad["training"].update(sequence_parallel=2, fsdp=True)
    cfg.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="composes with plain DP only"):
        denoise_lib.train(ds, cfg, variant="diffusion", device="cpu")
    bad["training"].update(fsdp=False)
    cfg.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="must divide the device count 1"):
        denoise_lib.train(ds, cfg, variant="diffusion", device="cpu")
    assert tattn.get_sequence_parallel() is None


# ---------------------------------------------------------------------------
# Over two ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RINGS))
def test_rank_ring_matches_jax(cluster, name):
    _assert_ring_close(cluster[0]["rings"][name], name)


def test_sdpa_all_to_all_routing_over_ranks(cluster):
    result, _, inputs = cluster
    r = inputs["routing"]
    q = r["q"].clone().requires_grad_()
    want = tattn.sdpa_xla(q, r["k"], r["v"])
    want.backward(r["g"])
    got = result["routing"]
    np.testing.assert_allclose(got["out"].numpy(), want.detach().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["dq"].numpy(), q.grad.numpy(), rtol=5e-5, atol=5e-5)
    short = r["q"][..., :8, :]
    np.testing.assert_allclose(got["short"].numpy(), tattn.sdpa_xla(short, short, short).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model", ["denoise", "vae"])
def test_sp_steps_equal_one_process_on_the_global_batch(cluster, model):
    result = cluster[0]
    got, ref = result[model]["sp"], result["one_process"][model]
    assert got["count"] == ref["count"]
    gan = model == "vae"
    res = compare(got["params"], ref["params"], got["grads"], ref["grads"], worker.LR, "sp", gan)
    assert res["sp_param_excess"] <= 0.0
    assert (res["sp_grad_excess"] <= 0.0) if gan else (res["sp_grad"] <= PARAM_GRAD_TOL)
    if gan:
        res = compare(got["disc_params"], ref["disc_params"], got["disc_grads"],
                      ref["disc_grads"], worker.VAE_STEP["disc_lr"], "d", gan)
        assert res["d_param_excess"] <= 0.0 and res["d_grad_excess"] <= 0.0


@pytest.mark.parametrize("model", ["denoise", "vae"])
def test_sp_steps_match_jax_on_the_global_batch(cluster, model):
    result, want, _ = cluster
    got, want = result[model]["sp"], want[model]
    assert got["count"] == want["count"]
    rtol, atol_of = GRAD_TOLS["denoise" if model == "denoise" else "gan"]
    _assert_grads_close(got["grads"], want["grads"], rtol, atol_of, "G")
    if model == "denoise":
        assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)
        return
    _assert_grads_close(got["disc_grads"], want["disc_grads"], rtol, atol_of, "D")
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=GAN_LOSS_TOL, abs=1e-12), k


@pytest.mark.parametrize("run", ["ddpm_sp", "vae_sp"])
def test_train_under_sequence_parallel_writes_a_run_jax_loads(cluster, run):
    check_run_loads_in_jax(cluster[0]["train"][run], run)


@pytest.mark.parametrize("run", ["ddpm_sp", "vae_sp"])
def test_train_under_sequence_parallel_tunes_the_micro_batch(cluster, run):
    """Sequence parallelism keeps every parameter whole, so ``train()``
    runs its start-up trial as one process does."""
    assert cluster[0]["train"][run]["trials"] == 1
