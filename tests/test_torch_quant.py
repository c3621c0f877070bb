"""The port's post-training int8 (W8A8) inference against the JAX package's
(``ops/quant.py``, ``utils/quantize.py``, ``run_model --quantize``), on the
CPU with the same numpy-seeded inputs and carried-across weights; the
counterpart of ``tests/test_int8_quant.py``.

Tolerances: weight and activation quantization bitwise; the int8 conv's
and ``linear_qdq``'s int32 accumulators bitwise (exact integer sums) and
their dequantized outputs within 1e-6 relative (the same f32 products); the
policy's chosen paths equal, its int8 weights and weight scales bitwise and
its activation scales within 1e-5 relative (the calibration forwards agree
to f32 rounding); a 4-step int8 DDIM decode, the port's own calibration and
JAX's scales carried across, at an SNR of 45 dB or more against JAX's
jitted decode (see ``DECODE_SNR_DB``).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxFactory
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.ops import conv as jconv
from fmdm_tpu.ops import quant as jquant
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.utils.quantize import quantize_model_params
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn import layers as tlayers
from fmdm_tpu_torch.ops import conv as tconv
from fmdm_tpu_torch.ops import quant as tquant
from fmdm_tpu_torch.sample import diffusion_utils as tdu
from fmdm_tpu_torch.utils.quantize import quantize_model
from fmdm_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_models import random_flat_params


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _snr_db(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(8, 4, 3, 3), (5, 3, 7), (6, 2, 3, 3, 3), (12, 7)],
                         ids=["conv2d", "conv1d", "conv3d", "linear"])
def test_weight_and_activation_quantization_are_bitwise_jax(shape):
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[1] = 0.0                                   # an all-zero channel: scale 1.0
    w[2].flat[0] = 0.5 * np.abs(w[2]).max()      # values at exact half steps
    jq, js = jquant.quantize_conv_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_conv_weight(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1]) == 1.0
    x = rng.standard_normal((3, 40)).astype(np.float32) * 5
    x[0, :5] = [0.5, 1.5, 2.5, -0.5, -2.5]        # ties round half to even
    for absmax in (float(np.abs(x).max()), 2.0, 1e-12):
        j = jquant.make_quantized(jnp.asarray(w), absmax)
        t = tquant.make_quantized(_t(w), absmax)
        assert t.act_scale.dtype == torch.float32 and t.act_scale.dim() == 0
        assert float(t.act_scale) == float(j.act_scale)
        np.testing.assert_array_equal(
            tquant.quantize_activation(_t(x), t.act_scale).numpy(),
            np.asarray(jquant.quantize_activation(jnp.asarray(x), j.act_scale)))
    one = tquant.quantize_activation(_t(x), torch.tensor(1.0))
    assert one[0, :5].tolist() == [0, 2, 2, 0, -2]


CONV_CASES = {
    "1d_stride": (1, 8, 12, 3, dict(stride=2, padding=1, dilation=1, groups=1)),
    "2d_same": (2, 16, 8, 3, dict(stride=1, padding=1, dilation=1, groups=1)),
    "2d_dilated_stride": (2, 8, 16, 3, dict(stride=2, padding=2, dilation=2, groups=1)),
    "2d_groups": (2, 8, 12, 3, dict(stride=1, padding=0, dilation=1, groups=4)),
    "2d_k4_s2": (2, 6, 10, 4, dict(stride=2, padding=1, dilation=1, groups=1)),
    "3d_dilated": (3, 4, 8, 3, dict(stride=1, padding=1, dilation=2, groups=1)),
    "3d_groups_stride": (3, 6, 6, 2, dict(stride=2, padding=0, dilation=1, groups=2)),
    # shapes _int_mm's CUDA rules miss, padded: 3 input channels (K = 27),
    # 5 outputs, 9 output rows
    "padded_small": (2, 3, 5, 3, dict(stride=2, padding=0, dilation=1, groups=1)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_matches_jax(case):
    nd, cin, cout, k, kw = CONV_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    side = 7 if case == "padded_small" else 9
    x = rng.standard_normal((1 if case == "padded_small" else 2, cin) + (side,) * nd
                            ).astype(np.float32)
    w = (rng.standard_normal((cout, cin // kw["groups"]) + (k,) * nd) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    absmax = float(np.abs(x).max())
    jw, tw = jquant.make_quantized(jnp.asarray(w), absmax), tquant.make_quantized(_t(w), absmax)

    xq = tquant.quantize_activation(_t(x), tw.act_scale)
    got_acc = tquant.int8_conv_accumulate(xq, tw.qweight, stride=(kw["stride"],) * nd,
                                          padding=(kw["padding"],) * nd,
                                          dilation=(kw["dilation"],) * nd, groups=kw["groups"])
    want_acc = lax.conv_general_dilated(
        jquant.quantize_activation(jnp.asarray(x), jw.act_scale), jw.qweight,
        window_strides=(kw["stride"],) * nd, padding=[(kw["padding"],) * 2] * nd,
        rhs_dilation=(kw["dilation"],) * nd, feature_group_count=kw["groups"],
        dimension_numbers=jconv._dim_numbers(nd), preferred_element_type=jnp.int32)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))

    got = tconv.conv_nd(_t(x), tw, _t(b), **kw)
    want = np.asarray(jconv.conv_nd(jnp.asarray(x), jw, jnp.asarray(b), **kw))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-6
    ref = tconv.conv_nd(_t(x), _t(w), _t(b), **kw).numpy()
    assert _snr_db(ref, got.numpy()) > 25.0


@pytest.mark.parametrize("m,k,n", [(5, 13, 3), (17, 8, 8), (40, 27, 10), (1, 1, 1)])
def test_int8_matmul_pads_shapes_the_card_refuses(m, k, n):
    rng = np.random.default_rng(m * k * n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = tquant.int8_matmul(_t(a), _t(b).t())
    assert got.shape == (m, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("lead", [(3,), (2, 33), (2, 4, 5)], ids=["rows", "tokens", "3d"])
def test_linear_qdq_matches_jax(lead):
    rng = np.random.default_rng(len(lead))
    x = rng.standard_normal(lead + (20,)).astype(np.float32)
    w = (rng.standard_normal((12, 20)) * 0.3).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    absmax = float(np.abs(x).max()) * 0.8       # some activations clip
    jw = jquant.make_quantized_linear(jnp.asarray(w), absmax)
    tw = tquant.make_quantized_linear(_t(w), absmax)
    got = tquant.linear_qdq(_t(x), tw)
    want = np.asarray(jquant.linear_qdq(jnp.asarray(x), jw))
    np.testing.assert_array_equal(got.numpy(), want)
    from fmdm_tpu.nn.layers import linear_nd as jlinear

    layer = tlayers.Linear(20, 12, device="cpu")
    del layer.weight
    layer.weight = tw
    layer.bias = torch.nn.Parameter(_t(b))
    assert _rel(layer(_t(x)).detach().numpy(),
                jlinear(jnp.asarray(x), jw, jnp.asarray(b))) <= 1e-6


# the flagship's topology cut to three levels at 32²: 64 channels at 32²
# (where the default policy quantizes) and 16², 128 at 8², attention at 16²
SMALL_FLAGSHIP = {
    "unet_impl": "diffusers_nd", "sample_size": 32, "in_channels": 1, "out_channels": 1,
    "layers_per_block": 1, "norm_num_groups": 8, "block_out_channels": [64, 64, 128],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "AttnUpBlock2D", "UpBlock2D"],
}


@pytest.fixture(scope="module")
def flagship_pair():
    jm = JaxFactory().build(SMALL_FLAGSHIP, conditioning="concatenate", channels=1)
    flat = random_flat_params(jm, 21)
    tm = load_jax_params(DiffusionUNetFactory().build(SMALL_FLAGSHIP, "concatenate", 1,
                                                      device="cpu"), flat)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    t = np.array([30, 900], np.int32)
    return jm, unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), tm, x, t


def _jax_quantized_leaves(qtree):
    return {name: v for name, v in flatten_params(qtree).items()
            if isinstance(v, (jquant.QuantizedConvWeight, jquant.QuantizedLinearWeight))}


@pytest.mark.parametrize("policy", [
    {},
    {"quantize_linear": True},
    {"quantize_linear": True, "linear_min_tokens": 512, "linear_min_features": 64},
    {"min_hw": 16, "min_channels": 32, "skip_paths": ("conv_in", "conv_out", "up_blocks.2")},
], ids=["default", "linear_gated_off", "attention_linears", "knobs"])
def test_policy_picks_the_jax_paths(flagship_pair, policy):
    jm, params, tm, x, t = flagship_pair
    qtree = quantize_model_params(lambda p, xi, ti: jm(p, xi, ti), params,
                                  [(jnp.asarray(x), jnp.asarray(t))], **policy)
    want = _jax_quantized_leaves(qtree)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    qm = quantize_model(tm, [(_t(x), _t(t))], device="cpu", **policy)
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())  # a copy
    assert not tquant.is_quantized(tm) and tquant.is_quantized(qm)
    assert sorted(tquant.quantized_paths(qm)) == sorted(want)
    for name, jw in want.items():
        tw = qm.get_submodule(name)
        assert type(tw).__name__ == type(jw).__name__
        np.testing.assert_array_equal(tw.qweight.numpy(), np.asarray(jw.qweight))
        np.testing.assert_array_equal(tw.wscale.numpy(), np.asarray(jw.wscale))
        assert float(tw.act_scale) == pytest.approx(float(jw.act_scale), rel=1e-5)
    linears = [n for n, v in want.items() if isinstance(v, jquant.QuantizedLinearWeight)]
    assert bool(linears) == (policy.get("linear_min_features") == 64)
    # JAX's quantized tree carried across quantizes the same modules
    shared = load_jax_params(copy.deepcopy(tm), flatten_params(qtree))
    assert sorted(tquant.quantized_paths(shared)) == sorted(want)


def test_policy_refusals_raise_jax_value_errors(flagship_pair):
    _, _, tm, x, t = flagship_pair
    with pytest.raises(ValueError, match="policy quantized 0"):
        quantize_model(tm, [(_t(x), _t(t))], min_hw=4096, device="cpu")
    with pytest.raises(ValueError, match="recorded no conv calls"):
        quantize_model(torch.nn.Linear(4, 4), [(torch.zeros(2, 4),)], device="cpu")


def test_scales_survive_a_dtype_cast(flagship_pair):
    _, _, tm, x, t = flagship_pair
    qm = quantize_model(tm, [(_t(x), _t(t))], device="cpu")
    name = tquant.quantized_paths(qm)[0]
    scales = {k: getattr(qm.get_submodule(name), k).clone() for k in ("wscale", "act_scale")}
    cast = copy.deepcopy(qm).to(dtype=torch.bfloat16)
    q = cast.get_submodule(name)
    assert q.qweight.dtype == torch.int8
    assert q.wscale.dtype == q.act_scale.dtype == torch.float32
    assert all(torch.equal(getattr(q, k), v) for k, v in scales.items())
    owner = cast.get_submodule(name.rpartition(".")[0])
    assert owner.bias.dtype == torch.bfloat16
    y = cast(_t(x).bfloat16(), _t(t))
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y.float()).all())


# the JAX test's tiny unconditional UNet
UNET = {
    "unet_impl": "diffusers_nd", "sample_size": 32, "in_channels": 1, "out_channels": 1,
    "layers_per_block": 1, "norm_num_groups": 8, "block_out_channels": [64, 64],
    "down_block_types": ["DownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "UpBlock2D"],
}
TRAINING = {"num_train_timesteps": 20}
# JAX's jitted int8 forward differs from its own eager forward (which the
# port's matches to 1e-6 relative at the same scales) by ~38 dB on a reduced
# flagship, its float forwards by ~124 dB: XLA's fusion rounds some
# activations to the other int8 step. So a decode is held to an SNR: ~51 dB
# measured against the jitted decode, where int8 against float is ~48 dB.
DECODE_SNR_DB = 45.0
MODEL_CFG = {"scheduler": {"name": "ddim"}}
SHAPE = (2, 1, 32, 32)


@pytest.fixture(scope="module")
def tiny_pair():
    jm = JaxFactory().build(UNET, conditioning=None, channels=1)
    flat = random_flat_params(jm, 31)
    tm = load_jax_params(DiffusionUNetFactory().build(UNET, None, 1, device="cpu"), flat)
    return jm, unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), tm


@pytest.fixture
def clean_quantize(monkeypatch):
    monkeypatch.setattr(jdu, "_DP_SAMPLING", False)
    monkeypatch.setattr(jdu, "_QUANT_CACHE", {})
    monkeypatch.setattr(tdu, "_QUANT_CACHE", {})
    yield
    for du in (jdu, tdu):
        du.set_quantize(None)
        du.set_deep_cache(None)


def _jax_decode(jm, params, key):
    return np.asarray(jdu.decode_diffusion_batch(jm, params, TRAINING, MODEL_CFG, SHAPE, rng=key,
                                                 num_inference_steps=4))


def _start_noise(key):
    _, k_sample = jax.random.split(key)
    k_init, _ = jax.random.split(k_sample)
    return torch.from_numpy(np.array(jax.random.normal(k_init, SHAPE, jnp.float32)))


def _port_decode(model, key):
    return tdu.decode_diffusion_batch(model, TRAINING, MODEL_CFG, SHAPE, init_noise=_start_noise(key),
                                      num_inference_steps=4, device="cpu").numpy()


@pytest.mark.parametrize("mode", ["int8", "int8+linear"])
def test_quantized_decode_matches_jax(tiny_pair, clean_quantize, mode):
    jm, params, tm = tiny_pair
    key = jax.random.PRNGKey(7)
    ref = _jax_decode(jm, params, key)
    float_port = _port_decode(tm, key)
    jdu.set_quantize(mode)
    tdu.set_quantize(mode)
    want = _jax_decode(jm, params, key)
    (_, _, qtree), = jdu._QUANT_CACHE.values()
    got = _port_decode(tm, key)
    (model, qmodel), = tdu._QUANT_CACHE.values()
    assert model is tm and qmodel is not tm and tquant.is_quantized(qmodel)
    assert sorted(tquant.quantized_paths(qmodel)) == sorted(_jax_quantized_leaves(qtree))
    assert np.isfinite(got).all() and not np.array_equal(got, float_port)
    assert _snr_db(ref, got) > 10.0
    # the port's own calibration, and then JAX's scales carried across
    assert _snr_db(want, got) > DECODE_SNR_DB
    tdu.set_quantize(None)
    shared = load_jax_params(copy.deepcopy(tm), flatten_params(qtree))
    assert _snr_db(want, _port_decode(shared, key)) > DECODE_SNR_DB
    # the second call with the same model is served from the cache
    tdu.set_quantize(mode)
    np.testing.assert_array_equal(_port_decode(tm, key), got)
    assert len(tdu._QUANT_CACHE) == 1


def test_quant_cache_identity_check_and_cap(tiny_pair, clean_quantize):
    _, _, tm = tiny_pair
    key = jax.random.PRNGKey(13)
    tdu.set_quantize("int8")
    out = _port_decode(tm, key)
    ((cache_key, entry),) = tdu._QUANT_CACHE.items()
    assert entry[0] is tm                       # a strong reference
    assert cache_key[2][0] == "DDIMScheduler" and cache_key[2][-2] == "int8"
    # a stale entry under the exact key (an id reused after collection) is a miss
    tdu._QUANT_CACHE[cache_key] = (object(), "stale")
    np.testing.assert_array_equal(_port_decode(tm, key), out)
    assert tdu._QUANT_CACHE[cache_key][0] is tm
    # another fingerprint (batch, mode) recalibrates into a new entry
    tdu.set_quantize("int8+linear")
    _port_decode(tm, key)
    assert len(tdu._QUANT_CACHE) == 2
    tdu.set_quantize("int8")
    for i in range(tdu._QUANT_CACHE_MAX + 2):
        other = copy.deepcopy(tm)
        _port_decode(other, key)
        assert len(tdu._QUANT_CACHE) <= tdu._QUANT_CACHE_MAX
    assert tm not in [e[0] for e in tdu._QUANT_CACHE.values()]   # FIFO evicted the first


def test_quantize_composes_with_deep_cache(tiny_pair, clean_quantize):
    jm, params, tm = tiny_pair
    key = jax.random.PRNGKey(9)
    ref = _port_decode(tm, key)
    tdu.set_quantize("int8")
    jdu.set_quantize("int8")
    q_only = _port_decode(tm, key)
    tdu.set_deep_cache((2, 1))
    jdu.set_deep_cache((2, 1))
    composed = _port_decode(tm, key)
    np.testing.assert_array_equal(_port_decode(tm, key), composed)
    assert np.isfinite(composed).all() and not np.array_equal(composed, q_only)
    assert _snr_db(ref, composed) > 8.0
    assert _snr_db(_jax_decode(jm, params, key), composed) > DECODE_SNR_DB


def test_the_fallback_is_only_the_policys_nothing_to_quantize(clean_quantize, caplog):
    """A model whose convs the policy keeps float decodes in float with JAX's
    warning; nothing else falls back."""
    small = dict(UNET, block_out_channels=[8, 8], norm_num_groups=4)
    model = tlayers.init_weights(DiffusionUNetFactory().build(small, None, 1, device="cpu"),
                                 torch.Generator().manual_seed(3))
    key = jax.random.PRNGKey(3)
    ref = _port_decode(model, key)
    tdu.set_quantize("int8")
    with caplog.at_level("WARNING"):
        out = _port_decode(model, key)
    assert "continuing with float weights" in caplog.text
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError):
        tdu.set_quantize("int4")
