"""K1's backward on the CPU: the plan the wrapper hands the CUDA kernels, and
their closed form and order of summation emulated in numpy.

The plan (``fmdm_tpu_torch.ops.kernels.group_norm.backward_plan``) is pure
Python: these tests hold it, at every K1 call shape of the train paths, to
what ``gn_bwd_cluster`` and the split in ``csrc/group_norm.cu`` need (chunks
that tile the group, x's and dy's chunks and the sums' tables within a
block's shared memory, the cluster's size limit, the items and channels a
chunk meets). The kernels run only on the card
(``tests/test_torch_group_norm_backward_card.py``); their order of summation
(the statistics as the forward's, each warp's items, a channel's items in
order, the slots in order, the CTAs' partials in rank order, the samples in
order) is emulated here and held against the plain backward's autograd and
the JAX package's ``_fused_bwd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmdm_tpu.ops.pallas.group_norm import _fused_bwd
from fmdm_tpu_torch.ops.kernels import group_norm, group_norm_report
from fmdm_tpu_torch.ops.kernels.group_norm import (
    _STATIC_SMEM, ITEM_ELEMENTS, ITEM_VECTORS, K1B, MAX_PIECES, PORTABLE_CLUSTER, SMEM_PER_BLOCK,
    THREADS, WIDE_CLUSTER, backward_plan, backward_split_plan, group_norm_act_backward_reference)
from test_torch_group_norm_cluster import (
    FLAGSHIP_CALLS, GROUPS, VAE_CALLS, _chunk_partials, _warp_sum_lane0)

# K1 calls of one forward of the 3D EfficientUNet (scripts/bench_3d.py's
# widths) per sample, G = 32: (channels, spatial, FiLM, calls); recorded
# from the full-width model
VOLUME_CALLS = (((192, (8, 128, 128), False, 1), (128, (8, 128, 128), False, 2),
                 (64, (8, 128, 128), False, 2), (64, (8, 128, 128), True, 5),
                 (384, (4, 64, 64), False, 1), (256, (4, 64, 64), False, 1),
                 (192, (4, 64, 64), False, 1), (128, (4, 64, 64), True, 5),
                 (128, (4, 64, 64), False, 1), (64, (4, 64, 64), False, 1),
                 (512, (2, 32, 32), False, 2), (384, (2, 32, 32), False, 1),
                 (256, (2, 32, 32), True, 7), (256, (2, 32, 32), False, 3),
                 (128, (2, 32, 32), False, 1)))
# (channels, hw) of the train paths' calls with (batch, bytes per element):
# the flagship's bf16 step at batch 16, the volume's at batch 4, the VAE's f32
# step at batch 4
TRAIN_PATHS = (([(c, s * s) for c, s, _ in FLAGSHIP_CALLS], 16, 2),
               ([(c, int(np.prod(sp))) for c, sp, _, _ in VOLUME_CALLS], 4, 2),
               ([(c, s * s) for c, s, _ in VAE_CALLS], 4, 4))
TRAIN_SHAPES = sorted({(c, hw, batch, es) for calls, batch, es in TRAIN_PATHS
                       for c, hw in calls})
LARGEST_VOLUME_GROUP = 786_432


def test_volume_table_is_the_3d_models_calls():
    """34 calls per 3D forward, 17 with FiLM; its largest group is 786,432
    elements."""
    assert sum(n for *_, n in VOLUME_CALLS) == 34
    assert sum(n for _, _, film, n in VOLUME_CALLS if film) == 17
    assert max(c // GROUPS * int(np.prod(sp)) for c, sp, _, _ in VOLUME_CALLS) \
        == LARGEST_VOLUME_GROUP


def _brute_meets(group_size, hw, chunk, ctas, item):
    """Items and channels per chunk by enumerating its elements."""
    items = slots = 0
    for r in range(ctas):
        e = np.arange(r * chunk, min((r + 1) * chunk, group_size))
        if e.size:
            slots = max(slots, np.unique(e // hw).size)
            items = max(items, np.unique((e // hw) * hw + (e % hw) // item * item).size)
    return items, slots


def _check_single_pass(p, group_size, hw, es, max_cluster):
    unit = 16 // es
    assert p.single_pass and p.vec and 1 <= p.ctas <= max_cluster
    # the CTAs' chunks tile the group exactly, none empty
    assert (p.ctas - 1) * p.chunk < group_size <= p.ctas * p.chunk
    assert p.chunk % unit == 0 and p.item % unit == 0 and hw % unit == 0
    assert p.piece % (THREADS * unit) == 0
    for r in range(p.ctas):
        length = min(p.chunk, group_size - r * p.chunk)
        pieces = [min(p.piece, length - s) for s in range(0, length, p.piece)]
        assert sum(pieces) == length and len(pieces) <= MAX_PIECES
        assert all(n > 0 and n * es % 16 == 0 for n in pieces)
    # x's chunk and the tables in one block's shared memory
    assert p.chunk * es + 8 * p.items + 24 * p.slots <= p.smem
    assert p.smem <= SMEM_PER_BLOCK - _STATIC_SMEM and p.smem % 16 == 0


@pytest.mark.parametrize("max_cluster", [PORTABLE_CLUSTER, WIDE_CLUSTER])
@pytest.mark.parametrize("c,hw,batch,es", TRAIN_SHAPES)
def test_backward_plan_tiles_every_train_path_group(c, hw, batch, es, max_cluster):
    group_size = c // GROUPS * hw
    p = backward_plan(group_size, hw, es, True, batch * GROUPS, max_cluster=max_cluster)
    if es == 2 and max_cluster == WIDE_CLUSTER:
        # every bf16 call of the flagship's and the volume's steps is one
        # single-pass launch where the card schedules 16-CTA clusters
        assert p.single_pass
    assert (p.items, p.slots) == _brute_meets(group_size, hw, p.chunk, p.ctas, p.item)
    if p.single_pass:
        _check_single_pass(p, group_size, hw, es, max_cluster)
    else:
        assert (p.ctas - 1) * p.chunk < group_size <= p.ctas * p.chunk
        assert p.chunk % (16 // es) == 0 and p.smem <= SMEM_PER_BLOCK - _STATIC_SMEM


def test_backward_plan_at_the_largest_groups():
    # the volume's 786,432-element bf16 group: 16 CTAs of 96 KB of x, or 8
    # portable ones of 192 KB
    p = backward_plan(LARGEST_VOLUME_GROUP, 8 * 128 * 128, 2, True, 128,
                      max_cluster=WIDE_CLUSTER)
    assert (p.single_pass, p.ctas, p.chunk) == (True, 16, 49_152)
    p = backward_plan(LARGEST_VOLUME_GROUP, 8 * 128 * 128, 2, True, 128)
    assert (p.single_pass, p.ctas, p.chunk) == (True, 8, 98_304)
    # the flagship's 1 MB bf16 group: 16 CTAs of 64 KB
    p = backward_plan(8 * 256 * 256, 256 * 256, 2, True, 512, max_cluster=WIDE_CLUSTER)
    assert (p.single_pass, p.ctas, p.chunk) == (True, 16, 32_768)
    # a 512 KB bf16 group: 16 CTAs of 32 KB, or 8 portable ones of 64 KB
    assert backward_plan(4 * 256 * 256, 256 * 256, 2, True, 512,
                         max_cluster=WIDE_CLUSTER).ctas == 16
    assert backward_plan(4 * 256 * 256, 256 * 256, 2, True, 512).ctas == 8
    # the VAE's 2 MB f32 group: 16 CTAs of 128 KB of x; no portable cluster
    # holds it, so there it takes the split
    p = backward_plan(8 * 256 * 256, 256 * 256, 4, True, 128, max_cluster=WIDE_CLUSTER)
    assert (p.single_pass, p.ctas, p.chunk) == (True, 16, 32_768)
    p = backward_plan(8 * 256 * 256, 256 * 256, 4, True, 128)
    assert p == backward_split_plan(8 * 256 * 256, 256 * 256, 4, True, 128)
    assert not p.single_pass and p.ctas == 5
    # a 2 KB group (512 channels at 8x8): one CTA, one item per channel
    p = backward_plan(16 * 64, 64, 2, True, 512)
    assert (p.ctas, p.items, p.slots) == (1, 16, 16)


@pytest.mark.parametrize("shape,es", [((3, 96, 7, 7), 4), ((3, 96, 7, 7), 2),
                                      ((2, 128, 128, 128), 4)])
def test_backward_plan_without_vectors(shape, es):
    """7x7 (no whole vector per channel) or an unaligned x: one element per
    load, the chunks still in shared memory."""
    hw = shape[2] * shape[3]
    group_size = shape[1] // GROUPS * hw
    p = backward_plan(group_size, hw, es, False, shape[0] * GROUPS)
    assert p.single_pass and not p.vec and p.piece == p.chunk and p.item == ITEM_ELEMENTS
    assert (p.ctas - 1) * p.chunk < group_size <= p.ctas * p.chunk
    assert (p.items, p.slots) == _brute_meets(group_size, hw, p.chunk, p.ctas, p.item)
    assert p.chunk * es <= p.smem <= SMEM_PER_BLOCK - _STATIC_SMEM


@pytest.mark.parametrize("shape", group_norm_report.BACKWARD_SHAPES)
def test_backward_report_candidates_are_valid_plans(shape):
    """Every plan the report times for the backward (its grid of chunk
    targets, cluster limits and pieces, and the split) is one the kernels
    take."""
    n, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    group_size = c // GROUPS * hw
    split = backward_split_plan(group_size, hw, 2, True, n * GROUPS)
    assert not split.single_pass and (split.ctas - 1) * split.chunk < group_size
    for target in group_norm_report.CHUNK_TARGETS:
        for max_cluster in (PORTABLE_CLUSTER, WIDE_CLUSTER):
            for pieces in group_norm_report.PIECES:
                p = backward_plan(group_size, hw, 2, True, n * GROUPS, max_cluster=max_cluster,
                                  chunk_bytes=target, pieces=pieces)
                if p.single_pass:
                    _check_single_pass(p, group_size, hw, 2, max_cluster)
                else:
                    assert p == backward_split_plan(group_size, hw, 2, True, n * GROUPS)


def test_backward_split_items_stay_few():
    """A split chunk of a large group meets at most about 2048 items."""
    p = backward_split_plan(64 * 256 * 256, 256 * 256, 4, True, 1024)
    assert p.chunk == 64 * 256 * 256 and p.item > ITEM_VECTORS * 4
    assert p.items <= 2048 + 2 * p.slots
    assert (p.items, p.slots) == _brute_meets(64 * 256 * 256, 256 * 256, p.chunk, p.ctas, p.item)


# ---- the kernels' closed form and order of summation, in numpy ----

F32 = np.float32


def _grad_z(v, g, mean, rstd, w, b, a, t, film, act):
    """grad_z: dz and xhat of each element, in f32."""
    xh = (v - mean) * rstd
    if not act:
        return g, xh
    z = xh * w + b
    if film:
        z = z * a + t
    s = F32(1) / (F32(1) + np.exp(-z))
    return g * (s * (F32(1) + z * (F32(1) - s))), xh


def _item_pair(xv, gv, mean, rstd, coef, film, act):
    """One warp's item: lane l takes vectors l, l+32, ... (rows of ``unit``
    elements, each summed in order), then the butterfly's lane 0."""
    unit = xv.shape[1]
    lanes_a, lanes_b = np.zeros(32, F32), np.zeros(32, F32)
    for start in range(0, len(xv), 32):
        rows = slice(start, start + 32)
        d, xh = _grad_z(xv[rows], gv[rows], mean, rstd, *coef, film, act)
        k = d.shape[0]
        for e in range(unit):
            lanes_a[:k] += d[:, e]
            lanes_b[:k] += d[:, e] * xh[:, e]
    return _warp_sum_lane0(lanes_a), _warp_sum_lane0(lanes_b)


def _split_sum(pairs):
    """split_sum: lane l adds pairs l, l+32, ...; then the butterfly."""
    lanes = np.zeros((32, 2), F32)
    for i, pr in enumerate(pairs):
        lanes[i % 32] += np.asarray(pr, F32)
    return _warp_sum_lane0(lanes[:, 0]), _warp_sum_lane0(lanes[:, 1])


def _rank_order(pairs):
    a = b = F32(0)
    for pa, pb in pairs:
        a, b = F32(a + pa), F32(b + pb)
    return a, b


def emulate_backward(x, dy, w, b, scale, shift, p, eps, act, es=4):
    """K1's backward under plan ``p`` (single pass or split) for f32 values
    held in ``es``-byte elements: (dx, dweight, dbias, dscale, dshift) in
    f32, None for FiLM's without it."""
    n, c = x.shape[:2]
    cg = c // GROUPS
    hw = x[0, 0].size
    unit = 16 // es if p.vec else 1
    film = scale is not None
    a_all = (F32(1) + scale) if film else np.ones((n, c), F32)
    t_all = shift if film else np.zeros((n, c), F32)
    xg, gg = x.reshape(n, GROUPS, -1), dy.reshape(n, GROUPS, -1)
    group_size = xg.shape[2]
    m = F32(group_size)
    dx = np.empty_like(xg)
    sums = np.zeros((n, c, 2), F32)
    per_channel = -(-hw // p.item)
    for i in range(n):
        for g in range(GROUPS):
            xs, gs = xg[i, g], gg[i, g]
            chunks = [(r * p.chunk, min((r + 1) * p.chunk, group_size)) for r in range(p.ctas)]
            if p.single_pass:
                stats = _rank_order([_chunk_partials(xs[lo:hi], unit) for lo, hi in chunks])
            else:  # gn_bwd_moments: one strided pass per chunk, no pieces
                stats = _split_sum([_chunk_partials(xs[lo:hi], unit) for lo, hi in chunks])
            mean = F32(stats[0] / m)
            var = max(F32(F32(stats[1] / m) - F32(mean * mean)), F32(0))
            rstd = F32(1) / np.sqrt(F32(var + F32(eps)), dtype=F32)
            coef = [(w[c0], b[c0], a_all[i, c0], t_all[i, c0])
                    for c0 in range(g * cg, (g + 1) * cg)]
            slots, partials = [], []
            for lo, hi in chunks:  # each CTA: its items, slots, (S1, S2) partial
                first, last = lo // hw, (hi - 1) // hw
                items = {}
                for j in range(first * per_channel + lo % hw // p.item,
                               last * per_channel + (hi - 1) % hw // p.item + 1):
                    cl, k = divmod(j, per_channel)
                    a0 = max(cl * hw + k * p.item, lo)
                    a1 = min(cl * hw + (k + 1) * p.item, (cl + 1) * hw, hi)
                    items[j] = (cl, _item_pair(xs[a0:a1].reshape(-1, unit),
                                               gs[a0:a1].reshape(-1, unit), mean, rstd,
                                               coef[cl], film, act))
                mine = {cl: _rank_order([pr for j, (c1, pr) in sorted(items.items()) if c1 == cl])
                        for cl in range(first, last + 1)}
                s1 = s2 = F32(0)
                for cl in range(first, last + 1):
                    aw = F32(coef[cl][2] * coef[cl][0])
                    s1, s2 = F32(s1 + aw * mine[cl][0]), F32(s2 + aw * mine[cl][1])
                slots.append(mine)
                partials.append((s1, s2))
            s1, s2 = _rank_order(partials) if p.single_pass else _split_sum(partials)
            m1, m2 = F32(s1 / m), F32(s2 / m)
            for cl in range(cg):  # the owner adds the chunks meeting the channel in order
                sums[i, g * cg + cl] = _rank_order([s[cl] for s in slots if cl in s])
            for cl in range(cg):
                wc, _, ac, _ = coef[cl]
                seg = slice(cl * hw, (cl + 1) * hw)
                d, xh = _grad_z(xs[seg], gs[seg], mean, rstd, *coef[cl], film, act)
                dx[i, g, seg] = rstd * (F32(ac * wc) * d - m1 - xh * m2)
    dweight, dbias = np.zeros(c, F32), np.zeros(c, F32)
    for i in range(n):  # gn_bwd_params: the samples in order
        dweight = (dweight + a_all[i] * sums[i, :, 1]).astype(F32)
        dbias = (dbias + a_all[i] * sums[i, :, 0]).astype(F32)
    dscale = (w * sums[:, :, 1] + b * sums[:, :, 0]).astype(F32) if film else None
    dshift = sums[:, :, 0].copy() if film else None
    return dx.reshape(x.shape), dweight, dbias, dscale, dshift


def _inputs(shape, film, seed=7, bf16=False):
    rng = np.random.default_rng(seed)
    n, c = shape[:2]
    x = (rng.standard_normal(shape) * 1.5 + 0.5).astype(F32)
    dy = rng.standard_normal(shape).astype(F32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(F32)
    b = (0.1 * rng.standard_normal(c)).astype(F32)
    s = (0.2 * rng.standard_normal((n, c))).astype(F32) if film else None
    t = (0.2 * rng.standard_normal((n, c))).astype(F32) if film else None
    if bf16:  # the values a bf16 tensor holds
        x, dy, s, t = (None if a is None else torch.from_numpy(a).bfloat16().float().numpy()
                       for a in (x, dy, s, t))
    return x, dy, w, b, s, t


def _plain(arrays, act, dtype):
    x, dy, w, b, s, t = (None if a is None else torch.from_numpy(a) for a in arrays)
    if dtype == torch.bfloat16:
        x, dy, s, t = (None if a is None else a.bfloat16() for a in (x, dy, s, t))
    got = group_norm_act_backward_reference(dy, x, w, b, s, t, GROUPS, 1e-5, act)
    return [None if g is None else g.float().numpy() for g in got]


# jitted: op by op, JAX compiles each of the VJP's operations at each shape
_JAX_BWD = jax.jit(_fused_bwd, static_argnums=(0, 1, 2))


def _jax(arrays, act, dtype):
    x, dy, w, b, s, t = (None if a is None else jnp.asarray(a) for a in arrays)
    if dtype == jnp.bfloat16:
        x, dy, s, t = (None if a is None else a.astype(jnp.bfloat16) for a in (x, dy, s, t))
    got = _JAX_BWD(GROUPS, 1e-5, act, (x, w, b, s, t), dy)
    return [None if g is None else np.array(g.astype(jnp.float32)) for g in got]


NAMES = ("dx", "dweight", "dbias", "dscale", "dshift")
# f32 against the plain backward and JAX: the same sums in other orders, and
# the card's FMAs, against each gradient's largest magnitude
F32_TOL = 2e-5


def _close(got, want, tol, what):
    for name, g, r in zip(NAMES, got, want):
        if r is None:
            assert g is None, name
            continue
        err = float(np.abs(g - r).max()) / max(float(np.abs(r).max()), 1e-30)
        assert err <= tol, f"{what} {name}: {err:.3e} of the largest magnitude > {tol}"


CASES = [  # (shape, chunk_bytes, max_cluster, film, act, split)
    ((2, 64, 16, 16), 1024, PORTABLE_CLUSTER, True, True, False),    # 4 CTAs, FiLM
    ((1, 256, 16, 16), 4096, PORTABLE_CLUSTER, False, True, False),  # 4 CTAs, 2 channels each
    ((1, 64, 64, 64), 16384, PORTABLE_CLUSTER, True, False, False),  # 4 CTAs, items split a channel
    ((2, 96, 10, 10), 640, PORTABLE_CLUSTER, True, True, False),     # ragged; bf16 unvectorized
    ((1, 128, 32, 32), 1024, WIDE_CLUSTER, False, False, False),     # 16 CTAs
    ((1, 160, 48, 48), None, None, True, True, True),                # the split, mid-channel
]


def _plan(shape, chunk_bytes, max_cluster, split, es=4):
    """The plan at ``es`` bytes per element (chunks of as many elements as
    at f32), with vectors where a channel is a whole number of them."""
    n, c = shape[:2]
    hw = shape[2] * shape[3]
    group_size = c // GROUPS * hw
    vec = hw % (16 // es) == 0
    if split:
        p = backward_split_plan(group_size, hw, es, vec, n * GROUPS)
        assert not p.single_pass and p.ctas > 1
        return p
    p = backward_plan(group_size, hw, es, vec, n * GROUPS, max_cluster=max_cluster,
                      chunk_bytes=chunk_bytes * es // 4)
    assert p.single_pass and p.ctas > 1
    return p


@pytest.mark.parametrize("shape,chunk_bytes,max_cluster,film,act,split", CASES)
def test_backward_summation_order_matches_plain_and_jax_f32(shape, chunk_bytes, max_cluster,
                                                            film, act, split):
    """At small shapes with chunks forced small, so that a group spans a real
    cluster (or split): the emulated kernels against the plain backward's
    autograd and JAX's ``_fused_bwd`` in f32."""
    arrays = _inputs(shape, film)
    p = _plan(shape, chunk_bytes, max_cluster, split)
    got = emulate_backward(*arrays, p, 1e-5, act)
    _close(got, _plain(arrays, act, torch.float32), F32_TOL, "plain")
    _close(got, _jax(arrays, act, jnp.float32), F32_TOL, "JAX")


def _bf16(a):
    return None if a is None else torch.from_numpy(a).bfloat16().float().numpy()


def _within_one_ulp(got, want, floor):
    """bf16 values at most one ulp of ``want`` apart, or within ``floor``
    (the f32 sums' difference at the tensor's scale) near zero."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got - want) <= np.maximum(ulp, floor)


@pytest.mark.parametrize("shape,chunk_bytes,max_cluster,film,act,split",
                         [c for c in CASES if c[3] or c[4]])
def test_backward_summation_order_matches_plain_and_jax_bf16(shape, chunk_bytes, max_cluster,
                                                             film, act, split):
    """bf16 x, dy, scale and shift, f32 weights: the emulation rounds dx,
    dscale and dshift once to bf16. They agree to one bf16 ulp with the plain
    backward and JAX's ``_fused_bwd`` evaluated in f32 on the same values and
    rounded once. The plain backward run in bf16 rounds x's gradient three
    times (one per ``x.float()`` of the plain forward: the normalized value,
    the sum, the sum of squares) and adds the three in bf16; the one rounding
    is nearer the f32 gradient than that."""
    arrays = _inputs(shape, film, bf16=True)
    p = _plan(shape, chunk_bytes, max_cluster, split, es=2)
    got = emulate_backward(*arrays, p, 1e-5, act, es=2)
    got = [_bf16(got[0]), got[1], got[2], _bf16(got[3]), _bf16(got[4])]
    for what, want in (("plain", _plain(arrays, act, torch.float32)),
                       ("JAX", _jax(arrays, act, jnp.float32))):
        for name, g, r in zip(NAMES, got, want):
            if r is None:
                continue
            floor = F32_TOL * float(np.abs(r).max())
            if name in ("dweight", "dbias"):
                assert np.abs(g - r).max() <= floor, f"{what} {name}"
            else:
                assert _within_one_ulp(g, _bf16(r), floor).all(), f"{what} {name}"
    truth = _plain(arrays, act, torch.float32)[0]
    plain_bf16 = _plain(arrays, act, torch.bfloat16)[0]
    assert np.abs(got[0] - truth).max() <= np.abs(plain_bf16 - truth).max()


def test_cpu_backward_takes_the_plain_version(monkeypatch):
    """On CPU tensors _GroupNormAct's backward is the plain one and launches
    nothing; its gradients are the plain autograd's."""
    monkeypatch.setattr(group_norm, "_launch", lambda x, w, b, s, t, g, eps, act:
                        group_norm.group_norm_act_reference(x, w, b, num_groups=g, eps=eps,
                                                            act=act, scale=s, shift=t))
    x, dy, w, b, s, t = (torch.from_numpy(a) for a in _inputs((2, 64, 8, 8), True))
    leaves = [v.clone().requires_grad_(True) for v in (x, w, b, s, t)]
    K1B.reset()
    group_norm._GroupNormAct.apply(*leaves, GROUPS, 1e-5, True).backward(dy)
    assert K1B.launches == 0 and K1B.variants == {"single_pass": 0, "split": 0}
    want = group_norm_act_backward_reference(dy, x, w, b, s, t, GROUPS, 1e-5, True)
    for leaf, g in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)
