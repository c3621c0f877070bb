"""K1's single-pass design on the CPU: the plan the wrapper hands the CUDA
kernel, and the kernel's order of summation emulated in numpy.

The plan (``fmdm_tpu_torch.ops.kernels.group_norm.plan``) is pure Python:
these tests hold it, at every K1 call shape of the two main paths, to what
``gn_cluster`` in ``csrc/group_norm.cu`` needs (chunks that tile the group,
16-byte bulk copies, a block's shared memory, the cluster's size limit). The
kernel itself runs only on the card (``chip_smoke.py`` [3] and [13]); its
order of summation (each thread's strided f32 sums, the warp and block
trees, then the R partials in rank order) is emulated here and held against
the plain version and the JAX package's XLA reference.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fmdm_tpu.ops.pallas.group_norm import _xla_reference
from fmdm_tpu_torch.ops.kernels import build
from fmdm_tpu_torch.ops.kernels.group_norm import (
    K1, MAX_PIECES, PORTABLE_CLUSTER, SMEM_PER_BLOCK, THREADS, WIDE_CLUSTER, group_norm_act,
    group_norm_act_reference, plan, split_plan)

GROUPS = 32
# K1 calls of one forward, per sample, G = 32: (channels, side, calls);
# recorded from the full-width models
FLAGSHIP_CALLS = ((256, 256, 3), (128, 256, 7), (384, 128, 1), (256, 128, 2), (128, 128, 7),
                  (512, 64, 2), (384, 64, 1), (256, 64, 6), (768, 32, 1), (128, 64, 1),
                  (512, 32, 2), (256, 32, 7), (1024, 16, 2), (768, 16, 1), (512, 16, 6),
                  (256, 16, 1), (1024, 8, 3), (512, 8, 11))
VAE_CALLS = ((256, 256, 1), (128, 256, 10), (512, 128, 1), (256, 128, 8), (128, 128, 1),
             (512, 64, 9), (256, 64, 1), (512, 32, 19))
# (table, batch, bytes per element): the flagship samples in bf16 at batch 8
# and 32, the VAE reconstructs in f32 at batch 4
PATHS = ((FLAGSHIP_CALLS, 8, 2), (FLAGSHIP_CALLS, 32, 2), (VAE_CALLS, 4, 4))
SHAPES = sorted({(c, side, batch, es) for calls, batch, es in PATHS for c, side, _ in calls})


def _group_size(c, side):
    return c // GROUPS * side * side


def test_tables_are_the_main_paths():
    """64 calls per flagship forward and 50 per VAE reconstruct, with the
    elements per sample that the bound per forward is computed from."""
    assert sum(n for *_, n in FLAGSHIP_CALLS) == 64
    assert sum(c * s * s * n for c, s, n in FLAGSHIP_CALLS) == 156_794_880
    assert sum(n for *_, n in VAE_CALLS) == 50
    assert sum(c * s * s * n for c, s, n in VAE_CALLS) == 174_587_904


def _check_single_pass(p, group_size, es, max_cluster):
    unit = 16 // es
    assert p.vec and 1 <= p.ctas <= max_cluster
    # the CTAs' chunks tile the group exactly, none empty
    assert (p.ctas - 1) * p.chunk < group_size <= p.ctas * p.chunk
    # every chunk and piece starts and ends on 16 bytes (groups do, as the
    # spatial size is a multiple of the vector)
    assert group_size % unit == 0 and p.chunk % unit == 0
    assert p.piece % (THREADS * unit) == 0
    for r in range(p.ctas):
        length = min(p.chunk, group_size - r * p.chunk)
        pieces = [min(p.piece, length - s) for s in range(0, length, p.piece)]
        assert sum(pieces) == length and len(pieces) <= MAX_PIECES
        assert all(n > 0 and n * es % 16 == 0 for n in pieces)
    assert p.chunk * es <= p.smem <= SMEM_PER_BLOCK and p.smem % 16 == 0


@pytest.mark.parametrize("max_cluster", [PORTABLE_CLUSTER, WIDE_CLUSTER])
@pytest.mark.parametrize("c,side,batch,es", SHAPES)
def test_plan_tiles_every_main_path_group(c, side, batch, es, max_cluster):
    group_size = _group_size(c, side)
    p = plan(group_size, es, True, batch * GROUPS, max_cluster=max_cluster)
    if es == 2:  # every flagship bf16 call is one single-pass launch
        assert p.single_pass
    if p.single_pass:
        _check_single_pass(p, group_size, es, max_cluster)
    else:
        assert (p.ctas - 1) * p.chunk < group_size <= p.ctas * p.chunk


def test_plan_picks_small_chunks_and_wide_clusters_only_where_needed():
    # a 512 KB bf16 group: 8 CTAs of 64 KB, portable
    p = plan(4 * 256 * 256, 2, True, 256)
    assert (p.single_pass, p.ctas, p.smem) == (True, 8, 64 * 1024)
    # a 1 MB bf16 group: 8 x 128 KB portable, 16 x 64 KB where 16 schedules
    assert plan(8 * 256 * 256, 2, True, 256).ctas == 8
    assert plan(8 * 256 * 256, 2, True, 256, max_cluster=WIDE_CLUSTER).ctas == 16
    # a 2 KB group: a cluster of one, one bulk copy
    p = plan(16 * 8 * 8, 2, True, 1024)
    assert (p.ctas, p.chunk, p.piece) == (1, 1024, THREADS * 8)


def test_vae_2mb_group_needs_a_wide_cluster_or_the_split():
    """The VAE decoder's (4,256,256,256) f32 call: 2 MB per group fits 16
    CTAs of 128 KB, and no portable cluster."""
    group_size = _group_size(256, 256)
    wide = plan(group_size, 4, True, 128, max_cluster=WIDE_CLUSTER)
    assert wide.single_pass and (wide.ctas, wide.smem) == (16, 128 * 1024)
    _check_single_pass(wide, group_size, 4, WIDE_CLUSTER)
    portable = plan(group_size, 4, True, 128, max_cluster=PORTABLE_CLUSTER)
    assert not portable.single_pass
    assert portable == split_plan(group_size, 4, True, 128)


@pytest.mark.parametrize("shape,es", [((3, 96, 7, 7), 4), ((3, 96, 7, 7), 2),
                                      ((2, 128, 128, 128), 4)])
def test_plan_without_vectors_holds_whole_chunks(shape, es):
    """7x7 (no whole vector per channel) or an unaligned x: one element per
    load, no bulk copy, the chunk still in shared memory."""
    group_size = shape[1] // GROUPS * shape[2] * shape[3]
    p = plan(group_size, es, False, shape[0] * GROUPS)
    assert p.single_pass and not p.vec and p.piece == p.chunk
    assert (p.ctas - 1) * p.chunk < group_size <= p.ctas * p.chunk
    assert p.chunk * es <= p.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("group_size,es,vec", [(4 * 256 * 256, 2, True), (3 * 49, 4, False),
                                               (8 * 256 * 256, 4, True)])
def test_split_plan_tiles_the_group(group_size, es, vec):
    p = split_plan(group_size, es, vec, 256)
    unit = 16 // es if vec else 1
    assert not p.single_pass and p.chunk % unit == 0
    assert (p.ctas - 1) * p.chunk < group_size <= p.ctas * p.chunk


# ---- the kernel's order of summation, in numpy ----

def _warp_sum_lane0(v):
    """fmdm::warp_sum (xor butterfly over 32 lanes, f32): lane 0's value."""
    v = v.astype(np.float32)
    lanes = np.arange(32)
    for offset in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ offset]
    return v[0]


def _block_sum(per_thread):
    """block_sum2: each warp's butterfly, then warp 0's over the warps'
    values padded with zeros to 32 lanes."""
    warps = [_warp_sum_lane0(per_thread[w * 32:(w + 1) * 32]) for w in range(THREADS // 32)]
    return _warp_sum_lane0(np.array(warps + [0.0] * (32 - len(warps)), np.float32))


def _chunk_partials(chunk, unit):
    """One CTA's (sum, sum of squares): thread t takes vectors t, t+256, ...
    of ``unit`` elements, summing each vector's elements in order. (The card
    contracts s2 += f*f into an FMA; here it rounds twice.)"""
    vecs = chunk.reshape(-1, unit)
    s1, s2 = np.zeros(THREADS, np.float32), np.zeros(THREADS, np.float32)
    for start in range(0, len(vecs), THREADS):
        rows = vecs[start:start + THREADS]
        for j in range(unit):
            f = rows[:, j]
            s1[:len(rows)] += f
            s2[:len(rows)] += f * f
    return _block_sum(s1), _block_sum(s2)


def emulate_single_pass(x, w, b, scale, shift, p, eps, act):
    """gn_cluster's result for f32 inputs under plan ``p``: per group, the
    CTAs' partials combined in rank order, then the elementwise tail."""
    n, c = x.shape[:2]
    cg = c // GROUPS
    unit = 4 if p.vec else 1
    xg = x.reshape(n, GROUPS, -1)
    out = np.empty_like(xg)
    f32 = np.float32
    for i in range(n):
        for g in range(GROUPS):
            group = xg[i, g]
            a = b_sum = f32(0)
            for r in range(p.ctas):  # rank order
                s1, s2 = _chunk_partials(group[r * p.chunk:(r + 1) * p.chunk], unit)
                a, b_sum = f32(a + s1), f32(b_sum + s2)
            m = f32(group.size)
            mean = f32(a / m)
            var = max(f32(f32(b_sum / m) - f32(mean * mean)), f32(0))
            rstd = f32(1) / np.sqrt(f32(var + f32(eps)), dtype=f32)
            channels = slice(g * cg, (g + 1) * cg)
            y = ((group.reshape(cg, -1) - mean) * rstd) * w[channels, None] + b[channels, None]
            if scale is not None:
                y = y * (f32(1) + scale[i, channels, None]) + shift[i, channels, None]
            if act:
                y = y / (f32(1) + np.exp(-y))
            out[i, g] = y.reshape(-1)
    return out.reshape(x.shape)


K1_TOL = dict(rtol=2e-4, atol=2e-5)  # as tests/test_torch_kernels.py


@pytest.mark.parametrize("shape,chunk_bytes,max_cluster,film,act", [
    ((2, 64, 16, 16), 512, PORTABLE_CLUSTER, True, True),      # 4 CTAs of 512 bytes
    ((1, 256, 16, 16), 1024, PORTABLE_CLUSTER, False, True),   # 8 CTAs
    ((1, 64, 64, 64), 8192, PORTABLE_CLUSTER, True, True),     # 4 CTAs of two sweeps each
    ((2, 96, 10, 10), 320, PORTABLE_CLUSTER, True, False),     # ragged last chunk
    ((1, 128, 32, 32), 1024, WIDE_CLUSTER, False, True),       # 16 CTAs
])
def test_cluster_summation_order_matches_plain_and_jax(shape, chunk_bytes, max_cluster, film,
                                                       act):
    """At a small shape with chunks forced small, so that a group spans a
    real cluster: the emulated kernel against the plain version and JAX's
    ``_xla_reference`` in f32."""
    rng = np.random.default_rng(11)
    n, c = shape[:2]
    x = (rng.standard_normal(shape) * 1.5 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    s = (0.2 * rng.standard_normal((n, c))).astype(np.float32) if film else None
    t = (0.2 * rng.standard_normal((n, c))).astype(np.float32) if film else None
    group_size = x[0, :c // GROUPS].size
    p = plan(group_size, 4, True, n * GROUPS, max_cluster=max_cluster, chunk_bytes=chunk_bytes)
    assert p.single_pass and p.ctas > 1
    assert p.ctas * p.chunk >= group_size > (p.ctas - 1) * p.chunk
    got = emulate_single_pass(x, w, b, s, t, p, 1e-5, act)

    def tens(a):
        return None if a is None else torch.from_numpy(a)

    plain = group_norm_act_reference(tens(x), tens(w), tens(b), num_groups=GROUPS, act=act,
                                     scale=tens(s), shift=tens(t)).numpy()
    want = np.asarray(_xla_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     None if s is None else jnp.asarray(s),
                                     None if t is None else jnp.asarray(t), GROUPS, 1e-5, act))
    np.testing.assert_allclose(got, plain, **K1_TOL)
    np.testing.assert_allclose(got, want, **K1_TOL)


def test_wrapper_refuses_more_groups_than_the_grid_holds():
    x = torch.zeros((build.MAX_GRID_Y // GROUPS + 1, GROUPS, 1))
    with pytest.raises(ValueError, match=f"exceeds {build.MAX_GRID_Y}"):
        group_norm_act(x, torch.ones(GROUPS), torch.zeros(GROUPS), num_groups=GROUPS)


def test_cpu_calls_count_no_variant():
    K1.reset()
    group_norm_act(torch.randn(2, 64, 8, 8), torch.ones(64), torch.zeros(64), num_groups=GROUPS)
    assert K1.launches == 0 and K1.variants == {"single_pass": 0, "split": 0}
