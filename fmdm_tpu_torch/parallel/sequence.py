"""
Sequence parallelism: ring attention (counterpart of
``fmdm_tpu/parallel/sequence.py``).

The token axis of q, k and v is cut into n shards around a ring. Each
position keeps its q shard; the k/v shards travel one position per hop, and
after n hops every q shard has met every k/v shard. The ``flash`` ring
streams each hop through the per-chunk entry points: the forward runs
``flash_forward_partials`` (K3 on CUDA) on the arriving shard and folds its
normalized (out, lse) into the running pair with
lse' = logaddexp(lse, lse_c), out' = out e^{lse - lse'} + out_c e^{lse_c - lse'}
(JAX :98-108). The backward is a second ring against the saved global
(out, lse): ``flash_backward_chunk`` (K4 + K5) per hop, dq accumulated in
place, (dk, dv) accumulated while they travel with their shard, home after
n hops (:118-147). The ``einsum`` ring is JAX's chunk formulation (the
(max, sum, numerator) carry), differentiated by autograd through its hops.
``impl='auto'`` takes the flash ring when ``tk % 128 == 0 and tq >= 128 and
d >= 16`` (JAX's rule). The combine arithmetic is plain torch, as JAX keeps
it in ``jnp`` outside any kernel.

Two forms of ring, as the meshes have (``parallel/mesh.py``):

- **rank form** (``group``): one shard per rank; a hop is
  ``batch_isend_irecv`` to the next rank of the group and from the previous
  one. Gloo moves only host memory, so on a gloo group a CUDA hop is staged
  through the host (NCCL sends device memory directly);
- **one-process form** (``devices``): the n shards in one process, shard i
  on ``devices[i]``; a hop is ``.to(next device)``. This is JAX's
  in-process ``shard_map`` over CPU devices, and how one card runs the ring
  over shards of itself.

The first hop's carry starts at lse = -inf, so it weighs the zero
accumulator by 0. The forward skips the last rotation of k/v (it feeds no
hop); the backward's last hop rotates only (dk, dv), which takes them home:
a ring of n positions makes n - 1 hops forward and n backward. Each call
and each hop is a span (``utils/trace.py``: "ring attention", "ring hop"),
which ``parallel/collective_stats.py``'s readers count in a profile.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.ops.kernels.flash_attention import (flash_backward_chunk,
                                                        flash_forward_partials)
from fmdm_tpu_torch.utils.trace import span

Tensor = torch.Tensor
IMPLS = ("auto", "flash", "einsum")
# profiler spans: one per ring call (forward) and one per hop, each way
RING, HOP = "ring attention", "ring hop"


class DeviceRing:
    """The one-process ring: shard i on ``devices[i]``."""

    def __init__(self, devices: Sequence[DeviceArg]):
        self.devices = [resolve_device(d) for d in devices]
        self.n = len(self.devices)

    def shift(self, shards: List[List[Tensor]], step: int = 1) -> List[List[Tensor]]:
        """Each tensor list (one tensor per position) moved ``step``
        positions along the ring: position i receives position i - step's."""
        with span(HOP):
            return [[xs[(i - step) % self.n].to(self.devices[i]) for i in range(self.n)]
                    for xs in shards]


class GroupRing:
    """The rank form: this rank is one position of ``group``'s ring."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.n = len(self.ranks)
        self.pos = self.ranks.index(dist.get_rank())
        self.gloo = dist.get_backend(group) == "gloo"

    def shift(self, shards: List[List[Tensor]], step: int = 1) -> List[List[Tensor]]:
        """One hop: every tensor (one per list) sent ``step`` positions on
        and the previous position's received, in one batch of P2P ops."""
        import torch.distributed as dist

        if self.n == 1:
            return shards
        with span(HOP):
            return self._shift(shards, step)

    def _shift(self, shards, step):
        import torch.distributed as dist

        dst = self.ranks[(self.pos + step) % self.n]
        src = self.ranks[(self.pos - step) % self.n]
        recvs, ops = [], []
        for (x,) in shards:
            # gloo reads and writes host memory only: stage a CUDA hop there
            wire = (x.detach().cpu() if self.gloo else x.detach()).contiguous()
            out = torch.empty_like(wire)
            recvs.append(out)
            ops += [dist.P2POp(dist.isend, wire, dst, self.group),
                    dist.P2POp(dist.irecv, out, src, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [[r.to(x.device)] for r, (x,) in zip(recvs, shards)]


class _Shift(torch.autograd.Function):
    """A differentiable hop: the gradient travels one hop back."""

    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        n = len(xs) // _width(ring)
        moved = ring.shift(_rows(list(xs), n))
        return tuple(x.view_as(x) if any(x is y for y in xs) else x for row in moved for x in row)

    @staticmethod
    def backward(ctx, *gs):
        n = len(gs) // _width(ctx.ring)
        back = ctx.ring.shift(_rows(list(gs), n), step=-1)
        return (None,) + tuple(g for row in back for g in row)


def _width(ring) -> int:
    """Tensors per list: the ring's positions in this process."""
    return ring.n if isinstance(ring, DeviceRing) else 1


def _rows(flat: List[Tensor], n_lists: int) -> List[List[Tensor]]:
    w = len(flat) // n_lists
    return [flat[i * w:(i + 1) * w] for i in range(n_lists)]


def _flash_hop_eligible(q: Tensor, k: Tensor) -> bool:
    """Can the flash kernels tile this hop (JAX's rule): a 128-aligned KV
    shard, and a per-hop score tile big enough to matter."""
    tq, d = q.shape[-2:]
    return k.shape[-2] % 128 == 0 and tq >= 128 and d >= 16


# -- the flash ring ----------------------------------------------------------

def _ring_flash_forward(ring, qs, ks, vs, scale: float):
    outs = [q.new_zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32)
            for q, v in zip(qs, vs)]
    lses = [torch.full(q.shape[:-1] + (1,), -math.inf, dtype=torch.float32, device=q.device)
            for q in qs]
    k_cur, v_cur = ks, vs
    for hop in range(ring.n):
        for j, q in enumerate(qs):
            o_c, lse_c = flash_forward_partials(q, k_cur[j], v_cur[j], scale)
            lse_new = torch.logaddexp(lses[j], lse_c)
            outs[j] = (outs[j] * torch.exp(lses[j] - lse_new)
                       + o_c.float() * torch.exp(lse_c - lse_new))
            lses[j] = lse_new
        if hop < ring.n - 1:
            k_cur, v_cur = ring.shift([k_cur, v_cur])
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def _ring_flash_backward(ring, qs, ks, vs, outs, lses, gs, scale: float):
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    k_cur, v_cur = ks, vs
    for hop in range(ring.n):
        for j, q in enumerate(qs):
            # (dk, dv) accumulate the gradient of the shard they travel with
            dq_c, dk_c, dv_c = flash_backward_chunk(q, k_cur[j], v_cur[j], outs[j], lses[j],
                                                    gs[j], scale)
            dqs[j] = dqs[j] + dq_c.float()
            dks[j] = dks[j] + dk_c.float()
            dvs[j] = dvs[j] + dv_c.float()
        if hop < ring.n - 1:
            k_cur, v_cur, dks, dvs = ring.shift([k_cur, v_cur, dks, dvs])
        else:
            dks, dvs = ring.shift([dks, dvs])
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)], [d.to(k.dtype) for d, k in zip(dks, ks)],
            [d.to(v.dtype) for d, v in zip(dvs, vs)])


class _RingFlash(torch.autograd.Function):
    """The flash ring: its forward saves (q, k, v, out, lse) of every local
    position, never a score tile; its backward is the second ring."""

    @staticmethod
    def forward(ctx, ring, scale, *tensors):
        qs, ks, vs = _rows(list(tensors), 3)
        outs, lses = _ring_flash_forward(ring, qs, ks, vs, scale)
        ctx.ring, ctx.scale, ctx.width = ring, scale, len(qs)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        qs, ks, vs, outs, lses = _rows(list(ctx.saved_tensors), 5)
        gs = [torch.zeros_like(o) if g is None else g.contiguous() for g, o in zip(gs, outs)]
        dqs, dks, dvs = _ring_flash_backward(ctx.ring, qs, ks, vs, outs, lses, gs, ctx.scale)
        return (None, None, *dqs, *dks, *dvs)


# -- the einsum ring ---------------------------------------------------------

def _chunk_attention(q: Tensor, k: Tensor, v: Tensor, scale: float):
    """(m, l, acc) of one K/V chunk with f32 statistics (JAX :46-60)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return m, l, acc


def _ring_einsum(ring, qs, ks, vs, scale: float) -> List[Tensor]:
    ms = [torch.full(q.shape[:-1] + (1,), -math.inf, device=q.device) for q in qs]
    ls = [q.new_zeros(q.shape[:-1] + (1,), dtype=torch.float32) for q in qs]
    accs = [q.new_zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32)
            for q, v in zip(qs, vs)]
    k_cur, v_cur = list(ks), list(vs)
    for hop in range(ring.n):
        for j, q in enumerate(qs):
            mc, lc, accc = _chunk_attention(q, k_cur[j], v_cur[j], scale)
            m_new = torch.maximum(ms[j], mc)
            c_old, c_new = torch.exp(ms[j] - m_new), torch.exp(mc - m_new)
            ls[j] = ls[j] * c_old + lc * c_new
            accs[j] = accs[j] * c_old + accc * c_new
            ms[j] = m_new
        if hop < ring.n - 1:
            moved = _Shift.apply(ring, *k_cur, *v_cur)
            k_cur, v_cur = _rows(list(moved), 2)
    return [(acc / l).to(q.dtype) for acc, l, q in zip(accs, ls, qs)]


# -- entry points ------------------------------------------------------------

def ring_attention(q, k, v, *, group=None, devices: Optional[Sequence[DeviceArg]] = None,
                   scale: Optional[float] = None, impl: str = "auto"):
    """Exact attention with K/V rotated around a ring, shards cut along the
    token dim (-2).

    Rank form (``group``): q, k, v are this rank's shards and this rank's
    out shard comes back. One-process form (``devices``, default the
    visible cards, which must exist): q, k, v are lists of shards, shard i
    on ``devices[i]``, and the list of out shards comes back.

    impl: 'flash' runs every hop through K3 forward and K4 + K5 backward
    (their plain versions on the CPU); 'einsum' is the chunk formulation;
    'auto' picks flash when the kernels' tiling rule holds."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown ring impl '{impl}'")
    if group is not None:
        ring, qs, ks, vs = GroupRing(group), [q], [k], [v]
    else:
        if devices is None:
            from fmdm_tpu_torch.parallel.mesh import local_devices

            devices = local_devices()
        ring, qs, ks, vs = DeviceRing(devices), list(q), list(k), list(v)
        if not len(qs) == len(ks) == len(vs) == ring.n:
            raise ValueError(f"ring_attention: {ring.n} devices need as many shards of q, k "
                             f"and v; got {len(qs)}, {len(ks)}, {len(vs)}")
    if scale is None:
        scale = 1.0 / math.sqrt(qs[0].shape[-1])
    with span(RING):
        if impl == "flash" or (impl == "auto" and _flash_hop_eligible(qs[0], ks[0])):
            outs = list(_RingFlash.apply(ring, float(scale), *qs, *ks, *vs))
        else:
            outs = _ring_einsum(ring, qs, ks, vs, float(scale))
    return outs[0] if group is not None else outs


def sequence_parallel_sdpa(q: Tensor, k: Tensor, v: Tensor, *,
                           devices: Optional[Sequence[DeviceArg]] = None,
                           scale: Optional[float] = None, impl: str = "auto") -> Tensor:
    """Whole (..., T, d) tensors in, the ring over ``devices`` (one-process
    form, default the visible cards) underneath: the token dim cut into one
    shard per device (T and S divisible by their count), the out shards
    concatenated back on q's device. Differentiable."""
    if devices is None:
        from fmdm_tpu_torch.parallel.mesh import local_devices

        devices = local_devices()
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if q.shape[-2] % n or k.shape[-2] % n:
        raise ValueError(f"sequence_parallel_sdpa: {n} shards must divide the token counts "
                         f"{q.shape[-2]} and {k.shape[-2]}")
    shards = [[x.to(d).contiguous() for x, d in zip(t.chunk(n, dim=-2), devs)]
              for t in (q, k, v)]
    outs = ring_attention(*shards, devices=devs, scale=scale, impl=impl)
    return torch.cat([o.to(q.device) for o in outs], dim=-2)


def run_self_tests(device: DeviceArg = None) -> None:
    """The ring over two shards of ``device`` (CUDA by default) equals
    single-device attention (JAX :243-258)."""
    import numpy as np

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32)).to(dev)
               for _ in range(3))
    out = sequence_parallel_sdpa(q, k, v, devices=[dev, dev])
    ref = torch.softmax(q @ k.transpose(-1, -2) / 4.0, dim=-1) @ v
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=2e-5)
