"""
K1: fused GroupNorm(+affine)(+FiLM)(+SiLU).

Replaces the Pallas TPU kernel ``fmdm_tpu/ops/pallas/group_norm.py::_kernel``
(:54-89, entry ``fused_group_norm_act`` :160-190) with the CUDA kernels in
``fmdm_tpu_torch/csrc/group_norm.cu``. It is bound by bytes: the least time
is one read of x and one write of the output at 3.35 TB/s. The TPU kernel
holds a whole group in VMEM; a flagship group (512 KB or 1 MB in bf16) is
more than a Hopper block's 227 KB of shared memory. So the single-pass
kernel, ``gn_cluster``, spreads each group over a thread-block cluster of R
CTAs, each holding its chunk in shared memory, and combines the f32 partial
sums through distributed shared memory: x is read once. Groups larger than
any cluster holds take the split variant, ``gn_stats`` + ``gn_apply``, which
reads x twice. :func:`plan` chooses the variant, R and the chunk from the
shape before the launch; a launch that fails raises.

:func:`group_norm_act` launches a kernel for a CUDA tensor and takes the
plain version, :func:`group_norm_act_reference`, only for a CPU tensor. The
backward recomputes the plain version's autograd, as the JAX ``_fused_bwd``
recomputes the XLA reference VJP.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from fmdm_tpu_torch.ops.kernels import build
from fmdm_tpu_torch.ops.norm import group_norm_f32

# ``launches`` counts calls; ``variants`` counts device launches: one per
# single-pass call, two (gn_stats, gn_apply) per split call
K1 = build.KernelRecord(
    name="K1 group_norm_act",
    source="fmdm_tpu_torch/csrc/group_norm.cu",
    replaces="fmdm_tpu/ops/pallas/group_norm.py:54",
    variants={"single_pass": 0, "split": 0},
)

THREADS = 256                # kThreads in group_norm.cu
SMEM_PER_BLOCK = 232_448     # shared memory one block may use on sm_90 (227 KB)
_STATIC_SMEM = 1024          # room for gn_cluster's static shared memory (256 bytes)
CHUNK_BYTES = 64 * 1024      # bytes of a group one CTA holds: three CTAs share an SM
PIECES = 4                   # bulk copies per chunk: summing starts when the first lands
MAX_PIECES = 8               # kMaxPieces
PORTABLE_CLUSTER = 8
WIDE_CLUSTER = 16            # non-portable: taken where the card schedules it
_CLUSTER_SIZES = (1, 2, 4, 8, 16)
_SPLIT_BLOCKS_PER_SM = 4     # split variant: blocks in flight per SM
_SPLIT_MIN_LOADS = 4         # split variant: least loads per thread
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How K1 covers each (sample, group) of a call."""

    single_pass: bool  # gn_cluster; else gn_stats + gn_apply
    ctas: int          # CTAs per group: the cluster's size, or the split count
    chunk: int         # elements of the group per CTA; CTA r takes [r*chunk, (r+1)*chunk)
    piece: int         # elements per bulk copy (single pass with 16-byte vectors)
    smem: int          # dynamic shared memory per CTA in bytes (single pass)
    vec: bool          # 16-byte vectors


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def plan(group_size: int, elem_bytes: int, vec: bool, group_count: int, *,
         max_cluster: int = PORTABLE_CLUSTER, chunk_bytes: int = CHUNK_BYTES,
         pieces: int = PIECES, sm_count: int = 132) -> Plan:
    """K1's plan for ``group_count`` groups of ``group_size`` elements.

    The single pass takes the smallest cluster whose chunks are at most
    ``chunk_bytes``, else the largest allowed cluster if its chunks fit a
    block's shared memory; a group that fits no cluster of ``max_cluster``
    CTAs takes the split variant. With 16-byte vectors every chunk and piece
    is a multiple of the vector and a piece a multiple of one sweep of the
    block, so each thread sums its vectors in the order of one strided pass."""
    unit = 16 // elem_bytes if vec else 1
    limit = SMEM_PER_BLOCK - _STATIC_SMEM
    sizes = [r for r in _CLUSTER_SIZES if r <= max_cluster]
    chunks = {r: _round_up(-(-group_size // r), unit) for r in sizes}
    small = [r for r in sizes if chunks[r] * elem_bytes <= chunk_bytes]
    ctas = small[0] if small else sizes[-1]
    chunk = chunks[ctas]
    if chunk * elem_bytes > limit:
        return split_plan(group_size, elem_bytes, vec, group_count, sm_count=sm_count)
    piece = _round_up(-(-chunk // pieces), THREADS * unit) if vec else chunk
    return Plan(True, ctas, chunk, piece, _round_up(chunk * elem_bytes, 16), vec)


def split_plan(group_size: int, elem_bytes: int, vec: bool, group_count: int, *,
               sm_count: int = 132) -> Plan:
    """The split variant's plan: enough blocks for about four per SM, each
    with at least four loads per thread."""
    unit = 16 // elem_bytes if vec else 1
    splits = max(1, min(math.ceil(_SPLIT_BLOCKS_PER_SM * sm_count / group_count),
                        math.ceil(group_size / (THREADS * unit * _SPLIT_MIN_LOADS))))
    chunk = _round_up(math.ceil(group_size / splits), unit)
    return Plan(False, math.ceil(group_size / chunk), chunk, 0, 0, vec)


def group_norm_act_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int,
    eps: float = 1e-5,
    act: bool = True,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: GroupNorm, optional FiLM ``y*(1+scale)+shift`` with
    (N, C) scale/shift, optional SiLU, all in f32 and cast once to x's dtype.
    In f32 this is the JAX ``_xla_reference``; in bf16 it rounds once, as the
    TPU kernel does."""
    y = group_norm_f32(x, weight, bias, num_groups=num_groups, eps=eps)
    if scale is not None:
        shape = tuple(scale.shape) + (1,) * (x.dim() - 2)
        y = y * (1 + scale.float().reshape(shape)) + shift.float().reshape(shape)
    if act:
        y = F.silu(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=1)
def _entries():
    lib = build.library()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    run = lib.fmdm_group_norm_act
    run.argtypes = [I, P, P, P, P, P, P, P, I, I, I, L, I, I, L, L, I, ctypes.c_float, I, I, I,
                    I, P]
    run.restype = I
    query = lib.fmdm_group_norm_max_clusters
    query.argtypes = [I, I, I, I, I, I, ctypes.POINTER(I)]
    query.restype = I
    return run, query


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, ctas: int, smem: int, x_bf16: bool, w_bf16: bool, vec: bool) -> int:
    """Clusters of ``ctas`` CTAs with ``smem`` bytes each that the card holds at once."""
    count = ctypes.c_int(0)
    status = _entries()[1](index, ctas, smem, int(x_bf16), int(w_bf16), int(vec),
                           ctypes.byref(count))
    build.check_status(status, K1.name)
    return count.value


@functools.lru_cache(maxsize=None)
def _device_plan(index: int, group_size: int, elem_bytes: int, vec: bool, group_count: int,
                 x_bf16: bool, w_bf16: bool) -> Plan:
    """:func:`plan` for this card: a 16-CTA cluster only where it schedules."""
    sms = _sm_count(index)
    p = plan(group_size, elem_bytes, vec, group_count, max_cluster=WIDE_CLUSTER, sm_count=sms)
    if p.single_pass and p.ctas > PORTABLE_CLUSTER \
            and _max_clusters(index, p.ctas, p.smem, x_bf16, w_bf16, vec) < 1:
        p = plan(group_size, elem_bytes, vec, group_count, max_cluster=PORTABLE_CLUSTER,
                 sm_count=sms)
    return p


def _check_param(name: str, t: torch.Tensor, shape, device, dtypes) -> None:
    if t.device != device or t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"group_norm_act: {name} must be a contiguous {tuple(shape)} tensor of "
            f"{[str(d) for d in dtypes]} on {device}; got {tuple(t.shape)} "
            f"{t.dtype} on {t.device}")


def _validate(x, weight, bias, scale, shift, num_groups: int) -> None:
    """Raise on anything the kernel does not take (checked on every device,
    so the CPU runs hold the callers to the kernel's contract)."""
    if x.dtype not in _DTYPES or x.dim() < 3 or not x.is_contiguous():
        raise ValueError(f"group_norm_act: x must be a contiguous f32/bf16 (N, C, *spatial) "
                         f"tensor; got {tuple(x.shape)} {x.dtype}")
    n, c = x.shape[0], x.shape[1]
    if num_groups < 1 or c % num_groups != 0:
        raise ValueError(f"group_norm_act: {c} channels are not divisible into {num_groups} groups")
    if n * num_groups > build.MAX_GRID_Y:
        raise ValueError(f"group_norm_act: N*groups={n * num_groups} exceeds {build.MAX_GRID_Y}")
    _check_param("weight", weight, (c,), x.device, _DTYPES)
    _check_param("bias", bias, (c,), x.device, (weight.dtype,))
    if (scale is None) != (shift is None):
        raise ValueError("group_norm_act: pass both scale and shift, or neither")
    if scale is not None:
        _check_param("scale", scale, (n, c), x.device, (x.dtype,))
        _check_param("shift", shift, (n, c), x.device, (x.dtype,))


def vector_aligned(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether K1 moves x and out in 16-byte vectors: the spatial size is a
    multiple of the vector (no vector straddles two channels) and both
    pointers are 16-byte aligned."""
    hw = x.numel() // (x.shape[0] * x.shape[1])
    return hw % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0


def _launch(x, weight, bias, scale, shift, num_groups: int, eps: float, act: bool,
            p: Optional[Plan] = None) -> torch.Tensor:
    """Launch K1 on the current stream (inputs validated) with the plan for
    this card, or with ``p`` (a plan for these inputs, as a report's
    candidates give it)."""
    n, c = x.shape[0], x.shape[1]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    hw = x.numel() // (n * c)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    x_bf16, w_bf16 = x.dtype == torch.bfloat16, weight.dtype == torch.bfloat16
    if p is None:
        p = _device_plan(index, (c // num_groups) * hw, x.element_size(),
                         vector_aligned(x, out), n * num_groups, x_bf16, w_bf16)
    partials = None if p.single_pass else torch.empty(
        2 * n * num_groups * p.ctas, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entries()[0](
        index, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        n, c, num_groups, hw, int(p.single_pass), p.ctas, p.chunk, p.piece, p.smem, float(eps),
        int(bool(act)), int(x_bf16), int(w_bf16), int(p.vec), stream,
    )
    build.check_status(status, K1.name)
    K1.launches += 1
    if p.single_pass:
        K1.variants["single_pass"] += 1
    else:
        K1.variants["split"] += 2
    return out


class _GroupNormAct(torch.autograd.Function):
    """Kernel forward; backward through the plain version's autograd."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias, scale, shift)
        ctx.config = (num_groups, eps, act)
        return _launch(x, weight, bias, scale, shift, num_groups, eps, act)

    @staticmethod
    def backward(ctx, grad):
        num_groups, eps, act = ctx.config
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:5])]
            out = group_norm_act_reference(
                leaves[0], leaves[1], leaves[2], num_groups=num_groups, eps=eps, act=act,
                scale=leaves[3], shift=leaves[4])
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return tuple(next(grads) if t is not None and t.requires_grad else None
                     for t in leaves) + (None, None, None)


def group_norm_act(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int,
    eps: float = 1e-5,
    act: bool = True,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GroupNorm + optional FiLM(h*(1+scale)+shift) + optional SiLU.

    A CUDA tensor goes through kernel K1 (or raises); a CPU tensor takes the
    plain version. ``scale``/``shift``: (N, C) in x's dtype."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    _validate(x, weight, bias, scale, shift, num_groups)
    if x.device.type == "cpu":
        return group_norm_act_reference(x, weight, bias, num_groups=num_groups, eps=eps,
                                        act=act, scale=scale, shift=shift)
    tensors = (x, weight, bias, scale, shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return _GroupNormAct.apply(x, weight, bias, scale, shift, num_groups, eps, act)
    return _launch(x, weight, bias, scale, shift, num_groups, eps, act)
