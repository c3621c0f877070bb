"""
K1: fused GroupNorm(+affine)(+FiLM)(+SiLU).

Replaces the Pallas TPU kernel ``fmdm_tpu/ops/pallas/group_norm.py::_kernel``
(:54-89, entry ``fused_group_norm_act`` :160-190) with the CUDA kernel in
``fmdm_tpu_torch/csrc/group_norm.cu``. It is bound by memory: the least time
is one read of x and one write of the output at 3.35 TB/s. The TPU kernel
holds a whole group in VMEM; a flagship group (512 KB in bf16) does not fit in
a Hopper block's 227 KB of shared memory, so the CUDA kernel runs a split f32
reduction into a scratch buffer and then an apply pass (two reads, one write).

:func:`group_norm_act` launches the kernel for a CUDA tensor and takes the
plain version, :func:`group_norm_act_reference`, only for a CPU tensor. The
backward recomputes the plain version's autograd, as the JAX ``_fused_bwd``
recomputes the XLA reference VJP.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from fmdm_tpu_torch.ops.kernels import build
from fmdm_tpu_torch.ops.norm import group_norm_f32

K1 = build.KernelRecord(
    name="K1 group_norm_act",
    source="fmdm_tpu_torch/csrc/group_norm.cu",
    replaces="fmdm_tpu/ops/pallas/group_norm.py:54",
)

_THREADS = 256          # kThreads in group_norm.cu
_BLOCKS_PER_SM = 4      # target blocks in flight per SM when splitting a group
_MIN_LOADS_PER_THREAD = 4
_DTYPES = (torch.float32, torch.bfloat16)


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
def _entry():
    fn = build.library().fmdm_group_norm_act
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, P, P, P, P, P, P, P,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _launch(x, weight, bias, scale, shift, num_groups: int, eps: float, act: bool) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (inputs validated)."""
    n, c = x.shape[0], x.shape[1]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    hw = x.numel() // (n * c)
    group_size = (c // num_groups) * hw
    pack = 16 // x.element_size()
    vec = hw % pack == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    unit = pack if vec else 1
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    splits = max(1, min(
        math.ceil(_BLOCKS_PER_SM * _sm_count(index) / (n * num_groups)),
        math.ceil(group_size / (_THREADS * unit * _MIN_LOADS_PER_THREAD)),
    ))
    chunk = math.ceil(math.ceil(group_size / splits) / unit) * unit
    splits = math.ceil(group_size / chunk)
    partials = torch.empty(2 * n * num_groups * splits, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry()(
        index, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(),
        out.data_ptr(), partials.data_ptr(),
        n, c, num_groups, hw, splits, chunk, float(eps), int(bool(act)),
        int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16), int(vec), stream,
    )
    build.check_status(status, K1.name)
    K1.launches += 1
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
