"""
Fully-sharded data parallelism (counterpart of ``fmdm_tpu/parallel/fsdp.py``)
on FSDP2 (``torch.distributed.fsdp.fully_shard``).

Placement is JAX's rule: each parameter is cut along its largest dim that
the ``data`` axis divides (:func:`fsdp_leaf_spec`); with tensor parallelism,
along the largest remaining such dim beside the ``model`` axis's dim 0
(:func:`fsdp_tp_leaf_spec`). ``shard_placement_fn`` hands FSDP2 that dim.
A parameter with no such dim, which JAX replicates, is cut unevenly along
dim 0 (FSDP2's default, padded): the same values in another per-rank
layout. Parameters that take no gradient (the discriminators' BatchNorm
statistics) stay whole on every rank (``ignored_params``), as do buffers
(an EMA codebook's statistics).

FSDP2 gathers parameters per unit. A unit here is every module that is the
parent of a module holding parameters, and the root: a parent's forward is
where its children's parameters are read (K1's affine is read by the block
that calls it), so each parameter is whole wherever it is used. The root's
``encode`` and ``decode`` gather as its forward does. FSDP2 averages the
gradients it reduce-scatters; the port's train steps already divide by the
global batch's count and sum over the ranks (``train/common.py``), so every
unit sums (divide factor 1): the step stays JAX's global-batch step. The
optimizer's moments follow their parameters' placements (as ``DTensor`` objects),
as ``shard_opt_state_fsdp`` places them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

Spec = Tuple[Optional[str], ...]
FORWARD_METHODS = ("encode", "decode")


def fsdp_leaf_spec(shape: Sequence[int], axis_size: int, axis: str = "data") -> Spec:
    """JAX's rule (:36-46): the largest axis-divisible dim over ``axis``;
    else whole (an empty spec)."""
    if len(shape) == 0:
        return ()
    candidates = [d for d in range(len(shape)) if shape[d] % axis_size == 0 and shape[d] >= axis_size]
    if not candidates:
        return ()
    dim = max(candidates, key=lambda d: shape[d])
    spec = [None] * len(shape)
    spec[dim] = axis
    return tuple(spec)


def fsdp_tp_leaf_spec(shape: Sequence[int], data_size: int, model_size: int,
                      data_axis: str = "data", model_axis: str = "model") -> Spec:
    """JAX's two-axis rule (:84-102): dim 0 over ``model_axis`` when
    divisible, then the largest remaining divisible dim over ``data_axis``."""
    if len(shape) == 0:
        return ()
    spec = [None] * len(shape)
    if shape[0] % model_size == 0:
        spec[0] = model_axis
    candidates = [d for d in range(len(shape))
                  if spec[d] is None and shape[d] % data_size == 0 and shape[d] >= data_size]
    if candidates:
        dim = max(candidates, key=lambda d: shape[d])
        spec[dim] = data_axis
    return tuple(spec) if any(spec) else ()


def fsdp_param_specs(model: nn.Module, axis_size: int, axis: str = "data") -> Dict[str, Spec]:
    """Each parameter's spec by its ``state_dict`` name (whole for those
    that take no gradient)."""
    return {name: fsdp_leaf_spec(tuple(p.shape), axis_size, axis) if p.requires_grad else ()
            for name, p in model.named_parameters()}


def fsdp_tp_param_specs(model: nn.Module, data_size: int, model_size: int) -> Dict[str, Spec]:
    return {name: fsdp_tp_leaf_spec(tuple(p.shape), data_size, model_size) if p.requires_grad
            else () for name, p in model.named_parameters()}


def _units(model: nn.Module):
    """The modules that are parents of a parameter holder, and the root,
    children before parents."""
    units = [m for m in model.modules()
             if any(next(c.parameters(recurse=False), None) is not None for c in m.children())]
    if model not in units:
        units.insert(0, model)
    return units[::-1]


def shard_params_fsdp(model: nn.Module, device_mesh, specs: Dict[str, Spec],
                      axis: str = "data") -> nn.Module:
    """``fully_shard`` every unit of ``model`` over ``device_mesh`` (its
    ``axis`` dim) with the dims of ``specs`` (the specs of the parameters'
    whole shapes), gradients summed; in place, the parameters become
    ``DTensor`` objects under their own names."""
    from torch.distributed.fsdp import FSDPModule, fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    by_param = {id(p): specs[name] for name, p in model.named_parameters()}
    ignored = {p for p in model.parameters() if not p.requires_grad}

    def placement(p: nn.Parameter):
        spec = by_param.get(id(p), ())
        return Shard(spec.index(axis)) if axis in spec else None

    mesh = device_mesh[axis] if device_mesh.ndim > 1 else device_mesh
    for unit in _units(model):
        fully_shard(unit, mesh=mesh, shard_placement_fn=placement, ignored_params=ignored)
    for method in FORWARD_METHODS:
        if hasattr(type(model), method):
            register_fsdp_forward_method(model, method)
    for unit in model.modules():
        if isinstance(unit, FSDPModule):
            unit.set_gradient_divide_factor(1.0)
            unit.set_force_sum_reduction_for_comms(True)
    return model


def local(param: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """A whole tensor of ``param``'s shape placed as ``param`` is (a
    ``DTensor`` of this rank's shard); ``full`` itself for a plain param."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(param, DTensor):
        return full
    return distribute_tensor(full.to(param.device), param.device_mesh, param.placements,
                             src_data_rank=None)


def full(tensor: torch.Tensor) -> torch.Tensor:
    """The whole value of an FSDP ``DTensor`` (an all-gather over its mesh),
    a plain tensor as it is. The shards are gathered with
    ``all_gather_into_tensor``, each padded to the largest (FSDP2 cuts as
    ``torch.chunk`` does): ``DTensor.full_tensor``'s functional collectives
    crash a gloo group on CUDA tensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not isinstance(tensor, DTensor):
        return tensor
    (placement,) = tensor.placements
    local = tensor.to_local()
    if not placement.is_shard():
        return local
    dim, n = placement.dim, tensor.device_mesh.size()
    sizes = [len(c) for c in torch.empty(tensor.shape[dim], device="meta").chunk(n)]
    sizes += [0] * (n - len(sizes))
    rows = local.movedim(dim, 0)
    padded = rows.new_zeros((max(sizes),) + tuple(rows.shape[1:]))
    padded[: rows.shape[0]] = rows
    out = padded.new_empty((n * padded.shape[0],) + tuple(padded.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=tensor.device_mesh.get_group())
    parts = out.unflatten(0, (n, padded.shape[0])).unbind(0)
    return torch.cat([part[:size] for part, size in zip(parts, sizes)]).movedim(0, dim)
