"""
Tensor parallelism over the ``model`` axis (counterpart of
``fmdm_tpu/parallel/tp.py``).

Placement is JAX's rule (:func:`_leaf_spec`): every parameter whose leading
dim the axis divides is cut along it, each rank of a ``model`` line holding
one slice; any other parameter is whole on every rank. Parameters that take
no gradient (the discriminators' BatchNorm statistics) stay whole.

JAX lets GSPMD propagate the slices through the network. The port runs the
forward on local tensors, because its kernels take raw pointers and a
``DTensor`` has no route into them, and because ``DTensor``'s convolution
strategies are narrower than GSPMD's propagation:

- a ``Conv`` or ``Linear`` whose weight is cut runs column-parallel: its
  input passes an op that is the identity forward and an all-reduce of the
  input gradient backward, the local weight and bias give this rank's
  output channels from the whole input, and those are all-gathered along
  channels (backward: this rank's slice of the gradient);
- every other cut parameter (norm affines, a transposed conv's weight,
  whose dim 0 is its input) is all-gathered whole at use: the module whose
  forward reads it (its parent, which calls it or reads it as K1's affine)
  gathers it on entry and puts the slice back on exit. Its gradient is the
  rank's slice of the gathered tensor's: every rank of the line computes the
  same gradient for it, since everything outside a column-parallel product
  runs whole on every rank.

So K1 and K2 see whole tensors, and each output channel is computed from
the whole input, as under GSPMD. Parameters are stored as plain slices
under their own names (``state_dict`` names unchanged): the optimizer's
moments follow them, and :meth:`TensorParallel.full` gathers a slice whole
for a checkpoint.

    mesh = create_dp_tp_mesh_global(batch_size, tp)   # parallel/mesh.py, rank form
    tp = TensorParallel(model, mesh)                  # cuts model in place
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fmdm_tpu_torch.nn.layers import Conv, Linear, conv_nd, linear_nd
from fmdm_tpu_torch.parallel.mesh import Mesh2D

Spec = Tuple[Optional[str], ...]
FORWARD_METHODS = ("forward", "encode", "decode")


def _leaf_spec(shape: Sequence[int], axis_size: int, axis: str = "model") -> Spec:
    """JAX's rule (:69-77): the leading (output) dim over ``axis`` when the
    axis divides it, else whole (an empty spec)."""
    if len(shape) == 0 or shape[0] % axis_size != 0:
        return ()
    return (axis,) + (None,) * (len(shape) - 1)


def tp_param_specs(model: nn.Module, axis_size: int, axis: str = "model") -> Dict[str, Spec]:
    """Each trainable parameter's spec by its ``state_dict`` name; the ones
    that take no gradient are whole."""
    return {name: _leaf_spec(tuple(p.shape), axis_size, axis) if p.requires_grad else ()
            for name, p in model.named_parameters()}


# -- collectives with their gradients ----------------------------------------

def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return torch.cat(out.unflatten(0, (n, x.shape[0])).unbind(0), dim=dim)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the input gradient summed over the line backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherDim(torch.autograd.Function):
    """The line's slices concatenated along ``dim``; backward, this rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.n, ctx.index = dim, n, index
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), None, None, None, None


class TensorParallel:
    """Cuts ``model``'s parameters over the ``model`` axis of the rank form
    of ``mesh`` (in place) and installs the column-parallel and gather-at-use
    forwards (see the module's docstring)."""

    def __init__(self, model: nn.Module, mesh: Mesh2D, axis: str = "model"):
        if not mesh.spans_ranks:
            raise ValueError("tensor parallelism runs over the ranks of a process group")
        self.group = mesh.group(axis)
        self.n = mesh.axis_size(axis)
        self.index = mesh.coordinate(axis)
        self.specs = tp_param_specs(model, self.n, axis)
        owners = {}
        for mod_name, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{pname}" if mod_name else pname
                owners[name] = (mod_name, mod, pname)
                if self.specs[name]:
                    p.data = self.local(name, p.data)
        column = set()
        for mod_name, mod in model.named_modules():
            if isinstance(mod, (Conv, Linear)) and self.specs.get(_join(mod_name, "weight")):
                mod.forward = functools.partial(_column_forward, mod, self)
                column.update({_join(mod_name, "weight"), _join(mod_name, "bias")})
        # the rest of the cut parameters, gathered by the module that reads them
        readers: Dict[str, List[Tuple[nn.Module, str]]] = {}
        for name, (mod_name, mod, pname) in owners.items():
            if self.specs[name] and name not in column:
                reader = mod_name.rpartition(".")[0] if mod_name else ""
                readers.setdefault(reader, []).append((mod, pname))
        modules = dict(model.named_modules())
        for reader, entries in readers.items():
            target = modules[reader]
            state = {"depth": 0}
            for method in FORWARD_METHODS:
                if hasattr(type(target), method):
                    setattr(target, method, self._gathering(getattr(target, method), entries,
                                                            state))

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor of parameter ``name``'s shape."""
        if not self.specs.get(name):
            return full
        return full.chunk(self.n, dim=0)[self.index].contiguous()

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from the line's slices (a collective)."""
        if not self.specs.get(name):
            return local
        return _gather(local.detach(), 0, self.group, self.n)

    def gather(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """The line's slices along ``dim``, differentiable."""
        return _GatherDim.apply(local, dim, self.group, self.n, self.index)

    def _gathering(self, method, entries, state):
        @functools.wraps(method)
        def run(*args, **kwargs):
            if state["depth"]:
                return method(*args, **kwargs)
            saved = [(mod, pname, mod._parameters[pname]) for mod, pname in entries]
            for mod, pname, local in saved:
                mod._parameters[pname] = self.gather(local, 0)
            state["depth"] += 1
            try:
                return method(*args, **kwargs)
            finally:
                state["depth"] -= 1
                for mod, pname, local in saved:
                    mod._parameters[pname] = local
        return run


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _column_forward(mod: nn.Module, tp: TensorParallel, x: torch.Tensor) -> torch.Tensor:
    """This rank's output channels from the whole input, then gathered."""
    x = _CopyToModel.apply(x, tp.group)
    if isinstance(mod, Conv):
        y = conv_nd(x, mod.weight, mod.bias, stride=mod.stride, padding=mod.padding)
        return tp.gather(y, 1)
    return tp.gather(linear_nd(x, mod.weight, mod.bias), -1)
