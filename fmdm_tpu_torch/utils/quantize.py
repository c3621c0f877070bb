"""
Post-training int8 quantization of a float model (counterpart of
``fmdm_tpu/utils/quantize.py``): calibration, the policy, and the rewrite.

    qmodel = quantize_model(model, [(x, t)], device="cuda")
    qmodel(x, t)    # conv_nd / linear_nd dispatch on the quantized weights

Calibration runs the model's forward over the example inputs with a forward
pre-hook on every ``Conv`` and ``Linear`` of the port (JAX patches the
module-level ``conv_nd``/``linear_nd`` instead), recording each one's input
absmax (its static activation scale), its smallest spatial extent (convs) or
token count (Linears), its input channels and its kernel. The policy then
keeps a conv float unless every calibrated call saw an extent >= ``min_hw``
and >= ``min_channels`` channels through a spatial kernel (max(k) > 1), and
keeps ``skip_paths`` (``conv_in``, ``conv_out``) float; with
``quantize_linear`` a Linear is quantized whose every call carried >=
``linear_min_tokens`` tokens and >= ``linear_min_features`` features.

The result is a quantized copy on ``device``: the float model is left as it
was. A quantized module's path is the JAX tree's quantized leaf path
(``<module>.weight``).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.layers import Conv, Linear
from fmdm_tpu_torch.ops.quant import make_quantized, make_quantized_linear


class CallRecord:
    """What calibration saw at one Conv or Linear over all its calls."""

    __slots__ = ("kind", "absmax", "min_hw", "cin", "kernel", "calls")

    def __init__(self, kind: str):
        self.kind = kind
        self.absmax = 0.0
        self.min_hw = 1 << 30  # convs: smallest spatial extent; Linears: smallest token count
        self.cin = 0
        self.kernel: Tuple[int, ...] = ()
        self.calls = 0


def calibrate(model: nn.Module, example_args: Sequence[Tuple[Any, ...]],
              forward_fn: Optional[Callable[..., Any]] = None) -> Dict[str, CallRecord]:
    """Run ``forward_fn(model, *args)`` (default ``model(*args)``) for each
    entry of ``example_args`` without gradients, and return each called
    Conv's and Linear's record by its module path. Calibrate a copy: a
    forward that raises leaves its hooks in place."""
    records: Dict[str, CallRecord] = {}

    def hook_for(name: str, module: nn.Module):
        def hook(_module, inputs):
            x = inputs[0]
            rec = records.setdefault(name, CallRecord("conv" if isinstance(module, Conv)
                                                      else "linear"))
            rec.absmax = max(rec.absmax, float(x.detach().abs().max()))
            if rec.kind == "conv":
                rec.min_hw = min(rec.min_hw, int(min(x.shape[2:])))
                rec.cin = int(x.shape[1])
                rec.kernel = tuple(int(k) for k in module.weight.shape[2:])
            else:
                rec.min_hw = min(rec.min_hw, int(x.numel() // x.shape[-1]))
                rec.cin = int(x.shape[-1])
                rec.kernel = (1,)
            rec.calls += 1
        return hook

    handles = [m.register_forward_pre_hook(hook_for(name, m))
               for name, m in model.named_modules() if isinstance(m, (Conv, Linear))]
    forward = forward_fn or (lambda m, *args: m(*args))
    with torch.no_grad():
        for args in example_args:
            forward(model, *args)
    for handle in handles:
        handle.remove()
    return records


def quantization_plan(records: Dict[str, CallRecord], *, min_hw: int = 32,
                      min_channels: int = 64,
                      skip_paths: Sequence[str] = ("conv_in", "conv_out"),
                      quantize_linear: bool = False, linear_min_tokens: int = 1024,
                      linear_min_features: int = 128,
                      verbose: bool = False) -> List[Tuple[str, CallRecord]]:
    """The (module path, record) pairs the policy quantizes. Raises
    ``ValueError`` when calibration recorded no call, or when the policy
    quantizes nothing."""
    if not records:
        raise ValueError(
            "calibration recorded no conv calls — forward_fn did not route "
            "through nn/layers.Conv (is this a conv model?)")
    plan, kept = [], 0
    for name, rec in records.items():
        leaf = f"{name}.weight"
        skipped = any(s in leaf for s in skip_paths)
        if rec.kind == "linear":
            eligible = (quantize_linear and rec.min_hw >= linear_min_tokens
                        and rec.cin >= linear_min_features and not skipped)
        else:
            eligible = (rec.min_hw >= min_hw and rec.cin >= min_channels
                        and max(rec.kernel, default=1) > 1 and not skipped)
        if eligible:
            plan.append((name, rec))
            if verbose:
                print(f"  int8 {rec.kind}: {leaf}  absmax={rec.absmax:.4g} "
                      f"minhw/tokens={rec.min_hw} cin={rec.cin}")
        else:
            kept += 1
    if not plan:
        raise ValueError(
            f"policy quantized 0 of {kept} calibrated convs — "
            f"relax min_hw ({min_hw}) / min_channels ({min_channels})")
    if verbose:
        print(f"quantized {len(plan)} convs, kept {kept} float")
    return plan


@torch.no_grad()
def apply_plan(model: nn.Module, plan: Sequence[Tuple[str, CallRecord]]) -> nn.Module:
    """Replace, in place, the ``weight`` of each planned module by its int8
    module (``QuantizedConvWeight`` / ``QuantizedLinearWeight``) with the
    recorded absmax as its activation scale; returns ``model``."""
    for name, rec in plan:
        module = model.get_submodule(name)
        weight = module.weight.detach()
        maker = make_quantized_linear if rec.kind == "linear" else make_quantized
        del module.weight
        module.weight = maker(weight, rec.absmax)
    return model


def quantize_model(model: nn.Module, example_args: Sequence[Tuple[Any, ...]], *,
                   forward_fn: Optional[Callable[..., Any]] = None, min_hw: int = 32,
                   min_channels: int = 64,
                   skip_paths: Sequence[str] = ("conv_in", "conv_out"),
                   quantize_linear: bool = False, linear_min_tokens: int = 1024,
                   linear_min_features: int = 128, verbose: bool = False,
                   device: DeviceArg = None) -> nn.Module:
    """A copy of ``model`` on ``device`` (CUDA by default), calibrated on
    ``example_args`` (tuples of positional inputs, moved to ``device``) and
    rewritten by the policy; ``model`` is left untouched. Raises JAX's two
    ``ValueError``s (nothing recorded, nothing quantized)."""
    device = resolve_device(device)
    qmodel = copy.deepcopy(model).to(device).eval()
    placed = [tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
              for args in example_args]
    records = calibrate(qmodel, placed, forward_fn)
    plan = quantization_plan(records, min_hw=min_hw, min_channels=min_channels,
                             skip_paths=skip_paths, quantize_linear=quantize_linear,
                             linear_min_tokens=linear_min_tokens,
                             linear_min_features=linear_min_features, verbose=verbose)
    return apply_plan(qmodel, plan)
