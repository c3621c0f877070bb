"""
Checkpoints in the JAX package's layout and payload (counterpart of the
torch backend of ``fmdm_tpu/utils/checkpoint.py``), so that one file loads in
both packages.

Layout: run dirs hold ``{vae|diff|flow}_last.pt``, ``{vae|diff|flow}_best.pt``
and ``epochs/epochXXXX/epoch.pt``. Payload keys: ``model``, ``ema``,
``optimizer``, ``lr_scheduler``, ``scaler``, ``epoch``, ``best_metric``, and
for a VAE's GAN run ``extra_state`` (``{"disc_params": ...}``) and
``disc_optimizer``.

- ``model`` is a genuine torch ``state_dict`` (dotted names, CPU tensors).
- ``ema`` is stored as the JAX package stores it: a *nested* dict of numpy
  arrays, whose flattened dotted names are the ``state_dict``'s.
- ``optimizer``: the port writes its ``torch.optim`` ``state_dict()``. The
  JAX package writes an optax state flattened to ``{"leaf_i": array,
  "__treedef__": uint8 array}``, where ``__treedef__`` holds a pickled JAX
  treedef. The port never unpickles it (that needs JAX): it keeps such an
  entry as the raw numpy mapping, and :func:`load_optimizer_state` reads an
  ``optax.adamw`` state from it by the leaves' positions, so the port
  resumes a run the JAX package wrote. The JAX package cannot resume from
  the port's optimizer state (it would have to read a ``torch.optim`` state
  dict); its model and EMA weights load in both packages.

Not ported: the orbax backend and the ``*_async`` writers (ROADMAP Queue 1
item 12), which raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# payload entries the JAX package writes as flattened pytrees
TREE_KEYS = ("optimizer", "disc_optimizer", "lr_scheduler", "scaler", "extra_state")
TREEDEF = "__treedef__"


def flatten_params(params: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested parameter dict -> ``{dotted name: leaf}``."""
    flat: Dict[str, Any] = {}
    for name, value in params.items():
        full = f"{prefix}.{name}" if prefix else name
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, full))
        else:
            flat[full] = value
    return flat


def unflatten_params(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_params`."""
    out: Dict[str, Any] = {}
    for name, value in flat.items():
        *parents, leaf = name.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:  # numpy has no bf16 of its own
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def _to_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value, copy=True))


def _cpu_tensors(tree):
    """A nested dict/list of an optimizer's state with its tensors on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _cpu_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_tensors(v) for v in tree)
    return tree


def is_jax_tree_map(value) -> bool:
    """Whether a payload entry is the JAX package's flattened pytree."""
    return isinstance(value, Mapping) and TREEDEF in value


# ---------------------------------------------------------------------------
# backend
# ---------------------------------------------------------------------------

def set_checkpoint_backend(name: str) -> None:
    """Accept the JAX package's backend names; only "torch" is ported."""
    base, _, suffix = str(name).partition("_")
    if base not in ("torch", "orbax") or suffix not in ("", "async"):
        raise ValueError(f"Unknown checkpoint backend '{name}'")
    if name != "torch":
        raise NotImplementedError(f"checkpoint backend '{name}': only 'torch' is ported; the "
                                  f"orbax and async backends wait (ROADMAP Queue 1 item 12)")


def _check_backend(backend: Optional[str]) -> None:
    if backend is not None:
        set_checkpoint_backend(backend)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _state_dict(value) -> Mapping[str, Any]:
    return value.state_dict() if isinstance(value, torch.nn.Module) else value


def save_checkpoint(state: Dict[str, Any], path, backend: Optional[str] = None) -> None:
    """Write ``state`` to ``path`` atomically (a unique temp file, then a
    rename). ``model`` and ``ema`` take a module or a (flat or nested)
    mapping of tensors or arrays; ``optimizer`` a ``torch.optim`` optimizer,
    its ``state_dict()`` or an entry read from a checkpoint; other keys are
    stored as given."""
    _check_backend(backend)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload: Dict[str, Any] = {}
    for key, value in state.items():
        if key == "model" and value is not None:
            payload[key] = {k: _to_tensor(v) for k, v in flatten_params(_state_dict(value)).items()}
        elif key == "ema" and value is not None:
            payload[key] = unflatten_params(
                {k: _to_numpy(v) for k, v in flatten_params(_state_dict(value)).items()})
        elif isinstance(value, torch.optim.Optimizer):
            payload[key] = _cpu_tensors(value.state_dict())
        else:
            payload[key] = value
    fd, tmp_name = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp", dir=str(path.parent))
    tmp = Path(tmp_name)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(payload, fh)
        tmp.replace(path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def clone_checkpoint(src, dst, backend: Optional[str] = None) -> None:
    """Duplicate a written checkpoint without re-serializing it: a hardlink
    (a copy across devices) to a unique temp name, then a rename."""
    _check_backend(backend)
    src, dst = Path(src), Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(prefix=dst.name + ".", suffix=".tmp", dir=str(dst.parent))
    os.close(fd)
    tmp = Path(tmp_name)
    try:
        tmp.unlink()  # os.link needs the target path free
        try:
            os.link(src, tmp)
        except OSError:
            shutil.copyfile(src, tmp)
        tmp.replace(dst)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def save_checkpoint_with_mirrors(state: Dict[str, Any], primary, mirrors=(),
                                 backend: Optional[str] = None) -> None:
    """Serialize ``state`` once to ``primary``, then hardlink-clone the file
    to each mirror path (last -> best / epoch)."""
    save_checkpoint(state, primary, backend)
    for mirror in mirrors:
        clone_checkpoint(primary, mirror, backend)


def load_checkpoint(path) -> Dict[str, Any]:
    """Load a checkpoint written by either package (or a bare state dict).

    ``model`` and ``ema`` come back as flat ``{dotted name: CPU tensor}``
    state dicts; a JAX flattened pytree (``optimizer``, ``lr_scheduler``, ...)
    as its raw numpy mapping, its treedef bytes never unpickled; every other
    entry as stored."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(f"{path} is a directory (an orbax checkpoint); the orbax "
                                  f"backend waits (ROADMAP Queue 1 item 12)")
    # weights_only=False, as the JAX package loads: the JAX package's `ema`
    # (a nested dict of numpy arrays) and its flattened pytrees under
    # `optimizer`, `disc_optimizer`, `lr_scheduler`, `scaler` and
    # `extra_state` (numpy arrays, the treedef as uint8 bytes) are numpy
    # objects, which torch's weights-only unpickler refuses. `model` alone
    # would load weights-only. Load only checkpoints you trust.
    payload = torch.load(path, map_location="cpu", weights_only=False)
    out: Dict[str, Any] = {}
    for key, value in payload.items():
        if key in ("model", "ema") and isinstance(value, Mapping):
            out[key] = {k: _to_tensor(v) for k, v in flatten_params(value).items()}
        else:
            out[key] = value
    return out


def load_model_params(path, expected: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The model's flat state dict from a checkpoint (``payload['model']`` or
    a bare state dict), optionally checked against ``expected`` (a module or
    a state dict): every expected name present with its shape."""
    payload = load_checkpoint(path)
    params = payload.get("model")
    if params is None:
        params = {k: _to_tensor(v) for k, v in flatten_params(payload).items()
                  if isinstance(v, (torch.Tensor, np.ndarray))}
    if expected is not None:
        exp = _state_dict(expected)
        mismatched = [f"{k}: ckpt={tuple(params[k].shape)} model={tuple(exp[k].shape)}"
                      for k in exp if k in params and tuple(params[k].shape) != tuple(exp[k].shape)]
        missing = [k for k in exp if k not in params]
        if mismatched or missing:
            raise RuntimeError(f"Checkpoint mismatch: missing={missing[:10]} "
                               f"shape_mismatch={mismatched[:10]}")
    return params


_JAX_STATE = "the optimizer state written by the JAX package (a flattened optax state)"


def _optimizer_step(optimizer: torch.optim.Optimizer) -> int:
    """The step count of a loaded ``torch.optim`` state (0 without state)."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def _tree_leaves(entry: Mapping[str, Any]) -> list:
    """The leaves of a JAX flattened pytree, in ``tree_flatten`` order."""
    n_leaves = len(entry) - 1
    if set(entry) != {TREEDEF, *(f"leaf_{i}" for i in range(n_leaves))}:
        raise ValueError(f"{_JAX_STATE} is not a flattened pytree of leaf_0.. leaves")
    return [np.asarray(entry[f"leaf_{i}"]) for i in range(n_leaves)]


def _tree_order(names) -> list:
    """Positions of dotted ``names`` in ``tree_flatten`` order: dict keys
    sorted level by level, the order of the names' component tuples."""
    return sorted(range(len(names)), key=lambda i: tuple(names[i].split(".")))


def _adamw_from_optax(optimizer: torch.optim.Optimizer, entry: Mapping[str, Any],
                      model: torch.nn.Module, constant_rate: bool) -> int:
    """Set AdamW's moments and step from the flattened state of
    ``optax.adamw(rate, ...)``: ``chain(scale_by_adam, add_decayed_weights,
    scale_by_learning_rate)``, whose leaves are Adam's count, ``mu`` and
    ``nu`` in ``tree_flatten`` order, then, for a schedule, the schedule's
    count: 2n + 2 leaves over n parameters, or 2n + 1 at a
    ``constant_rate`` (the discriminator's), which keeps no count. Returns
    the schedule's count, or Adam's at a constant rate."""
    leaves = _tree_leaves(entry)
    n_leaves = len(leaves)
    named = list(model.named_parameters())
    n = len(named)
    want = 2 * n + 1 if constant_rate else 2 * n + 2
    if n_leaves != want:
        raise ValueError(
            f"{_JAX_STATE} has {n_leaves} leaves; optax.adamw over this model's {n} "
            f"parameters has {want} {'at a constant rate' if constant_rate else 'with a schedule'}"
            f" (another optimizer is not resumable here)")
    counts = (leaves[0],) if constant_rate else (leaves[0], leaves[-1])
    if any(c.shape != () or not np.issubdtype(c.dtype, np.integer) for c in counts):
        raise ValueError(f"{_JAX_STATE}: its counts are not integer scalars: "
                         f"{[(c.dtype, c.shape) for c in counts]}")
    if int(counts[0]) != int(counts[-1]):
        raise ValueError(f"{_JAX_STATE}: Adam's count {int(counts[0])} disagrees with the "
                         f"schedule's {int(counts[1])}")
    order = _tree_order([name for name, _ in named])
    group_params = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if group_params != {id(p) for _, p in named}:
        raise ValueError(f"{_JAX_STATE}: the optimizer's parameters are not the model's")
    mus, nus = leaves[1:n + 1], leaves[n + 1:2 * n + 1]
    step = int(counts[0])
    for pos, i in enumerate(order):
        name, param = named[i]
        for what, leaf in (("mu", mus[pos]), ("nu", nus[pos])):
            if tuple(leaf.shape) != tuple(param.shape):
                raise ValueError(f"{_JAX_STATE}: leaf {what}[{pos}] has shape {leaf.shape}; "
                                 f"the parameter at that position, {name}, has "
                                 f"{tuple(param.shape)}")
        optimizer.state[param] = {
            "step": torch.tensor(float(step)),
            "exp_avg": torch.from_numpy(np.array(mus[pos], copy=True)).to(param.device, param.dtype),
            "exp_avg_sq": torch.from_numpy(np.array(nus[pos], copy=True)).to(param.device,
                                                                               param.dtype),
        }
    return int(counts[-1])


def load_disc_params(discriminator: torch.nn.Module, entry: Mapping[str, Any]) -> None:
    """Load a payload's ``extra_state`` into the GAN's discriminator: the
    port's ``{"disc_params": {dotted name: tensor}}``, or the JAX package's
    flattened pytree of ``{"disc_params": tree}``, read by leaf position
    against the discriminator's state dict names (shapes checked)."""
    if is_jax_tree_map(entry):
        leaves = _tree_leaves(entry)
        current = discriminator.state_dict()
        names = list(current)
        if len(leaves) != len(names):
            raise ValueError(f"the JAX extra_state has {len(leaves)} leaves; the "
                             f"discriminator has {len(names)} entries")
        state = {}
        for leaf, i in zip(leaves, _tree_order(names)):
            want = tuple(current[names[i]].shape)
            if tuple(leaf.shape) != want:
                raise ValueError(f"the JAX extra_state's leaf for {names[i]} has shape "
                                 f"{leaf.shape}; the discriminator's is {want}")
            state[names[i]] = _to_tensor(leaf)
    else:
        state = {k: _to_tensor(v) for k, v in flatten_params(entry["disc_params"]).items()}
    discriminator.load_state_dict(state, strict=True)


def load_optimizer_state(optimizer: torch.optim.Optimizer, entry,
                         model: Optional[torch.nn.Module] = None, *,
                         constant_rate: bool = False) -> int:
    """Load a payload's ``optimizer`` (or ``disc_optimizer``) entry into
    ``optimizer`` and return the step the learning-rate schedule resumes
    from: a ``torch.optim`` state dict as it is, or the ``optax.adamw``
    state the JAX package writes into ``torch.optim.AdamW`` (which needs
    ``model``, whose parameters the optimizer holds; ``constant_rate`` for
    the discriminator's, which has no schedule). Any other optax structure
    raises a ``ValueError``."""
    if is_jax_tree_map(entry):
        if model is None or not isinstance(optimizer, torch.optim.AdamW):
            raise ValueError(f"{_JAX_STATE} loads only into torch.optim.AdamW, with the model "
                             f"whose parameters it holds")
        return _adamw_from_optax(optimizer, entry, model, constant_rate)
    optimizer.load_state_dict(entry)
    return _optimizer_step(optimizer)


def maybe_load_checkpoint(path) -> Tuple[int, float, Dict[str, Any]]:
    """(start_epoch, best_metric, payload) of a checkpoint path, or
    (1, inf, {}) when the path is empty or missing."""
    if not path:
        return 1, float("inf"), {}
    path = Path(path)
    if not path.exists():
        return 1, float("inf"), {}
    payload = load_checkpoint(path)
    return (int(payload.get("epoch", 0)) + 1, float(payload.get("best_metric", float("inf"))),
            payload)


def latest_checkpoint(directory, prefix: str) -> Optional[Path]:
    """{prefix}_best.pt over {prefix}_last.pt, else None."""
    directory = Path(directory)
    for name in (f"{prefix}_best.pt", f"{prefix}_last.pt"):
        if (directory / name).exists():
            return directory / name
    return None
