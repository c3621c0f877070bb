"""
Checkpoints in the JAX package's layout and payload (counterpart of
``fmdm_tpu/utils/checkpoint.py``), so that one file loads in both packages,
and its four backends.

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

Backends (``training.checkpoint_backend``, :func:`set_checkpoint_backend`):

- ``torch``: one ``torch.save`` file, written atomically (a unique temp
  file, then a rename). Both packages read it.
- ``orbax``: a directory written by ``torch.distributed.checkpoint``
  (``utils/orbax_ckpt.py``; the JAX package's name is kept). Only the port
  reads it; :func:`load_checkpoint` recognizes it by its ``.metadata``.
- ``torch_async``, ``orbax_async``: the same files, serialized and written by
  one background writer thread. The caller's thread takes the snapshot: every
  tensor is copied into storage of its own (a CPU tensor cloned, a CUDA
  tensor copied into pinned host memory without blocking, the copies' end
  marked by an event the writer waits on), so an in-place optimizer step
  after ``save_checkpoint`` returns never reaches the file.
  :func:`flush_checkpoint_writes` waits for every pending write and raises
  the first error a write hit; it also runs at exit.

A JAX orbax directory (OCDBT and zarr) is refused with a ``ValueError``:
reading it needs ``orbax`` and ``tensorstore``. Load it in the JAX package
and save it with the ``torch`` backend, whose file both packages read.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

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


def is_jax_tree_map(value) -> bool:
    """Whether a payload entry is the JAX package's flattened pytree."""
    return isinstance(value, Mapping) and TREEDEF in value


# ---------------------------------------------------------------------------
# backend and writer
# ---------------------------------------------------------------------------

BACKENDS = ("torch", "torch_async", "orbax", "orbax_async")
_BACKEND = "torch"
_WRITER = None
_PENDING: list = []


def _split_backend(name: str) -> Tuple[str, bool]:
    base, _, suffix = str(name).partition("_")
    if base not in ("torch", "orbax") or suffix not in ("", "async"):
        raise ValueError(f"Unknown checkpoint backend '{name}'")
    return base, suffix == "async"


def set_checkpoint_backend(name: str) -> None:
    """Select the backend of later saves: one of :data:`BACKENDS`."""
    global _BACKEND
    _split_backend(name)
    _BACKEND = str(name)


def get_checkpoint_backend() -> str:
    return _BACKEND


def _writer():
    """The one background writer thread, created at the first async save;
    :func:`flush_checkpoint_writes` runs at exit."""
    global _WRITER
    if _WRITER is None:
        import atexit
        from concurrent.futures import ThreadPoolExecutor

        _WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-write")
        atexit.register(flush_checkpoint_writes)
    return _WRITER


def _submit(fn: Callable, *args) -> None:
    _PENDING.append(_writer().submit(fn, *args))


def flush_checkpoint_writes() -> None:
    """Wait for every pending async write; raise the first error a write hit
    (a dropped checkpoint must not pass for a saved one)."""
    global _PENDING
    pending, _PENDING = _PENDING, []
    errors = []
    for future in pending:
        try:
            future.result()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
    if errors:
        raise errors[0]


# ---------------------------------------------------------------------------
# snapshot: the payload's tensors on the host
# ---------------------------------------------------------------------------

def _state_dict(value) -> Mapping[str, Any]:
    return value.state_dict() if isinstance(value, torch.nn.Module) else value


class _HostCopy:
    """Brings tensors to the host. Without ``owned`` a CPU tensor is kept as
    it is and a CUDA tensor copied with ``.cpu()``. With ``owned`` every
    tensor gets storage of its own: a CPU tensor is cloned, a CUDA tensor is
    copied into pinned memory without blocking; :meth:`mark` records one
    event per card after the copies, and :meth:`wait` blocks on them."""

    def __init__(self, owned: bool):
        self.owned = owned
        self.devices = set()
        self.events: List[Any] = []

    def __call__(self, value):
        if isinstance(value, np.ndarray):
            return np.array(value, copy=True) if self.owned else value
        if not isinstance(value, torch.Tensor):
            return value
        value = value.detach()
        if value.device.type == "cpu":
            return value.clone() if self.owned else value
        if not self.owned or value.device.type != "cuda":
            return value.cpu()
        out = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        out.copy_(value, non_blocking=True)
        self.devices.add(value.device)
        return out

    def mark(self) -> "_HostCopy":
        for device in self.devices:
            with torch.cuda.device(device):
                event = torch.cuda.Event()
                event.record()
                self.events.append(event)
        return self

    def wait(self) -> None:
        for event in self.events:
            event.synchronize()


def _map_leaves(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _host_state(state: Mapping[str, Any], copy: _HostCopy) -> Dict[str, Any]:
    """``state`` with its modules and optimizers as state dicts (``model``
    and ``ema`` flattened to dotted names) and every tensor through
    ``copy``."""
    out: Dict[str, Any] = {}
    for key, value in state.items():
        if key in ("model", "ema") and value is not None:
            out[key] = {k: copy(v) for k, v in flatten_params(_state_dict(value)).items()}
        elif isinstance(value, torch.optim.Optimizer):
            out[key] = _map_leaves(value.state_dict(), copy)
        else:
            out[key] = _map_leaves(value, copy)
    return out


def _snapshot(state: Mapping[str, Any], owned: bool) -> Tuple[Dict[str, Any], _HostCopy]:
    """(host state, its copier) of ``state``; with ``owned`` nothing in it
    shares storage with ``state`` once the copier's ``wait`` returns."""
    copy = _HostCopy(owned)
    host = _host_state(state, copy)
    return host, copy.mark()


def _torch_payload(host: Mapping[str, Any]) -> Dict[str, Any]:
    """The ``torch.save`` payload of a host state: ``model`` as a flat
    state dict of tensors, ``ema`` as the JAX package's nested numpy dict,
    the rest as it is."""
    payload: Dict[str, Any] = {}
    for key, value in host.items():
        if key == "model" and value is not None:
            payload[key] = {k: _to_tensor(v) for k, v in value.items()}
        elif key == "ema" and value is not None:
            payload[key] = unflatten_params({k: _to_numpy(v) for k, v in value.items()})
        else:
            payload[key] = value
    return payload


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _write_torch(host: Mapping[str, Any], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp", dir=str(path.parent))
    tmp = Path(tmp_name)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(_torch_payload(host), fh)
        replace_path(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def _write(host: Mapping[str, Any], copy: Optional[_HostCopy], primary, mirrors,
           base: str) -> None:
    """Write a host state to ``primary`` under ``base``, then clone it to
    each mirror; nothing is cloned when the write fails."""
    if copy is not None:
        copy.wait()
    if base == "orbax":
        from fmdm_tpu_torch.utils import orbax_ckpt

        orbax_ckpt.write_checkpoint(host, Path(primary))
    else:
        _write_torch(host, Path(primary))
    for mirror in mirrors:
        _clone(Path(primary), Path(mirror))


def save_checkpoint(state: Dict[str, Any], path, backend: Optional[str] = None) -> None:
    """Write ``state`` to ``path`` under ``backend`` (default: the selected
    one). ``model`` and ``ema`` take a module or a (flat or nested) mapping
    of tensors or arrays; ``optimizer`` a ``torch.optim`` optimizer, its
    ``state_dict()`` or an entry read from a checkpoint; other keys are
    stored as given. Under an async backend this returns once the snapshot
    is taken, and the write is left to the writer thread."""
    save_checkpoint_with_mirrors(state, path, (), backend)


def _clone(src: Path, dst: Path) -> None:
    """A file or a directory duplicated by hardlinks (copies across
    devices) under a unique temp name, then swapped in, so a later
    overwrite of ``src`` leaves the clone as it was."""
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=dst.name + ".", suffix=".tmp", dir=str(dst.parent)))
    try:
        if src.is_dir():
            shutil.copytree(src, tmp / "d", copy_function=_link_or_copy)
            replace_path(tmp / "d", dst)
        else:
            _link_or_copy(src, tmp / "f")
            replace_path(tmp / "f", dst)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _link_or_copy(src, dst) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def replace_path(new: Path, dst: Path) -> None:
    """Put ``new`` (a file or a directory) at ``dst``, replacing what is
    there: a file by a rename, a directory by moving the old one aside
    first."""
    if not dst.is_dir() and not new.is_dir():
        new.replace(dst)
        return
    old = None
    if dst.exists():
        old = Path(tempfile.mkdtemp(prefix=dst.name + ".", suffix=".old", dir=str(dst.parent)))
        dst.replace(old / "x")
    new.replace(dst)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def clone_checkpoint(src, dst, backend: Optional[str] = None) -> None:
    """Duplicate a written checkpoint (a file or a directory) without
    re-serializing it; under an async backend the clone is queued behind
    the writes before it."""
    _, is_async = _split_backend(backend or _BACKEND)
    if is_async:
        _submit(_clone, Path(src), Path(dst))
        return
    _clone(Path(src), Path(dst))


def save_checkpoint_with_mirrors(state: Dict[str, Any], primary, mirrors=(),
                                 backend: Optional[str] = None) -> None:
    """Serialize ``state`` once to ``primary``, then hardlink-clone it to
    each mirror path (last -> best / epoch). Under an async backend the
    save and its clones are one writer task: a failed save leaves no
    clone."""
    base, is_async = _split_backend(backend or _BACKEND)
    mirrors = tuple(Path(m) for m in mirrors)
    if is_async:
        host, copy = _snapshot(state, owned=True)
        _submit(_write, host, copy, Path(primary), mirrors, base)
        return
    host, _ = _snapshot(state, owned=False)
    _write(host, None, Path(primary), mirrors, base)


def load_checkpoint(path) -> Dict[str, Any]:
    """Load a checkpoint written by either package's ``torch`` backend, the
    port's ``orbax`` backend (a directory), or a bare state dict.

    ``model`` and ``ema`` come back as flat ``{dotted name: CPU tensor}``
    state dicts; a JAX flattened pytree (``optimizer``, ``lr_scheduler``, ...)
    as its raw numpy mapping, its treedef bytes never unpickled; every other
    entry as stored."""
    path = Path(path)
    if path.is_dir():
        from fmdm_tpu_torch.utils import orbax_ckpt

        payload = orbax_ckpt.read_checkpoint(path)
    else:
        # weights_only=False, as the JAX package loads: the JAX package's
        # `ema` (a nested dict of numpy arrays) and its flattened pytrees
        # under `optimizer`, `disc_optimizer`, `lr_scheduler`, `scaler` and
        # `extra_state` (numpy arrays, the treedef as uint8 bytes) are numpy
        # objects, which torch's weights-only unpickler refuses. `model`
        # alone would load weights-only. Load only checkpoints you trust.
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
