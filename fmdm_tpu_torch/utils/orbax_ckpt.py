"""
The ``orbax`` checkpoint backend of the port (counterpart of
``fmdm_tpu/utils/orbax_ckpt.py``, whose name and the config's backend name
it keeps): the payload of ``utils/checkpoint.py`` written as a directory by
``torch.distributed.checkpoint`` (DCP), under the run dir's usual names
(``diff_last.pt`` etc.).

    training.checkpoint_backend: "orbax"      # or "orbax_async"

The directory holds DCP's ``.metadata`` and one ``__0_0.distcp``. Every
entry is a tensor under a path key: ``model/<dotted name>`` and
``ema/<dotted name>`` for the weights, ``<key>/...`` for the tensors of a
nested entry (an optimizer's state), where ``#<n>`` marks an integer key;
any other leaf (a number, a string, ``None``, a list, a numpy array, an
empty dict) is pickled into a uint8 tensor under ``<path>/__object__``. A
write is staged in a sibling directory and swapped in. It is made by one
process with no collective (DCP's ``no_dist``): under data parallelism only
rank 0 saves, as in the JAX package, and the other ranks must not wait.

:func:`read_checkpoint` builds its load template from the directory's
metadata, so it needs no process group and no model. A JAX orbax directory
(OCDBT: ``manifest.ocdbt``, ``_METADATA``, ``ocdbt.process_0/``) cannot be
read without ``orbax`` and ``tensorstore`` and raises a ``ValueError``
that names the way across: load it in the JAX package and save it with the
``torch`` backend.
"""

from __future__ import annotations

import pickle
import shutil
import tempfile
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

SEP = "/"
OBJECT = "__object__"
JAX_ORBAX_MARKERS = ("manifest.ocdbt", "_METADATA", "ocdbt.process_0", "_CHECKPOINT_METADATA")


def is_orbax_checkpoint(path) -> bool:
    """A directory written by this backend (DCP's ``.metadata`` inside)."""
    return (Path(path) / ".metadata").is_file()


def _part(key) -> str:
    if isinstance(key, bool) or not isinstance(key, (str, int)):
        raise TypeError(key)
    if isinstance(key, int):
        return f"#{key}"
    if SEP in key or key.startswith("#") or key == OBJECT:
        raise TypeError(key)
    return key


def _flatten(value, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(value, torch.Tensor):
        out[prefix] = value
        return
    if isinstance(value, Mapping) and value:
        try:
            parts = {_part(k): v for k, v in value.items()}
        except TypeError:
            parts = None
        if parts is not None:
            for part, v in parts.items():
                _flatten(v, f"{prefix}{SEP}{part}", out)
            return
    raw = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
    out[f"{prefix}{SEP}{OBJECT}"] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)


def _unflatten(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, tensor in flat.items():
        parts = key.split(SEP)
        if parts[-1] == OBJECT:
            parts, value = parts[:-1], pickle.loads(tensor.numpy().tobytes())
        else:
            value = tensor
        keys = [int(p[1:]) if p.startswith("#") else p for p in parts]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return out


def write_checkpoint(host: Mapping[str, Any], path: Path) -> None:
    """Write a host state (``utils/checkpoint.py::_snapshot``) as a DCP
    directory at ``path``: staged in a sibling directory, then swapped in."""
    import torch.distributed.checkpoint as dcp

    from fmdm_tpu_torch.utils.checkpoint import replace_path

    flat: Dict[str, torch.Tensor] = {}
    for key, value in host.items():
        if key in ("model", "ema") and value is not None:
            for name, tensor in value.items():
                flat[f"{key}{SEP}{name}"] = torch.as_tensor(tensor)
        else:
            _flatten(value, _part(key), flat)
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    stage = Path(tempfile.mkdtemp(prefix=path.name + ".", suffix=".tmp", dir=str(path.parent)))
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*single process.*")
            dcp.save(flat, storage_writer=dcp.FileSystemWriter(str(stage / "d")), no_dist=True)
        replace_path(stage / "d", path)
    finally:
        shutil.rmtree(stage, ignore_errors=True)


def _refuse_foreign(path: Path) -> None:
    if is_orbax_checkpoint(path):
        return
    names = {p.name for p in path.iterdir()}
    if names & set(JAX_ORBAX_MARKERS):
        raise ValueError(
            f"{path} is the JAX package's orbax checkpoint (OCDBT/zarr), which only orbax and "
            f"tensorstore read. Load it in the JAX package (fmdm_tpu.utils.checkpoint."
            f"load_checkpoint) and save it with the 'torch' checkpoint backend, whose single "
            f"file both packages read.")
    raise ValueError(f"{path} is a directory but not a checkpoint of the 'orbax' backend "
                     f"(no .metadata)")


def read_checkpoint(path) -> Dict[str, Any]:
    """The payload of a DCP directory: ``model`` and ``ema`` as flat state
    dicts of CPU tensors, nested entries and objects as they were saved."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = Path(path)
    _refuse_foreign(path)
    reader = dcp.FileSystemReader(str(path))
    template: Dict[str, torch.Tensor] = {}
    for key, meta in reader.read_metadata().state_dict_metadata.items():
        if not isinstance(meta, TensorStorageMetadata):
            raise ValueError(f"{path}: entry {key} is not a tensor; not written by this backend")
        template[key] = torch.empty(meta.size, dtype=meta.properties.dtype)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        dcp.load(template, storage_reader=reader, no_dist=True)
    out: Dict[str, Any] = {}
    weights = {k: v for k, v in template.items() if k.split(SEP, 1)[0] in ("model", "ema")
               and not k.endswith(SEP + OBJECT)}
    for key, tensor in weights.items():
        top, name = key.split(SEP, 1)
        out.setdefault(top, {})[name] = tensor
    out.update(_unflatten({k: v for k, v in template.items() if k not in weights}))
    return out

