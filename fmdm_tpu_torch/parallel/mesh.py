"""
Data parallelism (counterpart of ``fmdm_tpu/parallel/mesh.py``): the data
mesh, the process group of ``torchrun``, and the collectives the train
steps use.

Two forms of mesh, as in the JAX package:

- **one process, several cards** (:func:`create_mesh_for_batch`): the
  largest count of visible cards that divides the batch. The sampling
  engines split each batch over them and keep one replica of the model per
  card.
- **one rank per card** (:func:`create_data_mesh` under ``torchrun``):
  every rank feeds its own rows; a train step over P ranks is one step of
  one process on the global batch, the ranks' batches concatenated in rank
  order (the JAX package's ``make_array_from_process_local_data``).

Two-axis meshes (:class:`Mesh2D`), ``("data", "seq")`` for sequence
parallelism and ``("data", "model")`` for tensor parallelism, come in the
same two forms: a grid of devices in one process
(:func:`create_dp_sp_mesh`, :func:`create_dp_tp_mesh`), or under a process
group one rank per card on ``init_device_mesh``, whose named dims give the
sub-groups the ring and the tensor-parallel collectives use
(:func:`create_dp_sp_mesh_global`, :func:`create_dp_tp_mesh_global`). As in
the JAX package the ``seq`` and ``model`` axes stay inside a node
(consecutive ranks) and ``data`` spans the nodes.

    python -m torch.distributed.run --nproc_per_node N -m fmdm_tpu_torch.train --config CFG

:func:`maybe_initialize_distributed` reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and joins the group over NCCL on ``cuda:LOCAL_RANK``, or
over gloo on the CPU; a group that is already initialized is kept.
``FMDM_DIST_TIMEOUT`` (seconds, default 600) bounds every collective, so a
deadlock fails instead of hanging.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from datetime import timedelta
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.device import DeviceArg, resolve_device

AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A data-parallel mesh: this process's ``devices`` (one shard each) and
    the ranks of the process group it spans (``group`` None for one
    process)."""

    devices: Tuple[torch.device, ...]
    process_count: int = 1
    process_index: int = 0
    group: Any = None
    axis_names = (AXIS,)

    @property
    def size(self) -> int:
        """Shards over all processes (``mesh.devices.size`` in JAX)."""
        return len(self.devices) * self.process_count

    def __deepcopy__(self, memo) -> "DataMesh":
        return self  # a module copied with a mesh attribute shares the group


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def group_active() -> bool:
    """Is a process group initialized (torchrun's, or the caller's)?"""
    dist = _dist()
    return dist is not None and dist.is_initialized()


def _has_group(mesh: Optional[DataMesh]) -> bool:
    return mesh is not None and mesh.group is not None


def process_count() -> int:
    return _dist().get_world_size() if group_active() else 1


def process_index() -> int:
    return _dist().get_rank() if group_active() else 0


def is_main_process() -> bool:
    return process_index() == 0


def spans_processes(mesh: Optional[DataMesh]) -> bool:
    """Does this mesh span ranks of a process group?"""
    return mesh is not None and mesh.process_count > 1


def timeout() -> timedelta:
    return timedelta(seconds=float(os.environ.get("FMDM_DIST_TIMEOUT", "600")))


def rank_device(device: DeviceArg = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for ``None`` or a ``cuda``
    without an index, else ``device``."""
    if device is None or torch.device(device) == torch.device("cuda"):
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(device)


TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(device: DeviceArg = None) -> bool:
    """Join torchrun's process group when its environment is set (a group
    of one rank too): NCCL for a CUDA ``device`` (default
    ``cuda:LOCAL_RANK``, made current), gloo for the CPU. Without it, or
    with a group already initialized, nothing is done. Returns whether it
    initialized the group."""
    dist = _dist()
    if dist is None or dist.is_initialized() or not all(k in os.environ for k in TORCHRUN_ENV):
        return False
    world = int(os.environ["WORLD_SIZE"])
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world, timeout=timeout())
    return True


def describe_group() -> str:
    """One line on the process group (for the trainers' logs)."""
    if not group_active():
        return "Process group: none (one process)"
    return (f"Process group: backend {_dist().get_backend()}, rank {process_index()} of "
            f"{process_count()}")


def destroy_distributed() -> None:
    if group_active():
        _dist().destroy_process_group()


def _collective_device() -> torch.device:
    """Where a collective's host data travels: a CUDA tensor under NCCL, a
    CPU tensor otherwise."""
    if _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_string(value: str, max_len: int = 1024) -> str:
    """Agree on a host string across ranks (rank 0 wins), as JAX's: the
    UTF-8 bytes cut at ``max_len`` and trailing NULs stripped."""
    if not group_active():
        return value
    data = np.zeros((max_len,), np.uint8)
    raw = value.encode("utf-8")[:max_len]
    data[: len(raw)] = np.frombuffer(raw, np.uint8)
    buf = torch.from_numpy(data).to(_collective_device())
    _dist().broadcast(buf, src=0)
    return bytes(buf.cpu().numpy().tobytes()).rstrip(b"\x00").decode("utf-8")


def local_devices() -> List[torch.device]:
    """The visible cards. Without one this raises, as every entry point of
    the port does: a CPU mesh is asked for by passing its devices."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence[DeviceArg]] = None) -> DataMesh:
    """A one-process mesh over ``devices`` (default: the visible cards,
    which must exist), the first ``n_devices`` of them."""
    devs = [resolve_device(d) for d in devices] if devices is not None else local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return DataMesh(tuple(devs))


def create_mesh_for_batch(batch_size: int,
                          devices: Optional[Sequence[DeviceArg]] = None) -> DataMesh:
    """A one-process mesh over the largest count of ``devices`` (default:
    the visible cards) that divides ``batch_size``."""
    devs = [resolve_device(d) for d in devices] if devices is not None else local_devices()
    n = len(devs)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return create_mesh(n, devs)


def create_data_mesh(batch_size: int, device: DeviceArg = None) -> DataMesh:
    """The trainers' mesh: without a process group
    :func:`create_mesh_for_batch`; under one, one rank per card
    (``device``, default ``cuda:LOCAL_RANK``), each feeding ``batch_size``
    rows of the global batch of ``process_count() * batch_size``."""
    if not group_active():
        return create_mesh_for_batch(batch_size)
    return DataMesh((rank_device(device),), process_count(), process_index(),
                    _dist().group.WORLD)


# ---------------------------------------------------------------------------
# Two-axis meshes: ("data", "seq") and ("data", "model")
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh2D:
    """A mesh of two named axes, ``("data", axis)``.

    One-process form: ``devices`` holds the grid (``shape[0]`` rows of
    ``shape[1]`` devices). Rank form: ``device_mesh`` is the
    ``DeviceMesh`` over the ranks (rank = data index * shape[1] + axis
    index) and ``devices`` this rank's card, as ``((device,),)``."""

    axis_names: Tuple[str, str]
    shape: Tuple[int, int]
    devices: Tuple[Tuple[torch.device, ...], ...]
    device_mesh: Any = None

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    @property
    def spans_ranks(self) -> bool:
        return self.device_mesh is not None

    def group(self, axis: str):
        """The rank form's process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (rank form)."""
        return int(self.device_mesh.get_local_rank(axis))

    def batch_mesh(self) -> DataMesh:
        """The :class:`DataMesh` a train step reduces its batch over (rank
        form): every rank under ``seq`` (rows ride data x seq), this rank's
        ``data`` line under ``model`` (the ranks of a ``model`` line share
        their rows)."""
        dev = self.devices[0][0]
        if self.axis_names[1] == "seq":
            return DataMesh((dev,), process_count(), process_index(), _dist().group.WORLD)
        return DataMesh((dev,), self.shape[0], self.coordinate("data"), self.group("data"))

    def __deepcopy__(self, memo) -> "Mesh2D":
        return self


def _grid(devices: Sequence[torch.device], rows: int, cols: int):
    return tuple(tuple(devices[r * cols:(r + 1) * cols]) for r in range(rows))


def _local_world_size() -> int:
    """Ranks on this node (torchrun's ``LOCAL_WORLD_SIZE``; all ranks when
    it is not set)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def _rank_mesh(axis: str, n_axis: int, what: str, device: DeviceArg) -> Mesh2D:
    """The rank form over the whole group: (world / n_axis, n_axis), the
    ``axis`` lines inside a node."""
    from torch.distributed.device_mesh import init_device_mesh

    n_local = _local_world_size()
    if n_local % n_axis != 0:
        raise ValueError(f"{what}={n_axis} must divide the per-process device count {n_local}")
    dev = rank_device(device)
    shape = (process_count() // n_axis, n_axis)
    device_mesh = init_device_mesh(dev.type, shape, mesh_dim_names=("data", axis))
    return Mesh2D(("data", axis), shape, ((dev,),), device_mesh)


def create_dp_sp_mesh(batch_size: int, sp: int,
                      devices: Optional[Sequence[DeviceArg]] = None) -> Mesh2D:
    """dp x sp mesh in one process (JAX's single-host form) over ``devices``
    (default: the visible cards): 'seq' is the token ring axis and the batch
    shards over (data, seq) jointly, so the batch must divide data * seq."""
    devs = [resolve_device(d) for d in devices] if devices is not None else local_devices()
    n_dev = len(devs)
    if n_dev % sp != 0:
        raise ValueError(f"sequence_parallel={sp} must divide the device count {n_dev}")
    n_data = n_dev // sp
    while n_data > 1 and batch_size % (n_data * sp) != 0:
        n_data -= 1
    if batch_size % (n_data * sp) != 0:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by sequence_parallel={sp} "
            "(batch shards over the data x seq mesh)"
        )
    return Mesh2D(("data", "seq"), (n_data, sp), _grid(devs, n_data, sp))


def create_dp_sp_mesh_global(batch_size: int, sp: int, device: DeviceArg = None) -> Mesh2D:
    """The trainers' dp x sp mesh: without a process group
    :func:`create_dp_sp_mesh` over the visible cards; under one, every rank
    (``device``, default ``cuda:LOCAL_RANK``) a point of (world / sp, sp),
    feeding its own ``batch_size`` rows."""
    if not group_active():
        return create_dp_sp_mesh(batch_size, sp)
    return _rank_mesh("seq", sp, "sequence_parallel", device)


def create_dp_tp_mesh(n_data: int, n_model: int,
                      devices: Optional[Sequence[DeviceArg]] = None) -> Mesh2D:
    """dp x tp mesh in one process over the first n_data * n_model of
    ``devices`` (default: the visible cards)."""
    devs = [resolve_device(d) for d in devices] if devices is not None else local_devices()
    return Mesh2D(("data", "model"), (n_data, n_model),
                  _grid(devs[: n_data * n_model], n_data, n_model))


def create_dp_tp_mesh_global(batch_size: int, tp: int, device: DeviceArg = None,
                             devices: Optional[Sequence[DeviceArg]] = None) -> Mesh2D:
    """The trainers' dp x tp mesh. Without a process group: the data axis
    is the largest batch divisor the remaining ``devices`` (default: the
    visible cards) allow. Under one: (world / tp, tp), the model axis inside
    a node; the ranks of a ``model`` line share their ``batch_size`` rows,
    so the global batch is (world / tp) * batch_size."""
    if not group_active():
        devs = [resolve_device(d) for d in devices] if devices is not None else local_devices()
        n_dev = len(devs)
        if n_dev % tp != 0:
            raise ValueError(f"tensor_parallel={tp} must divide the device count {n_dev}")
        n_data = n_dev // tp
        while n_data > 1 and batch_size % n_data != 0:
            n_data -= 1
        return create_dp_tp_mesh(n_data, tp, devs)
    return _rank_mesh("model", tp, "tensor_parallel", device)


def create_fsdp_device_mesh(device: DeviceArg = None):
    """The ``DeviceMesh`` of one ``data`` axis over the whole group, which
    FSDP shards over."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(rank_device(device).type, (process_count(),),
                            mesh_dim_names=("data",))


def data_rows(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's rows among the global batch's row
    blocks: the rank itself, but under tensor parallelism the ranks of one
    ``model`` line read the same rows."""
    if isinstance(mesh, Mesh2D) and mesh.spans_ranks and mesh.axis_names[1] == "model":
        return mesh.coordinate("data"), mesh.shape[0]
    return process_index(), process_count()


def pad_batch_to_multiple(arrays, multiple: int):
    """Edge-pad the leading dim of an array (or a list or tuple of them) to a
    multiple of ``multiple``: (padded, real count)."""
    real = arrays[0].shape[0] if isinstance(arrays, (list, tuple)) else arrays.shape[0]
    pad = (-real) % multiple
    if pad == 0:
        return arrays, real

    def _pad(a):
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1), mode="edge")

    if isinstance(arrays, (list, tuple)):
        return type(arrays)(_pad(a) for a in arrays), real
    return _pad(arrays), real


def shard_batch(mesh: Optional[DataMesh], batch) -> List[torch.Tensor]:
    """This process's shards of a batch (a tensor or an array), one per mesh
    device: the batch split evenly over a one-process mesh, or, on a mesh
    over ranks, this rank's rows on its card."""
    x = torch.as_tensor(batch)
    if mesh is None:
        return [x]
    parts = x.tensor_split(len(mesh.devices)) if len(mesh.devices) > 1 else (x,)
    return [p.to(d) for p, d in zip(parts, mesh.devices)]


def replicate(mesh: Optional[DataMesh], module: torch.nn.Module) -> List[torch.nn.Module]:
    """One replica of ``module`` per mesh device (the module itself on its
    own device, a copy elsewhere). On a mesh of a process group every rank's
    parameters and buffers are set to rank 0's, as DDP does at start."""
    if mesh is None:
        return [module]
    if _has_group(mesh):
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                _dist().broadcast(t.data, group=mesh.group, group_src=0)
        return [module]
    home = next(module.parameters()).device
    return [module if d == home else copy.deepcopy(module).to(d) for d in mesh.devices]


def to_host(tree):
    """A tree of tensors on the host. Under one rank per card every rank
    holds the whole, replicated value: nothing is gathered (a model cut by
    FSDP or tensor parallelism is gathered by the trainers'
    ``ParallelPlan.full_model_state``)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(to_host(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# collectives of the train steps (a mesh over ranks)
# ---------------------------------------------------------------------------

def rows_of(full: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch."""
    n = full.shape[0] // mesh.process_count
    return full[mesh.process_index * n:(mesh.process_index + 1) * n]


def all_reduce_sum(tensor: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place (no gradient)."""
    _dist().all_reduce(tensor, group=mesh.group)
    return tensor


def all_reduce_sum_autograd(tensor: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks, differentiable: its gradient is
    the ranks' gradients summed (as ``SyncBatchNorm`` reduces)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(tensor, group=mesh.group)


def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: DataMesh) -> None:
    """Sum the parameters' gradients over the ranks: one flat buffer per
    dtype, one all-reduce each."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_sum(_flatten_dense_tensors(grads), mesh)
        for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(reduced)


def agree_max(value: int, mesh: Optional[DataMesh]) -> int:
    """The largest of an integer over the ranks of ``mesh``'s group (a
    barrier too)."""
    if not _has_group(mesh):
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_collective_device())
    _dist().all_reduce(t, op=_dist().ReduceOp.MAX, group=mesh.group)
    return int(t.item())
