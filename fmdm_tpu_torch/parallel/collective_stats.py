"""
Collective accounting from a ``torch.profiler`` trace (counterpart of
``fmdm_tpu/parallel/hlo_stats.py``, which reads XLA's compiled HLO: the port
compiles no program, so it reads the collectives its ranks issued).

Every collective of ``torch.distributed`` passes through a ``c10d::`` op,
whatever the backend, and the profiler records it with its arguments' shapes
(``record_shapes=True``) and element types. A list of tensors (an
all-reduce, a send) is typed ``TensorList``; its element type is read from
the backend's own event for the same call (``gloo:*``, ``nccl:*`` or
``record_param_comms``, the first one after it with as many elements).
Gloo records no ``record_param_comms`` event, so the group size is read from
the shapes where they say it (an all-gather's output over its input, a
reduce-scatter's input over its output) and is None otherwise.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        step()
    cols = parse_collectives(prof)
    summary = collective_summary(cols)        # kind -> count, bytes
    per_rank = link_bytes_per_rank(cols)      # modeled bytes sent over NVLink/PCIe

A strategy's collective signature: data parallelism is a gradient
all-reduce; FSDP adds the weights' all-gathers and the gradients'
reduce-scatters; tensor parallelism the activations' all-gathers and the
input gradients' all-reduces; sequence parallelism the ring's sends (and an
all-to-all each way at the attention's boundary).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List

# element sizes of the profiler's type names
_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "long int": 8, "int": 4,
    "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
    "Float": 4, "Double": 8, "BFloat16": 2, "Half": 2, "Long": 8, "Int": 4, "Byte": 1, "Char": 1,
}

# c10d op -> (kind, index of the argument whose size is the payload)
_OPS = {
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::_allgather_base_": ("all-gather", 0),
    "c10d::allgather_": ("all-gather", 0),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 0),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::broadcast_": ("broadcast", 0),
    "c10d::send": ("send", 0),
    "c10d::recv_": ("recv", 0),
}
_BACKEND_PREFIXES = ("gloo:", "nccl:", "record_param_comms")


def trace_events(trace) -> List[Dict[str, Any]]:
    """The events of a Chrome trace: a ``torch.profiler.profile`` (exported
    to a temporary file), a path to a trace, or the loaded trace."""
    if hasattr(trace, "export_chrome_trace"):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            trace.export_chrome_trace(path)
            with open(path) as handle:
                trace = json.load(handle)
        finally:
            os.unlink(path)
    elif isinstance(trace, (str, os.PathLike)):
        with open(trace) as handle:
            trace = json.load(handle)
    return trace["traceEvents"] if isinstance(trace, dict) else list(trace)


def _numel(dims) -> int:
    """Elements of one argument's dims: a tensor's [d0, d1, ...], or a
    list of tensors' [[...], [...]]."""
    if not dims:
        return 0 if dims == [] else 1
    if isinstance(dims[0], list):
        return sum(_numel(d) for d in dims)
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _args(event) -> Dict[str, Any]:
    return event.get("args") or {}


def parse_collectives(trace) -> List[Dict[str, Any]]:
    """Every collective of the trace, in time order: dicts of kind, bytes
    (the payload: an all-reduce's tensor, an all-gather's whole output, a
    reduce-scatter's output shard, an all-to-all's input, a send's tensor),
    group_size (None where the shapes do not say it), dtype and name."""
    events = sorted((e for e in trace_events(trace) if e.get("ph") == "X"),
                    key=lambda e: e.get("ts", 0))
    backend = [e for e in events if str(e.get("name", "")).startswith(_BACKEND_PREFIXES)]
    used = set()
    out = []
    for e in events:
        op = _OPS.get(e.get("name"))
        if op is None:
            continue
        kind, arg = op
        args = _args(e)
        dims, types = args.get("Input Dims", []), args.get("Input type", [])
        numel = _numel(dims[arg]) if len(dims) > arg else 0
        dtype = types[arg] if len(types) > arg else None
        if dtype in (None, "", "TensorList"):
            dtype = None
            for i, b in enumerate(backend):
                if i in used or b.get("ts", 0) < e.get("ts", 0):
                    continue
                b_args = _args(b)
                b_dims, b_types = b_args.get("Input Dims", []), b_args.get("Input type", [])
                b_dtype = b_args.get("dtype") or (b_types[0] if b_types else None)
                if b_dims and _numel(b_dims[0]) == numel and b_dtype in _DTYPE_BYTES:
                    used.add(i)
                    dtype = b_dtype
                    break
        group = None
        if kind in ("all-gather", "reduce-scatter") and len(dims) > 1:
            small, big = sorted((_numel(dims[0]), _numel(dims[1])))
            group = big // small if small else None
        out.append({"kind": kind, "bytes": numel * _DTYPE_BYTES.get(dtype, 4),
                    "group_size": group, "dtype": dtype, "name": e["name"]})
    return out


def collective_summary(collectives: List[Dict[str, Any]]) -> Dict[str, Dict[str, int]]:
    """Aggregate: kind -> {count, bytes} (bytes: the payloads summed)."""
    summary: Dict[str, Dict[str, int]] = {}
    for c in collectives:
        entry = summary.setdefault(c["kind"], {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += c["bytes"]
    return summary


def link_bytes_per_rank(collectives: List[Dict[str, Any]], default_group: int = 2) -> int:
    """Modeled bytes each rank sends over its links (NVLink or PCIe) under
    ring algorithms, for payload P over g ranks (JAX's
    ``ici_bytes_per_device``): all-reduce 2 P (g-1)/g, all-gather P (g-1)/g
    (P the whole output), reduce-scatter P (g-1) (P the output shard),
    all-to-all P (g-1)/g, broadcast P (g-1)/g, a send P, a recv nothing."""
    total = 0.0
    for c in collectives:
        g = c["group_size"] or default_group
        p, k = c["bytes"], c["kind"]
        if k == "send":
            total += p
        elif g <= 1 or k == "recv":
            continue
        elif k == "all-reduce":
            total += 2.0 * p * (g - 1) / g
        elif k in ("all-gather", "all-to-all", "broadcast"):
            total += p * (g - 1) / g
        elif k == "reduce-scatter":
            total += p * (g - 1)
    return int(total)


def run_self_tests() -> None:
    """Embedded self-test on a synthetic trace of each kind."""
    def op(name, ts, dims, types):
        return {"ph": "X", "name": name, "ts": ts, "dur": 1,
                "args": {"Input Dims": dims, "Input type": types}}

    trace = {"traceEvents": [
        op("c10d::allreduce_", 0, [[[8, 16]], [], []], ["TensorList", "", ""]),
        op("gloo:all_reduce", 1, [[8, 16]], ["float"]),
        op("c10d::_allgather_base_", 2, [[32], [8], []], ["c10::BFloat16", "c10::BFloat16", ""]),
        op("c10d::_reduce_scatter_base_", 3, [[4], [16], []], ["float", "float", ""]),
        op("c10d::send", 4, [[[2, 2]], [], []], ["TensorList", "", ""]),
        op("nccl:send", 5, [[2, 2]], ["c10::Half"]),
        op("c10d::alltoall_base_", 6, [[6], [6]], ["float", "float"]),
    ]}
    cols = parse_collectives(trace)
    kinds = [c["kind"] for c in cols]
    assert kinds == ["all-reduce", "all-gather", "reduce-scatter", "send", "all-to-all"], kinds
    assert cols[0]["bytes"] == 8 * 16 * 4 and cols[0]["group_size"] is None
    assert cols[1]["bytes"] == 32 * 2 and cols[1]["group_size"] == 4
    assert cols[2]["bytes"] == 4 * 4 and cols[2]["group_size"] == 4
    assert cols[3]["bytes"] == 4 * 2 and cols[3]["dtype"] == "c10::Half"
    s = collective_summary(cols)
    assert s["all-reduce"] == {"count": 1, "bytes": 512}
    assert link_bytes_per_rank(cols) == int(512 + 64 * 3 / 4 + 16 * 3 + 8 + 24 / 2)
