"""Parallelism: data parallelism, the meshes and torchrun's process group
(``parallel/mesh.py``), ring attention (``parallel/sequence.py``), FSDP
(``parallel/fsdp.py``), tensor parallelism (``parallel/tp.py``) and the
collectives' accounting from a profiler trace
(``parallel/collective_stats.py``)."""

from fmdm_tpu_torch.parallel.sequence import ring_attention, sequence_parallel_sdpa
from fmdm_tpu_torch.parallel.mesh import (
    DataMesh,
    Mesh2D,
    broadcast_string,
    create_data_mesh,
    create_dp_sp_mesh,
    create_dp_sp_mesh_global,
    create_dp_tp_mesh,
    create_dp_tp_mesh_global,
    create_mesh,
    create_mesh_for_batch,
    is_main_process,
    maybe_initialize_distributed,
    pad_batch_to_multiple,
    process_count,
    replicate,
    shard_batch,
    spans_processes,
    to_host,
)
