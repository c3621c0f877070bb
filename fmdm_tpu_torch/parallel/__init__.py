"""Data parallelism: the data mesh, torchrun's process group and the train
steps' collectives (``parallel/mesh.py``). FSDP, tensor and sequence
parallelism are not ported yet (ROADMAP Queue 1 item 10)."""

from fmdm_tpu_torch.parallel.mesh import (
    DataMesh,
    broadcast_string,
    create_data_mesh,
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
