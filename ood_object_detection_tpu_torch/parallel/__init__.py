"""Data parallelism over processes (port of
``ood_object_detection_tpu.parallel``)."""
from .mesh import (
    Mesh,
    all_gather_detections,
    all_reduce_sum,
    create_mesh,
    data_sharding,
    is_main_process,
    local_shard,
    process_gather,
    process_merge,
    reduce_dict,
    shard_batch,
    shared_random_seed,
    synced_batch_norms,
)
