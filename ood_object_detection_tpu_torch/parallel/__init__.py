"""Data parallelism over processes, and the image-H split of a 2-D
(data, spatial) mesh (port of ``ood_object_detection_tpu.parallel``).

The JAX package's ``replicated`` (``parallel/mesh.py:40``) is not ported:
it returns a ``NamedSharding`` that places one array whole on every
device of a mesh, and a process group has no such placement. Here every
rank holds its own copy of the parameters and state, kept equal by the
train step's summed gradient (``train_state.mesh_train_step``).
"""
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
from .spatial import spatially_sharded
