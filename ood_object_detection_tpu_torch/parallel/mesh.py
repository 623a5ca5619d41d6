"""Process groups and the data-parallel helpers (port of
``ood_object_detection_tpu.parallel.mesh``).

The JAX package shards one global array over a device mesh and lets XLA
insert the collectives. The port runs one process per card, started by
``torchrun`` (``python -m torch.distributed.run``), and each process holds
its own rows of the global batch. A ``Mesh`` here is that group of
processes: its size, this process's rank and device, the group whose
collectives run on the device (``nccl`` on the card, ``gloo`` on the CPU
or, asked for, for ranks that share one card) and a ``gloo`` group for
merges of host arrays.

A 2-D mesh ``(D, S)`` with axes (``data``, spatial) lays the ranks out
row-major, as JAX's ``np.array(devices).reshape(shape)`` does: rank r is
data block ``r // S`` and spatial index ``r % S``. Beside the world group
it holds this rank's spatial group (the ``S`` ranks of its data block,
which split its images' rows: ``parallel/spatial.py``) and its data group
(the ``D`` ranks of its spatial index).

``create_mesh`` joins the group ``torchrun`` describes in the environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); outside ``torchrun`` a mesh of one process has no group,
and a mesh of more raises and names the command. The helpers keep JAX's
names and semantics:
- ``shard_batch``: this rank's rows, rank r's rows the r-th block;
- ``all_gather_detections``: the fixed-shape gather of every rank's rows;
- ``reduce_dict``: sum or mean of scalars over the ranks;
- ``process_merge``: a host all-gather of a numpy tree, stacked;
- ``shared_random_seed``: rank 0's draw on every rank;
- ``all_reduce_sum``: a sum over the ranks whose gradient is the sum of
  the ranks' gradients: every collective of the train and meta steps
  (the synced BatchNorm's moments, the positives, the losses, the
  gradients) goes through it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import span

LAUNCH = ("python -m torch.distributed.run --nproc-per-node N "
          "-m <entry point> ...")
# a collective that waits longer than this fails instead of hanging
TIMEOUT = timedelta(minutes=10)


@dataclasses.dataclass
class Mesh:
    """The processes of a data-parallel run, one device each.

    ``group`` carries the device collectives over every rank (None for
    one process outside ``torchrun``); ``host_group`` the host merges
    (``gloo``). ``owns_group``: this mesh initialised the default group
    and ``close`` ends it. ``axis_sizes``: the mesh's shape, ``(size,)``
    for a 1-D mesh. ``data_group``: the ranks of this rank's spatial
    index, which hold different images (``group`` on a 1-D mesh);
    ``spatial_group``: the ranks that split this rank's images' rows (a
    2-D mesh only; the module docstring)."""
    size: int
    rank: int
    device: torch.device
    axis_names: tuple = ("data",)
    group: Any = None
    host_group: Any = None
    owns_group: bool = False
    axis_sizes: tuple = ()
    spatial_group: Any = None
    data_group: Any = None

    def __post_init__(self):
        if not self.axis_sizes:
            self.axis_sizes = (self.size,)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def spatial_size(self) -> int:
        """Ranks that split one data block's rows (1 on a 1-D mesh)."""
        return self.axis_sizes[1] if len(self.axis_sizes) > 1 else 1

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial_size

    @property
    def data_size(self) -> int:
        return self.axis_sizes[0]

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial_size

    @property
    def distributed(self) -> bool:
        """Whether collectives run (a launched group, of any size)."""
        return self.group is not None

    def close(self) -> None:
        """End the process group if this mesh began it; a mesh that joined
        a group begun before it leaves the group open."""
        global _CURRENT
        if not self.owns_group:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        self.group = self.host_group = None
        self.spatial_group = self.data_group = None
        _CURRENT = None


# the mesh create_mesh made last: the port's counterpart of the JAX
# process's distributed state, read by the helpers JAX calls without one
_CURRENT: Optional[Mesh] = None


def _launched() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def _device(device, local_rank: int) -> torch.device:
    """The rank's device: ``device`` as named (``cuda`` without an index
    is the card of LOCAL_RANK); None is the card of LOCAL_RANK, and raises
    without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    return device


def _mesh_shape(shape: List[int], world: int) -> List[int]:
    """``shape`` with its -1 (at most one) taking the rest of the launch's
    ``world`` processes; raises unless the mesh has exactly ``world``."""
    known = int(np.prod([s for s in shape if s != -1]))
    if shape.count(-1) > 1 or min(shape) < -1 or 0 in shape:
        raise ValueError(f"mesh {tuple(shape)}: sizes are positive, with "
                         "at most one -1")
    if -1 in shape and world % known == 0:
        shape[shape.index(-1)] = world // known
    want = int(np.prod([s for s in shape if s != -1]))
    if -1 in shape or want != world:
        raise ValueError(
            f"a mesh of {tuple(shape)} processes needs a launch of "
            f"{'a multiple of ' if -1 in shape else ''}{want} (this one has "
            f"{world}): start one process a card with torchrun, "
            f"{LAUNCH.replace('N', str(want))}")
    return shape


def create_mesh(mesh_shape: Sequence[int] = (-1,),
                axis_names: Sequence[str] = ("data",),
                device=None, backend: Optional[str] = None) -> Mesh:
    """The mesh of this process, 1-D (data) or 2-D (data, spatial): -1 on
    one axis takes the rest of the launch's processes, and the sizes must
    multiply to the launch's count. Inside ``torchrun`` it joins (or
    initialises) the process group over ``backend`` (``nccl`` for a card,
    ``gloo`` for the CPU when None; ``gloo`` on the card lets ranks share
    one card), makes a ``gloo`` group for host merges and, for a 2-D mesh,
    every rank's spatial and data groups (each rank makes every group:
    ``new_group`` is collective). ``device``: see ``_device``."""
    global _CURRENT
    if len(mesh_shape) not in (1, 2) or len(axis_names) != len(mesh_shape):
        raise ValueError(f"mesh {tuple(mesh_shape)} {tuple(axis_names)}: "
                         "a 1-D (data) or 2-D (data, spatial) mesh, one "
                         "name an axis")
    launched = _launched() or dist.is_initialized()
    world = int(os.environ.get("WORLD_SIZE", 1)) if not dist.is_initialized() \
        else dist.get_world_size()
    shape = tuple(_mesh_shape(list(mesh_shape), world))
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    dev = _device(device, local_rank)
    if not launched:
        mesh = Mesh(size=1, rank=0, device=dev, axis_names=tuple(axis_names),
                    axis_sizes=shape)
        _CURRENT = mesh
        return mesh
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owns = False
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method="env://",
                                world_size=world,
                                rank=int(os.environ["RANK"]), timeout=TIMEOUT)
        owns = True
    group = dist.group.WORLD
    host = group if dist.get_backend() == "gloo" else \
        dist.new_group(backend="gloo", timeout=TIMEOUT)
    rank = dist.get_rank()
    spatial, data = None, group
    if len(shape) == 2:
        blocks, split = shape
        for b in range(blocks):
            g = dist.new_group([b * split + i for i in range(split)],
                               timeout=TIMEOUT)
            spatial = g if rank // split == b else spatial
        for i in range(split):
            g = dist.new_group([b * split + i for b in range(blocks)],
                               timeout=TIMEOUT)
            data = g if rank % split == i else data
    mesh = Mesh(size=world, rank=rank, device=dev,
                axis_names=tuple(axis_names), group=group, host_group=host,
                owns_group=owns, axis_sizes=shape, spatial_group=spatial,
                data_group=data)
    _CURRENT = mesh
    return mesh


def data_sharding(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size`` (the JAX
    ``P('data')`` placement: data block b holds the b-th block of rows,
    the same on each rank of its spatial group)."""
    if batch_size % mesh.data_size:
        raise ValueError(f"batch {batch_size} does not divide over "
                         f"{mesh.data_size} data blocks")
    per = batch_size // mesh.data_size
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (a tensor, an array, or a dict of
    them), on the mesh's device when a tensor: rows over the data axis
    only, the full images (JAX ``shard_batch``'s ``P('data')``; the
    spatial train step takes its own block of each image's rows)."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    rows = batch[data_sharding(mesh, batch.shape[0])]
    return rows.to(mesh.device) if isinstance(rows, torch.Tensor) else rows


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient is the sum of the ranks'
    gradients (each rank's loss depends on the shared sum)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        all_reduce_sum.calls += 1
        with span("odt.mesh.all_reduce"):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` summed over the ranks of ``group`` (a new tensor),
    differentiable; ``all_reduce_sum.calls`` counts the collectives, the
    backward's included, and each is an ``odt.mesh.all_reduce`` span of a
    profiler trace when spans are on."""
    return _AllReduceSum.apply(tensor, group)


all_reduce_sum.calls = 0


def all_gather_detections(detections: torch.Tensor, mesh: Mesh
                          ) -> torch.Tensor:
    """Every rank's fixed-shape rows [B_local, ...] -> the global batch
    [size * B_local, ...], rank r's rows the r-th block, on every rank (a
    sum of zero-padded blocks: exact, and one collective on any backend)."""
    if mesh.size == 1 or mesh.group is None:
        return detections
    b = detections.shape[0]
    out = detections.new_zeros((mesh.size * b,) + detections.shape[1:])
    out[mesh.rank * b:(mesh.rank + 1) * b] = detections
    dist.all_reduce(out, group=mesh.group)
    return out


def local_shard(arr, mesh: Optional[Mesh] = None):
    """This process's rows of a global batch, in batch order (JAX reads
    them from the addressable shards; a per-process batch is already
    them). With ``mesh``, the rows of a global batch held whole."""
    return arr if mesh is None else shard_batch(mesh, arr)


def _host_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh whose gloo group merges host values; None in one
    process."""
    mesh = mesh if mesh is not None else _CURRENT
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1 and (mesh is None or mesh.host_group is None):
        raise RuntimeError(
            "a host merge across processes needs the mesh of create_mesh "
            f"(its gloo group); start the run with torchrun, {LAUNCH}")
    return mesh if world > 1 else None


def process_gather(obj, mesh: Optional[Mesh] = None) -> List:
    """Every rank's ``obj`` (any picklable host value), in rank order, on
    every rank, over the mesh's gloo group; ``[obj]`` in one process."""
    mesh = _host_mesh(mesh)
    if mesh is None:
        return [obj]
    out: List = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def process_merge(tree, mesh: Optional[Mesh] = None):
    """Host all-gather of a numpy tree (a dict of arrays, or an array):
    each leaf stacked over a new leading process axis, as JAX's
    ``process_allgather``."""
    parts = process_gather(tree, mesh)
    if isinstance(tree, dict):
        return {k: np.stack([np.asarray(p[k]) for p in parts])
                for k in tree}
    return np.stack([np.asarray(p) for p in parts])


def reduce_dict(metrics: Dict[str, torch.Tensor], mesh: Mesh,
                average: bool = True) -> Dict[str, torch.Tensor]:
    """Scalar metrics summed (or averaged) over the ranks, in one
    collective."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=mesh.device).reshape(())
                        for k in keys])
    if mesh.group is not None:
        dist.all_reduce(vals, group=mesh.group)
    if average:
        vals = vals / mesh.size
    return {k: vals[i] for i, k in enumerate(keys)}


def shared_random_seed(seed: Optional[int] = None,
                       mesh: Optional[Mesh] = None) -> int:
    """A seed equal on every process: rank 0's ``seed`` (a fresh draw when
    None), broadcast."""
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2 ** 31))
    mesh = _host_mesh(mesh)
    if mesh is None:
        return int(seed)
    box = [int(seed)]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return int(box[0])


def is_main_process() -> bool:
    """Rank 0 (or no launched group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def synced_batch_norms(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Within the block every train-mode BatchNorm of ``module`` (the
    modules with a ``sync_group``) normalises with the moments of the
    global batch: its statistics are summed over the mesh's ranks, as
    flax's ``jnp.mean`` over a batch-sharded array is. Nothing changes
    without a launched group."""
    norms = [m for m in module.modules() if hasattr(m, "sync_group")]
    group = mesh.group if mesh is not None else None
    for m in norms:
        m.sync_group = group
    try:
        yield
    finally:
        for m in norms:
            m.sync_group = None
