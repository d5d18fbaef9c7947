"""The device mesh and batch sharding of data parallelism (counterpart of
`stove_tpu/parallel/mesh.py`).

The JAX package runs one controller over a `Mesh` of the local devices:
the window batch sharded on the leading ('data') axis, parameters and
optimizer state replicated, the gradient all-reduce inserted by XLA.  In
torch's idiom each device has a process of its own, started by
`python -m torch.distributed.run --nproc_per_node=N` (which sets RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT), or spawned by a caller that
hands `init_process_group` the address, world and rank itself.  The
backend follows the device: NCCL for CUDA, gloo for the CPU, or the one
the caller names; there is no fallback from one to the other.

Without a process group the world is one process, and every function here
is the identity: a run is what it was before data parallelism.

`Mesh` is this process's place in the mesh: the mesh shape over the
world's ranks (row-major, rank = the flat index), so with a second axis,
as `mesh_shape=(4, 2)` `mesh_axes=('data', 'model')`, the batch is split
over the first axis only and the ranks along the second compute the same
rows (they replicate, as the JAX mesh's unused 'model' axis does).  Ranks
beyond the mesh's size hold no rows ("sit out"): they take part in every
collective with zeros, so every rank applies the same update.
"""

from __future__ import annotations

import math
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from stove_tpu_torch.config import Config


class Mesh(NamedTuple):
    shape: Tuple[int, ...]     # resolved mesh shape; its size <= world
    axes: Tuple[str, ...]
    rank: int                  # this process's rank in the world
    world: int                 # processes in the process group (1: none)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def data(self) -> int:
        """Shards of the batch: the 'data' axis, the first."""
        return self.shape[0]

    @property
    def active(self) -> bool:
        """Whether this rank holds rows of the batch."""
        return self.rank < self.size

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch` (a multiple of
        `data`): its 'data' index's contiguous block; empty when the rank
        sits out."""
        if not self.active:
            return slice(0, 0)
        per = batch // self.data
        i = self.rank // (self.size // self.data)
        return slice(i * per, (i + 1) * per)

    def share(self, batch: int) -> float:
        """The weight of this rank's loss in the batch's: its rows' share
        of the batch over the ranks that hold the same rows, so the sum
        over the ranks is the batch's mean."""
        rows = self.rows(batch)
        return (rows.stop - rows.start) / batch / (self.size // self.data)


def backend_for(device: torch.device) -> str:
    """The collective backend a device takes: NCCL for CUDA, gloo for the
    CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def init_process_group(device: torch.device, rank: Optional[int] = None,
                       world: Optional[int] = None,
                       address: Optional[str] = None,
                       backend: Optional[str] = None) -> None:
    """Join the process group: `rank`, `world` and `address`
    ("tcp://host:port") as given, else from the environment
    `torch.distributed.run` sets (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); `backend` as given, else `backend_for(device)`."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if address is None:
        address = (f"tcp://{os.environ['MASTER_ADDR']}:"
                   f"{os.environ['MASTER_PORT']}")
    kw = {}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if (backend or "nccl") == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend or backend_for(device),
                            init_method=address, rank=rank, world_size=world,
                            **kw)


def backend() -> Optional[str]:
    """The process group's backend ("nccl", "gloo"); None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(cfg: Optional[Config] = None,
              place: Optional[Tuple[int, int]] = None) -> Mesh:
    """This process's mesh: `cfg.mesh_shape` over the world's ranks, a 0
    filled with the ranks the other axes leave ((0,), the default, is the
    whole world on 'data'); a shape larger than the world raises.
    `place`: (rank, world size) in place of the process group's."""
    rank, n = world() if place is None else place
    if cfg is None:
        return Mesh((n,), ("data",), rank, n)
    shape, axes = tuple(cfg.mesh_shape), tuple(cfg.mesh_axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {shape} and mesh_axes {axes} differ "
                         "in length")
    if 0 in shape:
        known = math.prod(s for s in shape if s != 0)
        shape = tuple(max(1, n // known) if s == 0 else s for s in shape)
    if math.prod(shape) > n:
        raise ValueError(
            f"mesh_shape {tuple(cfg.mesh_shape)} needs {math.prod(shape)} "
            f"processes, the world has {n}: launch them with `python -m "
            f"torch.distributed.run --nproc_per_node={math.prod(shape)} -m "
            "stove_tpu_torch.main ...`")
    return Mesh(shape, axes, rank, n)


def for_batch(mesh: Mesh, batch: int) -> Mesh:
    """The mesh a batch of `batch` windows is sharded over: `mesh` when
    its size divides the batch, else a 1-D 'data' mesh of the largest
    size that does (JAX trainer.py:137-143); the ranks beyond it sit
    out."""
    if batch % mesh.size == 0:
        return mesh
    n = mesh.size
    while batch % n:
        n -= 1
    return Mesh((n,), ("data",), mesh.rank, mesh.world)


def shard_batch(mesh: Mesh, tensors: Sequence[Optional[torch.Tensor]],
                batch: int) -> List[Optional[torch.Tensor]]:
    """This rank's rows (leading axis) of each tensor of a global batch of
    `batch` rows; None stays None."""
    rows = mesh.rows(batch)
    return [None if x is None else x[rows] for x in tensors]


def replicate(tensors: Sequence[torch.Tensor]) -> None:
    """Broadcast each tensor from rank 0, in place."""
    if dist.is_initialized():
        for x in tensors:
            dist.broadcast(x, 0)


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the ranks of each tensor, in one collective over their
    flat concatenation (float32); the tensors themselves without a
    process group."""
    if not dist.is_initialized():
        return list(tensors)
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in tensors])
    dist.all_reduce(flat)
    out, off = [], 0
    for x in tensors:
        out.append(flat[off:off + x.numel()].reshape(x.shape).to(x.dtype))
        off += x.numel()
    return out


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0
                    ) -> Tuple[torch.Tensor, int]:
    """x zero-padded along `axis` up to a multiple of `multiple` (for
    sharding ragged eval batches); returns (padded, original length)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    shape = list(x.shape)
    shape[axis] = target - n
    return torch.cat([x, x.new_zeros(shape)], axis), n
