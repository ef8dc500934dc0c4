"""Device mesh: the port of tpuvdb/mesh/mesh.py.

The reference's mesh is a `jax.sharding.Mesh`: one SPMD program runs on
every device, and the shards talk through XLA collectives. The port is a
single controller over *slots*. A `Mesh` is a numpy array of
`torch.device`s shaped like the JAX mesh, with its `axis_names`; each slot
holds its own tensors and is scanned by its own launches, and the
collectives become peer copies to a merge device (mesh/sharded.py). A slot
may name a device that another slot names too (eight CPU slots in the
tests, four `cuda:0` slots on one card): the per-slot offsets, the merge
and the replica split then run as they would over as many cards.

Across processes (`cluster/bootstrap.initialize_multihost`), a mesh made
while the process group is up spans every process's slots in rank order;
`slot_ranks` says which process owns each slot, and a process holds and
scans only its own. The program is the reference's SPMD one: every
process makes the same calls on the same data, in the same order, and
gets the whole answer back. A search finishes with one
`torch.distributed.all_gather` of every group's merged (Q, k) pairs
(mesh/sharded.py); the helpers below are the other collectives the mesh
modules take (sums for whole-mesh counts, a broadcast of trained tables,
a digest check). Under gloo the tensors meet on the host, under NCCL on
the process's current card.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from tpuvdb_torch.device import resolve_device


def device_count() -> int:
    """CUDA cards this process sees (the reference counts jax.devices())."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device for the block (torch ops and
    launches that name no device); nothing to switch for a CPU slot."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class Mesh:
    """Slots shaped like a JAX mesh: `devices` (an object array of
    torch.device), `axis_names`, `shape` (axis name -> size, as
    jax.sharding.Mesh.shape) and `size`. `slot_ranks` (same shape) names
    the process that owns each slot; `rank` is this process's."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 slot_ranks: Optional[np.ndarray] = None, rank: int = 0,
                 distributed: bool = False):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} do not fit "
                             f"axes {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.slot_ranks = (np.zeros(devices.shape, np.int64)
                           if slot_ranks is None
                           else np.asarray(slot_ranks, np.int64))
        self.rank = rank
        self.distributed = distributed

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.flat_devices()]})")

    def flat_devices(self) -> list:
        """Slot devices in row-major (flat slot) order."""
        return list(self.devices.reshape(-1))

    def is_local(self, slot: int) -> bool:
        return int(self.slot_ranks.reshape(-1)[slot]) == self.rank

    def local_slots(self) -> list:
        return [s for s in range(self.size) if self.is_local(s)]

    def slot_grid(self, shard_axis: str) -> np.ndarray:
        """Flat slot ids as (groups, shards): row g holds one complete copy
        of the shards, in shard order (g is the position on the other
        axis of a 2-D mesh; a 1-D mesh is one group)."""
        if shard_axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{shard_axis!r} axis")
        ids = np.arange(self.size).reshape(self.devices.shape)
        ids = np.moveaxis(ids, self.axis_names.index(shard_axis), -1)
        return ids.reshape(-1, self.shape[shard_axis])


def _in_process_group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def collective_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL,
    the host under gloo (whose all_gather need not take CUDA tensors)."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_tensor(t: torch.Tensor) -> list:
    """Every process's `t` (same shape and dtype in each), in rank order,
    on the collective device."""
    import torch.distributed as dist

    t = t.to(collective_device()).contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def sum_over_processes(mesh: Mesh, values) -> list:
    """Integer counts summed over the mesh's processes (unchanged within
    one process): each process passes its own part."""
    values = [int(v) for v in values]
    if not mesh.distributed:
        return values
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.int64, device=collective_device())
    dist.all_reduce(t)
    return [int(v) for v in t.cpu().tolist()]


def broadcast_from(mesh: Mesh, obj, src: int):
    """`obj` as process `src` holds it, in every process of the mesh (a
    picklable object: host arrays, tuples of them)."""
    if not mesh.distributed:
        return obj
    import torch.distributed as dist

    box = [obj if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, device=collective_device())
    return box[0]


def digest(*arrays) -> str:
    """A hash of arrays' dtypes, shapes and bytes (None allowed)."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        if a is None:
            h.update(b"none")
            continue
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.view(np.uint8).reshape(-1).data)
    return h.hexdigest()


def check_same_everywhere(mesh: Mesh, what: str, value: str) -> None:
    """Raise unless every process of the mesh holds the same `value`."""
    if not mesh.distributed:
        return
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    if len(set(got)) != 1:
        raise RuntimeError(f"{what} differ between processes: {got}")


def mesh_devices(devices: Optional[Sequence]) -> list:
    """The slots of a new mesh: the given devices (a device may repeat),
    or every visible CUDA card (raises without CUDA)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    resolve_device(None)  # raises without CUDA
    return [torch.device("cuda", i) for i in range(device_count())]


def build_mesh(devices: list, axis_names: Sequence[str],
               shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of `shape` (None: one axis over them all) on the first
    prod(shape) slots of `devices`. Inside a process group the slots are
    every process's `devices` in rank order (a collective: each process
    of the group calls it), and a process owns its own."""
    ranks, rank, distributed = [0] * len(devices), 0, _in_process_group()
    if distributed:
        import torch.distributed as dist

        lists = [None] * dist.get_world_size()
        dist.all_gather_object(lists, [str(d) for d in devices])
        devices = [torch.device(n) for names in lists for n in names]
        ranks = [r for r, names in enumerate(lists) for _ in names]
        rank = dist.get_rank()
    n = len(devices) if shape is None else int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    shape = (n,) if shape is None else tuple(shape)
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names,
                slot_ranks=np.asarray(ranks[:n]).reshape(shape), rank=rank,
                distributed=distributed)


def create_mesh(
    n_devices: Optional[int] = None,
    axis: str = "shards",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the first n_devices slots (default: all). Inside a
    process group the slots are every process's devices in rank order."""
    return build_mesh(mesh_devices(devices), (axis,),
                      None if n_devices is None else (n_devices,))
