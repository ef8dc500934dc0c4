"""Scatter-gather search over the slots of a mesh: the port of
tpuvdb/mesh/sharded.py.

The reference runs one shard_map program: every device scans its row range
and the (Q, k) candidates merge through an `all_gather` over ICI and a
final top-k. Here the controller launches the local top-k of every slot,
each on its own device with no host read in between, then copies each
slot's (Q, k) distances and rows to the merge device (the first slot of the
group), adds the slot's row offset, concatenates them slot-major and takes
the final top-k. `jax.lax.top_k` puts the lower index first on a tie, and
the lower index is the lower slot; `torch.topk` promises no order, so the
merge is a stable sort. Across processes each process merges its own slots
and the (Q, k) pairs meet in a `torch.distributed.all_gather`, in rank
(= slot) order, before the same merge.

A sharded tensor is a list over the mesh's flat slots: slot s holds the
rows of its position on the shard axis, on its own device, and None where
another process owns it (`shard_rows` places a host array so).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuvdb_torch.kernels.distance import l2sq_topk
from tpuvdb_torch.kernels.quant import l2sq_topk_int8, l2sq_topk_int8_rescored
from tpuvdb_torch.mesh.mesh import Mesh, on_device

Sharded = List[Optional[torch.Tensor]]


def shard_rows(mesh: Mesh, array, axis: str = "shards") -> Sharded:
    """Place a host array's rows over `axis`: shard position p gets rows
    [p * R, (p + 1) * R), at every slot of that position (the other axis of
    a 2-D mesh replicates). None at other processes' slots."""
    arr = np.asarray(array)
    nshards = mesh.shape[axis]
    if arr.shape[0] % nshards != 0:
        raise ValueError(f"rows {arr.shape[0]} not divisible by mesh size "
                         f"{nshards}")
    per = arr.shape[0] // nshards
    out: Sharded = [None] * mesh.size
    devs = mesh.flat_devices()
    for g_slots in mesh.slot_grid(axis):
        for p, s in enumerate(g_slots.tolist()):
            if mesh.is_local(s):
                out[s] = torch.from_numpy(np.ascontiguousarray(
                    arr[p * per:(p + 1) * per])).to(devs[s])
    return out


def local_topk(q, vecs, sq, valid, k: int, block_size: int, mode: str,
               recall_target: float, scales=None, rescore_fetch: int = 0):
    """One slot's (or one device's) top-k: the scan for f32/bf16 rows, the
    int8 scan for int8 rows (with the fused exact re-rank of
    `rescore_fetch` candidates when that is > 0)."""
    if scales is not None and rescore_fetch > 0:
        return l2sq_topk_int8_rescored(q, vecs, scales, sq, valid, k=k,
                                       fetch=max(rescore_fetch, k))
    if scales is not None:
        return l2sq_topk_int8(q, vecs, scales, sq, valid, k=k)
    return l2sq_topk(q, vecs, sq, valid, k=k, block_size=block_size,
                     mode=mode, recall_target=recall_target)


def merge_topk(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               offsets: Sequence[int], k: int, device: torch.device):
    """Global top-k of per-slot (dist, idx) pairs on `device`: idx + the
    slot's offset, concatenated slot-major, a stable descending sort of
    the negated distances (equal distances keep the lower slot first).
    Returns (dist f32, rows int64), each (Q, k); empty slots +inf / -1."""
    negs, rows = [], []
    for (dist, idx), off in zip(parts, offsets):
        dist = dist.to(device, non_blocking=True)
        idx = idx.to(device, non_blocking=True).to(torch.int64)
        ok = idx >= 0
        rows.append(torch.where(ok, idx + off, torch.full_like(idx, -1)))
        negs.append(torch.where(ok, -dist, torch.full_like(dist,
                                                           float("-inf"))))
    neg = torch.cat(negs, dim=1)
    row = torch.cat(rows, dim=1)
    top, pos = torch.sort(neg, dim=1, descending=True, stable=True)
    kk = min(k, top.shape[1])
    top, row = top[:, :kk], torch.gather(row, 1, pos[:, :kk])
    if kk < k:
        top = F.pad(top, (0, k - kk), value=float("-inf"))
        row = F.pad(row, (0, k - kk), value=-1)
    row = torch.where(top == float("-inf"), torch.full_like(row, -1), row)
    dist = torch.where(row >= 0, -top, torch.full_like(top, float("inf")))
    return dist, row


def merge_processes(dist: torch.Tensor, rows: torch.Tensor, k: int):
    """The cross-process half of the merge: all_gather each process's
    merged (Q, k) pair (rows already global) and merge them in rank
    order, which is slot order."""
    import torch.distributed as dist_

    world = dist_.get_world_size()
    ds = [torch.empty_like(dist) for _ in range(world)]
    rs = [torch.empty_like(rows) for _ in range(world)]
    dist_.all_gather(ds, dist.contiguous())
    dist_.all_gather(rs, rows.contiguous())
    return merge_topk(list(zip(ds, rs)), [0] * world, k, dist.device)


def group_topk(mesh: Mesh, slots: Sequence[int], q: torch.Tensor,
               rows_per_slot: int, k: int, search_slot):
    """The local top-k of each slot of one group (`search_slot(slot, q on
    the slot's device, k_local)` -> (dist, idx)), merged on the group's
    first local slot's device; across processes, then merged with the
    other processes' results. Launches run back to back, one device after
    the other, with no host read until the caller's."""
    devs = mesh.flat_devices()
    mine = [(p, s) for p, s in enumerate(slots) if mesh.is_local(s)]
    if not mine:
        raise ValueError("this process owns no slot of the mesh")
    k_local = min(k, rows_per_slot)
    parts, offsets, q_on = [], [], {}
    for p, s in mine:
        dev = devs[s]
        if dev not in q_on:
            q_on[dev] = q.to(dev, non_blocking=True)
        with on_device(dev):
            parts.append(search_slot(s, q_on[dev], k_local))
        offsets.append(p * rows_per_slot)
    merge_dev = devs[mine[0][1]]
    with on_device(merge_dev):
        dist, rows = merge_topk(parts, offsets, k, merge_dev)
        if mesh.distributed:
            dist, rows = merge_processes(dist, rows, k)
    return dist, rows


def as_queries(queries) -> torch.Tensor:
    """A query batch as an f32 tensor (a numpy batch is copied: a decoded
    wire frame may be read-only)."""
    if isinstance(queries, torch.Tensor):
        return queries.to(torch.float32)
    return torch.from_numpy(np.array(queries, np.float32))


def slot_rows(vectors: Sharded) -> int:
    """Rows a slot holds; every slot of this process must hold as many."""
    counts = {int(v.shape[0]) for v in vectors if v is not None}
    if len(counts) != 1:
        raise ValueError(f"slots hold unequal row counts {sorted(counts)}")
    return counts.pop()


def sharded_search(
    queries,
    vectors: Sharded,
    sqnorms: Sharded,
    valid: Sharded,
    k: int,
    block_size: int,
    mesh: Mesh,
    axis: str = "shards",
    mode: str = "approx",
    recall_target: float = 0.95,
    row_scales: Optional[Sharded] = None,
    rescore_fetch: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over the row-sharded corpus (per-slot lists, see
    `shard_rows`). Returns (dists, rows) on the merge device. Pass
    row_scales for int8-quantized corpora; rescore_fetch > 0 adds a
    per-slot fused exact re-rank of that many candidates (int8 only)."""
    if len(vectors) != mesh.size:
        raise ValueError(f"{len(vectors)} slot tensors for a mesh of "
                         f"{mesh.size}")
    rows_per_dev = slot_rows(vectors)
    if (mode == "exact" and rows_per_dev % block_size != 0
            and rows_per_dev > block_size):
        raise ValueError(
            f"rows/device {rows_per_dev} not a multiple of block "
            f"{block_size}")
    q = as_queries(queries)
    quantized = row_scales is not None

    def search_slot(s, q_s, kk):
        return local_topk(q_s, vectors[s], sqnorms[s], valid[s], kk,
                          block_size, mode, recall_target,
                          scales=row_scales[s] if quantized else None,
                          rescore_fetch=rescore_fetch if quantized else 0)

    # the first copy of the shards answers (the reference's replicated
    # queries give every copy the same answer)
    return group_topk(mesh, mesh.slot_grid(axis)[0].tolist(), q,
                      rows_per_dev, k, search_slot)
