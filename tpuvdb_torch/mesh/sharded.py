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
of each group, and the groups' (Q, k) pairs meet in one
`torch.distributed.all_gather`, in rank (= slot) order, before the same
merge; a process that owns no slot of a group sends empty rows for it.

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
from tpuvdb_torch.mesh.mesh import (Mesh, all_gather_tensor,
                                    collective_device, on_device)

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


def merge_processes(parts: Sequence, q_rows: int, k: int,
                    device: torch.device) -> list:
    """The cross-process half of the merge: one all_gather of every
    group's (q_rows, k) pair (rows already global) from every process,
    each group then merged in rank order. A process with no slot in a
    group sends +inf / -1 rows for it, so every process sends the same
    shape. Slots are numbered in rank order and a group's shard positions
    ascend with their slots, so rank order keeps the lower slot first on
    a tie, as the one-process merge does. Each pair packs into f64 (f32
    distances and rows below 2**53 are exact there)."""
    cdev = collective_device()
    empty = torch.stack([
        torch.full((q_rows, k), float("inf"), dtype=torch.float64,
                   device=cdev),
        torch.full((q_rows, k), -1.0, dtype=torch.float64, device=cdev)])
    mine = torch.stack([
        empty if p is None else
        torch.stack([t.to(cdev, torch.float64) for t in p])
        for p in parts])                              # (G, 2, q_rows, k)
    every = all_gather_tensor(mine)
    out = []
    for g in range(len(parts)):
        pairs = [(w[g, 0].to(torch.float32), w[g, 1].to(torch.int64))
                 for w in every]
        dist, rows = merge_topk(pairs, [0] * len(pairs), k, cdev)
        out.append((dist.to(device), rows.to(device)))
    return out


def groups_topk(mesh: Mesh, groups: Sequence[Sequence[int]],
                qs: Sequence[torch.Tensor], rows_per_slot: int, k: int,
                search_slot) -> list:
    """The top-k of each group (its flat slots in shard order) over its
    batch `qs[g]`: each local slot's top-k (`search_slot(slot, q on the
    slot's device, k_local)` -> (dist, idx)), merged on the group's first
    local slot's device. Across processes the groups' merged pairs then
    meet in one exchange (`merge_processes`), so every process returns
    every group's answer; every process calls this with the same groups
    and batch shapes. Launches run back to back, one device after the
    other, with no host read until the caller's."""
    devs = mesh.flat_devices()
    k_local = min(k, rows_per_slot)
    parts, out_dev = [], None
    for slots, q in zip(groups, qs):
        mine = [(p, s) for p, s in enumerate(slots) if mesh.is_local(s)]
        if not mine:
            if not mesh.distributed:
                raise ValueError("this process owns no slot of the mesh")
            parts.append(None)
            continue
        slot_parts, offsets, q_on = [], [], {}
        for p, s in mine:
            dev = devs[s]
            if dev not in q_on:
                q_on[dev] = q.to(dev, non_blocking=True)
            with on_device(dev):
                slot_parts.append(search_slot(s, q_on[dev], k_local))
            offsets.append(p * rows_per_slot)
        merge_dev = devs[mine[0][1]]
        out_dev = out_dev or merge_dev
        with on_device(merge_dev):
            parts.append(merge_topk(slot_parts, offsets, k, merge_dev))
    if not mesh.distributed:
        return parts
    local = mesh.local_slots()
    out_dev = out_dev or (devs[local[0]] if local else torch.device("cpu"))
    q_rows = {int(q.shape[0]) for q in qs}
    if len(q_rows) != 1:
        raise ValueError(f"groups' batches differ in rows {sorted(q_rows)}")
    return merge_processes(parts, q_rows.pop(), k, out_dev)


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
    return groups_topk(mesh, [mesh.slot_grid(axis)[0].tolist()], [q],
                       rows_per_dev, k, search_slot)[0]
