"""Replicated + sharded search on a 2-D (repl, shards) mesh: the port of
tpuvdb/mesh/replicated.py.

    mesh = (repl, shards)
    corpus rows:   split over `shards`, copied to every replica group
    query batch:   split over `repl` (each replica group serves its slice)
    per group:     each slot's local top-k, merged on the group's first slot
    output:        the groups' slices put back together in order

R replicas multiply query throughput by R at R x memory, and each replica
group holds a complete copy of every shard. Across processes a group may
lie in one process or span several; every process gets the whole batch's
answer (mesh/sharded.groups_topk).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpuvdb_torch.mesh.mesh import Mesh, build_mesh, mesh_devices
from tpuvdb_torch.mesh.sharded import (Sharded, as_queries, groups_topk,
                                       local_topk, shard_rows, slot_rows)


def create_mesh_2d(
    repl: int, shards: int,
    repl_axis: str = "repl", shard_axis: str = "shards",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """(repl, shards) mesh over the first repl * shards slots (devices may
    repeat; None = every visible CUDA card)."""
    return build_mesh(mesh_devices(devices), (repl_axis, shard_axis),
                      (repl, shards))


def shard_corpus_replicated(mesh: Mesh, vectors, sqnorms, valid,
                            shard_axis: str = "shards"):
    """Place the corpus: rows split over `shards`, copied across `repl`."""
    return tuple(shard_rows(mesh, a, shard_axis)
                 for a in (vectors, sqnorms, valid))


def replicated_topk(mesh: Mesh, shard_axis: str, q: torch.Tensor,
                    rows_per_slot: int, k: int, search_slot):
    """Each replica group's even slice of the batch through `groups_topk`,
    the slices concatenated in order on the first group's merge device.
    Across processes a process searches the slices of the groups it has
    slots in, and the one exchange of `groups_topk` puts the whole batch
    together on every process (the reference's tiled all_gather over
    `repl`)."""
    grid = mesh.slot_grid(shard_axis)
    if q.shape[0] % len(grid) != 0:
        raise ValueError(f"batch {q.shape[0]} not divisible by repl axis "
                         f"{len(grid)}")
    per = q.shape[0] // len(grid)
    outs = groups_topk(mesh, [g.tolist() for g in grid],
                       [q[i * per:(i + 1) * per] for i in range(len(grid))],
                       rows_per_slot, k, search_slot)
    dev = outs[0][0].device
    return (torch.cat([d.to(dev) for d, _ in outs]),
            torch.cat([r.to(dev) for _, r in outs]))


def replicated_search(
    queries,
    vectors: Sharded,
    sqnorms: Sharded,
    valid: Sharded,
    k: int,
    block_size: int,
    mesh: Mesh,
    repl_axis: str = "repl",
    shard_axis: str = "shards",
    mode: str = "approx",
    recall_target: float = 0.95,
    row_scales: Optional[Sharded] = None,
    rescore_fetch: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-batch search over the (repl, shards) mesh. The query batch must
    divide by the repl axis size. Pass row_scales for int8 corpora;
    rescore_fetch > 0 adds a per-slot fused exact re-rank (int8 only).
    Returns (dists, rows) for every query, on the first slot's device."""
    if repl_axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no "
                         f"{repl_axis!r} axis")
    q = as_queries(queries)
    rows_per_slot = slot_rows(vectors)
    quantized = row_scales is not None

    def search_slot(s, q_s, kk):
        return local_topk(q_s, vectors[s], sqnorms[s], valid[s], kk,
                          block_size, mode, recall_target,
                          scales=row_scales[s] if quantized else None,
                          rescore_fetch=rescore_fetch if quantized else 0)

    return replicated_topk(mesh, shard_axis, q, rows_per_slot, k,
                           search_slot)


def pad_to_groups(queries: np.ndarray, n_groups: int) -> Tuple[np.ndarray,
                                                              int]:
    """Zero rows appended so the batch divides over the replica groups;
    returns (padded batch, original rows). The caller cuts the pad off
    before anything reads the results."""
    qn = queries.shape[0]
    pad = (-qn) % n_groups
    if pad:
        queries = np.concatenate(
            [queries, np.zeros((pad, queries.shape[1]), queries.dtype)])
    return queries, qn
