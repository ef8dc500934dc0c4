"""A dry run of the mesh paths on n slots, modelled on the reference's
`__graft_entry__.dryrun_multichip`: the flat index's scatter and sharded
search, the sharded IVF index (f32 with an append, and PQ), and on a 2-D
(2, n / 2) mesh the replicated flat search, IVF and int8 with a per-slot
exact re-rank. Each result is held against a numpy oracle; any miss
raises.

    python -c "from tpuvdb_torch.mesh.dryrun import dryrun_multichip; \\
               dryrun_multichip(4)"                  # every visible card
    dryrun_multichip(8, devices=["cpu"] * 8)         # eight CPU slots
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from tpuvdb_torch.index.exact import DeviceExactIndex
from tpuvdb_torch.index.layout import StackedLayout
from tpuvdb_torch.kernels.distance import numpy_oracle
from tpuvdb_torch.kernels.quant import quantize_rows_np
from tpuvdb_torch.mesh.mesh import create_mesh, mesh_devices
from tpuvdb_torch.mesh.replicated import (create_mesh_2d, replicated_search,
                                          shard_corpus_replicated)
from tpuvdb_torch.mesh.sharded import shard_rows
from tpuvdb_torch.mesh.sharded_ivf import ShardedIVFIndex


def _check(name: str, ok: bool, detail) -> None:
    if not ok:
        raise AssertionError(f"dry run, {name}: {detail}")


def _rows_equal(got: np.ndarray, want: np.ndarray) -> bool:
    return np.array_equal(np.asarray(got, np.int64),
                          np.asarray(want, np.int64))


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """Run every mesh path on the first n_devices slots of `devices` (None
    = every visible CUDA card). Returns what was checked, by path."""
    devs = mesh_devices(devices)[:n_devices]
    if len(devs) < n_devices:
        raise ValueError(f"asked for {n_devices} devices, have {len(devs)}")
    mesh = create_mesh(n_devices=n_devices, axis="shards", devices=devs)
    rng = np.random.default_rng(0)
    out = {}
    block, dim = 128, 64

    # flat: a staged insert scattered into the sharded corpus (rows spread
    # over every slot's range), then the sharded search
    rows_per_dev = 2 * block
    layout = StackedLayout(num_shards=n_devices, phys_cap=rows_per_dev,
                           dim=dim)
    idx = DeviceExactIndex(layout, block_size=block, mesh=mesh)
    n_new = 4 * n_devices
    rows = np.arange(n_new, dtype=np.int64) * (layout.total_rows // n_new)
    vecs = rng.standard_normal((n_new, dim)).astype(np.float32)
    idx.apply_updates(rows, vecs, np.ones(n_new, bool))
    corpus = np.zeros((layout.total_rows, dim), np.float32)
    corpus[rows] = vecs
    live = np.zeros(layout.total_rows, bool)
    live[rows] = True
    queries = rng.standard_normal((8, dim)).astype(np.float32)
    dist, got = idx.search(queries, k=5)
    odist, orows = numpy_oracle(queries, corpus, live, 5)
    _check("flat sharded", _rows_equal(got, orows), (got, orows))
    _check("flat sharded distances",
           np.allclose(dist, odist, rtol=1e-4, atol=1e-3), (dist, odist))
    seen = {int(r) // rows_per_dev for r in got.ravel() if r >= 0}
    _check("flat sharded slots", len(seen) > 1, seen)
    out["flat_sharded"] = {"queries": len(queries), "slots_hit": len(seen)}

    # sharded IVF, f32: self-retrieval, the oracle at full probe, and an
    # append (the sustained-ingest path)
    n_ivf = 128 * n_devices
    ivf_data = rng.standard_normal((n_ivf, dim)).astype(np.float32)
    ivf_valid = np.ones(n_ivf, bool)
    ivf_valid[-2 * n_devices:] = False  # head-room for the append below
    sivf = ShardedIVFIndex.build(ivf_data, ivf_valid, mesh, axis="shards",
                                 nlist=4, nprobe=4, kmeans_iters=3)
    di, ri = sivf.search(ivf_data[:4], k=3)
    _check("ivf self", _rows_equal(ri[:, 0], np.arange(4)) and
           (di[:, 0] < 1e-2).all(), (ri, di))
    # every cell probed: the oracle's neighbours, up to the probe's
    # candidate slots (a row can lose its slot to a closer one)
    _, oi = numpy_oracle(queries, ivf_data, ivf_valid, 3)
    di, ri = sivf.search(queries, k=3, nprobe=sivf.centroids.shape[1])
    recall = np.mean([len(set(ri[i]) & set(oi[i])) / 3
                      for i in range(len(queries))])
    _check("ivf full probe recall", recall >= 0.9, (ri, oi))
    exact = ((queries[:, None, :] - ivf_data[ri]) ** 2).sum(-1)
    _check("ivf full probe distances",
           np.allclose(di, exact, rtol=1e-4, atol=1e-3), (di, exact))
    new_rows = np.arange(n_ivf - 2 * n_devices, n_ivf, dtype=np.int64)
    new_vecs = (10.0 + rng.standard_normal((len(new_rows), dim))
                ).astype(np.float32)
    _check("ivf append", sivf.append_rows(new_rows, new_vecs), "no room")
    _, r2i = sivf.search(new_vecs[:4], k=1)
    _check("ivf appended", _rows_equal(r2i[:, 0], new_rows[:4]), r2i)
    out["ivf"] = {"rows": n_ivf, "full_probe_recall": float(recall),
                  "appended": len(new_rows)}

    # residual IVF-PQ: each self row among its ADC candidates
    sivf_pq = ShardedIVFIndex.build(
        ivf_data, np.ones(n_ivf, bool), mesh, axis="shards", nlist=4,
        nprobe=4, kmeans_iters=3, pq_subq=8)
    _, rpq = sivf_pq.search(ivf_data[:4], k=8)
    for i in range(4):
        _check("ivf pq self", i in rpq[i], rpq[i])
    out["ivf_pq"] = {"rows": n_ivf, "code_bytes": 8}

    if n_devices >= 4 and n_devices % 2 == 0:
        # 2-D (repl, shards): the corpus copied to each replica group, the
        # batch split over the groups
        mesh2 = create_mesh_2d(2, n_devices // 2, devices=devs)
        corpus2 = rng.standard_normal(
            ((n_devices // 2) * block, dim)).astype(np.float32)
        sq = np.einsum("nd,nd->n", corpus2, corpus2).astype(np.float32)
        ones = np.ones(len(corpus2), bool)
        v2, s2, m2 = shard_corpus_replicated(mesh2, corpus2, sq, ones)
        q2 = corpus2[:4]
        d2, r2 = replicated_search(q2, v2, s2, m2, k=1, block_size=block,
                                   mesh=mesh2)
        _check("replicated flat", _rows_equal(r2.cpu().numpy()[:, 0],
                                              np.arange(4)), r2)
        _check("replicated flat distances",
               (d2.cpu().numpy()[:, 0] < 1e-2).all(), d2)

        # IVF on the 2-D mesh; an odd batch exercises the replica pad
        n2 = 128 * (n_devices // 2)
        sivf2 = ShardedIVFIndex.build(
            ivf_data[:n2], np.ones(n2, bool), mesh2, axis="shards",
            nlist=4, nprobe=4, kmeans_iters=3, repl_axis="repl")
        d3, r3 = sivf2.search(ivf_data[:3], k=1)
        _check("replicated ivf", _rows_equal(r3[:, 0], np.arange(3)) and
               (d3[:, 0] < 1e-2).all(), (r3, d3))

        # int8 with the per-slot exact re-rank: distances exact over the
        # stored (dequantized) rows
        ci8, scales = quantize_rows_np(corpus2)
        stored = ci8.astype(np.float32) * scales[:, None]
        sq_q = np.einsum("nd,nd->n", stored, stored).astype(np.float32)
        vq, sqq, vdq = shard_corpus_replicated(mesh2, ci8, sq_q, ones)
        d4, r4 = replicated_search(
            q2, vq, sqq, vdq, k=1, block_size=block, mesh=mesh2,
            row_scales=shard_rows(mesh2, scales), rescore_fetch=8)
        _, o4 = numpy_oracle(q2, stored, ones, 1)
        _check("replicated int8", _rows_equal(r4.cpu().numpy(), o4), r4)
        true0 = float(np.sum((q2[0] - stored[0]) ** 2))
        _check("replicated int8 distance",
               abs(float(d4[0, 0]) - true0) < 1e-2, (d4, true0))
        out["replicated"] = {"mesh": [2, n_devices // 2],
                             "ivf_queries": 3, "int8_queries": 4}
    return out
