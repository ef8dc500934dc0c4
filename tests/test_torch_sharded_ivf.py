"""tpuvdb_torch.mesh.sharded_ivf vs tpuvdb.mesh.sharded_ivf on the CPU.

The JAX index runs on the conftest's 8-device CPU mesh (its XLA gather
route: no Pallas there), the port on 8 CPU slots (the probe kernels'
plain twins), on the same seeded inputs.
* Given the JAX index's centroids as the warm table (and its codebooks and
  rotation for PQ / OPQ), the host layout is bit-equal: cell_pad, the
  centroid tables, offsets, lens, caps, row_ids, spill_row_ids and the
  grouped rows (f32 rows and int8 codes equal; PQ codes equal except at
  exact code ties, at most 0.1% of them).
* With every cell probed, rows equal the JAX index's outside exact ties,
  distances within rtol 1e-5.
* Otherwise recall@10 >= 0.85 for both against the oracle, and the first
  key of a self-query equal. PQ cells: the same candidates (overlap >= 0.9,
  ADC distances within 1e-3 relative). int8 cells score the quantized
  query batch, as the kernel does: a distance within the quantization's
  worst-case bound.
* Appends land in the same cells, spill slots and row maps as JAX's (the
  plan is the same host arithmetic); deletes and filters mask rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_mesh_sharded import assert_rows_equal_outside_ties
from tpuvdb.mesh.mesh import create_mesh as jax_create_mesh
from tpuvdb.mesh.sharded_ivf import ShardedIVFIndex as JaxSharded
from tpuvdb_torch.kernels.distance import numpy_oracle
from tpuvdb_torch.mesh import create_mesh
from tpuvdb_torch.mesh.replicated import create_mesh_2d
from tpuvdb_torch.mesh.sharded_ivf import ShardedIVFIndex

CPU8 = ["cpu"] * 8


def clustered(rng, n_clusters, per, d, spread=0.3):
    centers = rng.standard_normal((n_clusters, d)) * 5
    data = np.concatenate([
        centers[i] + spread * rng.standard_normal((per, d))
        for i in range(n_clusters)]).astype(np.float32)
    return data[rng.permutation(len(data))]


def _recall(rows, oidx, k):
    return np.mean([len(set(rows[i][rows[i] >= 0]) & set(oidx[i])) / k
                    for i in range(len(rows))])


def _grouped(idx, region="grouped"):
    """The port's per-shard rows stacked as the JAX (ndev, rows, ...)."""
    return np.stack([getattr(s, region).cpu().numpy()
                     for s in idx.slots[:idx.row_ids.shape[0]]])


def _pair(data, valid, cells, **kw):
    """A JAX build, then the JAX and the port builds warm from its tables:
    (jax warm, port warm)."""
    jmesh = jax_create_mesh()
    jdtype = {"int8": jnp.int8}.get(cells, jnp.float32)
    tdtype = {"int8": torch.int8}.get(cells, torch.float32)
    if cells in ("pq", "opq"):
        kw = dict(kw, pq_subq=8, opq=cells == "opq")
    j1 = JaxSharded.build(data, valid, jmesh, dtype=jdtype, **kw)
    warm = dict(centroids=np.asarray(j1.centroids))
    if j1.pq:
        warm["pq_codebooks"] = np.asarray(j1.pq_codebooks)
        if j1.pq_rotation is not None:
            warm["pq_rotation"] = np.asarray(j1.pq_rotation)
    j2 = JaxSharded.build(data, valid, jmesh, dtype=jdtype, **warm, **kw)
    t = ShardedIVFIndex.build(data, valid, create_mesh(devices=CPU8),
                              dtype=tdtype, **warm, **kw)
    return j2, t


@pytest.mark.parametrize("cells", ["f32", "int8", "pq", "opq"])
def test_warm_build_reproduces_the_layout(rng, cells):
    data = clustered(rng, 24, 160, 32)
    valid = np.ones(len(data), bool)
    valid[rng.choice(len(data), 40, replace=False)] = False
    j, t = _pair(data, valid, cells, nlist=6, nprobe=4, kmeans_iters=4)
    assert t.cell_pad == j.cell_pad and t.nprobe == j.nprobe
    np.testing.assert_array_equal(t.centroids, np.asarray(j.centroids))
    for name in ("cell_offsets", "cell_lens"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))
    for name in ("cell_caps", "row_ids", "spill_row_ids"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.testing.assert_array_equal(_grouped(t, "grouped_valid"),
                                  np.asarray(j.gval))
    g_t, g_j = _grouped(t), np.asarray(j.grouped)
    if cells in ("pq", "opq"):
        live = np.asarray(j.gval)
        assert (g_t[live] != g_j[live]).mean() <= 1e-3
        np.testing.assert_array_equal(np.asarray(j.spill_cells),
                                      t.spill_cells)
    else:
        np.testing.assert_array_equal(g_t, g_j)
        np.testing.assert_allclose(_grouped(t, "grouped_sq"),
                                   np.asarray(j.gsq), rtol=1e-5)
    if cells == "int8":
        np.testing.assert_array_equal(_grouped(t, "cell_scales"),
                                      np.asarray(j.cell_scales))
    if cells in ("pq", "opq"):
        # the same candidates: the PQ probe kernel's twin against the
        # reference's XLA ADC gather (bf16 tables in both)
        assert t.pq and (t.pq_rotation_np() is not None) == (cells == "opq")
        d_t, r_t = t.search(data[:16], k=16)
        d_j, r_j = j.search(data[:16], k=16)
        overlap = np.mean([len(set(r_t[i]) & set(np.asarray(r_j)[i])) / 16
                           for i in range(16)])
        assert overlap >= 0.9, overlap
        np.testing.assert_allclose(d_t, d_j, rtol=1e-3, atol=1e-2)
    js, ts = j.stats(), t.stats()
    assert (ts.nlist, ts.cell_pad, ts.spill_rows, ts.grouped_rows) == (
        js.nlist, js.cell_pad, js.spill_rows, js.grouped_rows)
    assert ts.fill == pytest.approx(js.fill)


def test_every_cell_probed_returns_the_references_rows(rng):
    """Small shards (a few 128-row chunks each) so that no candidate slot
    of the probe is shared: the scan over every cell is exact in both."""
    data = rng.standard_normal((8 * 192, 16)).astype(np.float32)
    valid = np.ones(len(data), bool)
    valid[[3, 500, 1000]] = False
    j, t = _pair(data, valid, "f32", nlist=2, nprobe=2, kmeans_iters=3)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    nprobe = t.centroids.shape[1]
    d_t, r_t = t.search(q, k=10, nprobe=nprobe)
    d_j, r_j = j.search(q, k=10, nprobe=nprobe)
    assert_rows_equal_outside_ties(d_t, r_t, d_j, r_j)
    od, oi = numpy_oracle(q, data, valid, 10)
    assert_rows_equal_outside_ties(d_t, r_t, od, oi)


def test_sharded_ivf_recall_and_first_key(rng):
    data = clustered(rng, 32, 256, 32)                    # 8192 rows
    valid = np.ones(len(data), bool)
    t = ShardedIVFIndex.build(data, valid, create_mesh(devices=CPU8),
                              nlist=16, nprobe=8, kmeans_iters=6)
    j = JaxSharded.build(data, valid, jax_create_mesh(), nlist=16, nprobe=8,
                         kmeans_iters=6)
    q = data[rng.choice(len(data), 32, replace=False)]
    q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)
    _, oidx = numpy_oracle(q, data, valid, 10)
    d_t, r_t = t.search(q, k=10)
    _, r_j = j.search(q, k=10)
    assert d_t.shape == (32, 10)
    assert _recall(r_t, oidx, 10) >= 0.85
    assert _recall(r_j, oidx, 10) >= 0.85
    exact = ((q[:, None, :] - data[r_t]) ** 2).sum(-1)
    np.testing.assert_allclose(d_t, exact, rtol=1e-5, atol=1e-2)
    # self-queries: a stored row of every shard's range comes first in both
    targets = np.array([dev * 1024 + 37 for dev in range(8)])
    _, r_t = t.search(data[targets], k=1)
    _, r_j = j.search(data[targets], k=1)
    np.testing.assert_array_equal(r_t[:, 0], targets)
    np.testing.assert_array_equal(r_t[:, 0], np.asarray(r_j)[:, 0])


def test_invalid_rows_and_deletes_are_skipped(rng):
    data = rng.standard_normal((8 * 256, 16)).astype(np.float32)
    valid = np.ones(len(data), bool)
    valid[100] = False
    t = ShardedIVFIndex.build(data, valid, create_mesh(devices=CPU8),
                              nlist=4, nprobe=4)
    _, rows = t.search(data[100:101], k=3)
    assert 100 not in rows
    _, rows = t.search(data[200:201], k=3)
    assert rows[0, 0] == 200
    t.invalidate_rows(np.array([200, 7, -1]))
    _, rows = t.search(data[[200, 7]], k=3)
    assert 200 not in rows and 7 not in rows
    # the filter pushdown: only the candidate rows score
    cand = np.array([11, 900, 1500])
    _, rows = t.search(data[:2], k=3, valid_override=t.masked_valid(cand))
    assert set(rows.ravel()) <= set(cand.tolist())


def test_int8_cells(rng):
    sizes = (16384, 8192, 4096, 4096, 2048, 2048, 1024, 27648)  # skewed
    centers = rng.standard_normal((len(sizes), 32)) * 5
    data = np.concatenate([
        centers[i] + 1.0 * rng.standard_normal((m, 32))
        for i, m in enumerate(sizes)]).astype(np.float32)
    data = data[rng.permutation(len(data))]
    valid = np.ones(len(data), bool)
    t = ShardedIVFIndex.build(data, valid, create_mesh(devices=CPU8),
                              nlist=16, nprobe=8, kmeans_iters=6,
                              dtype=torch.int8)
    assert t.quantized and t.slots[0].grouped.dtype == torch.int8
    assert t.stats().fill >= 0.75
    q = data[rng.choice(len(data), 32, replace=False)]
    dist, rows = t.search(q, k=10)
    _, oidx = numpy_oracle(q, data, valid, 10)
    assert _recall(rows, oidx, 10) >= 0.7
    # the probe quantizes the query batch with one scale s_q, as the
    # kernel does (the reference's CPU gather scores f32 queries): a
    # distance is off by at most |x|_1 s_q + |q|_1 s_r, 2 x the dot's error
    x = data[rows[:, 0]]
    s_q = np.abs(q).max() / 127.0
    s_r = np.abs(x).max(axis=1) / 127.0
    bound = np.abs(x).sum(1) * s_q + np.abs(q).sum(1) * s_r
    true = ((q - x) ** 2).sum(-1)
    assert (np.abs(true - dist[:, 0]) <= bound).all()
    victims = rows[0][rows[0] >= 0][:3]
    t.invalidate_rows(victims)
    _, rows2 = t.search(q[:1], k=10)
    assert not set(rows2[0]) & set(victims.tolist())


@pytest.mark.parametrize("cells", ["f32", "int8", "pq"])
def test_appends_match_jax(rng, cells):
    """Rows route to their owning shard and land in the same cell window
    or spill slot as in the reference; the collective search finds them."""
    n, d = 2048, 32
    data = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - 64:] = False  # slots not yet written at build time
    j, t = _pair(data, valid, cells, nlist=8, nprobe=8, kmeans_iters=4)
    new = (15.0 + rng.standard_normal((64, d))).astype(np.float32)
    phys = np.arange(n - 64, n)
    assert t.append_rows(phys, new) and j.append_rows(phys, new)
    for name in ("row_ids", "spill_row_ids"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.cell_lens, np.asarray(j.cell_lens))
    np.testing.assert_array_equal(_grouped(t, "grouped_valid"),
                                  np.asarray(j.gval))
    np.testing.assert_array_equal(_grouped(t, "spill_valid"),
                                  np.asarray(j.sval))
    dist, rows = t.search(new[:16], k=8)
    if cells == "pq":  # ADC: each appended row among its own candidates
        assert all(p in r for p, r in zip(phys[:16], rows))
    else:
        np.testing.assert_array_equal(rows[:, 0], phys[:16])
        assert (np.abs(dist[:, 0]) < (40.0 if cells == "int8" else 1e-2)
                ).all()
    t.invalidate_rows(phys[:1])
    _, r2 = t.search(new[:1], k=1)
    assert r2[0, 0] != phys[0]
    # out of room: no mutation, False
    lens = t.cell_lens.copy()
    assert not t.append_rows(np.array([10 * n]), new[:1])
    np.testing.assert_array_equal(t.cell_lens, lens)


def test_replicated_ivf_matches_one_copy(rng):
    """On a (2, 4) mesh each replica group holds a full copy of the cells:
    the batch (odd, so padded) answers as the 4-slot 1-D mesh does."""
    data = clustered(rng, 16, 128, 16)
    valid = np.ones(len(data), bool)
    kw = dict(nlist=4, nprobe=4, kmeans_iters=3)
    one = ShardedIVFIndex.build(data, valid, create_mesh(devices=["cpu"] * 4),
                                **kw)
    two = ShardedIVFIndex.build(data, valid,
                                create_mesh_2d(2, 4, devices=CPU8),
                                repl_axis="repl", **kw)
    assert two.nbytes() == 2 * one.nbytes()
    q = data[:7] + 0.01
    d1, r1 = one.search(q, k=5)
    d2, r2 = two.search(q, k=5)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)
    phys = np.array([5, 700])
    two.invalidate_rows(phys)
    _, r3 = two.search(data[phys], k=3)
    assert not set(r3.ravel()) & set(phys.tolist())
