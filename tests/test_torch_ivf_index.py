"""tpuvdb_torch.index.ivf.IVFIndex vs tpuvdb.index.ivf.IVFIndex.

* `IVFIndex.from_numpy` of a JAX-built index (f32 and bf16 cells, with
  deleted rows and spill rows): `search` returns the physical rows of the
  reference's probe, `pallas_ivf_search(interpret=True)` mapped through the
  JAX index's row ids, in both forms; distances within rtol 1e-5 plus atol
  1e-4 (||q||^2 - (2 q.x - ||x||^2) cancels for near neighbours).
* Given the same centroids (a trained JAX index's), a port build and a JAX
  build produce the same packed layout (centroids after bisection, cell
  offsets and lengths, row ids, spill rows, cells): the assignment, the
  bisection and the packing are the same.
* Appends and deletes land in the same slots in both, and later searches
  still agree.
* k-means draws the reference's initial centroids. Trained centroids are
  not compared: the two packages sum in other orders.
"""

import numpy as np
import pytest
import torch

from tpuvdb_torch.index.ivf import IVFIndex
from tpuvdb_torch.kernels.kmeans import kmeans


@pytest.fixture()
def jax_ivf():
    import jax.numpy as jnp

    from tpuvdb.index import ivf
    from tpuvdb.kernels.pallas_ivf import pallas_ivf_search

    return jnp, ivf, pallas_ivf_search


def _clustered(rng, n_clusters=12, per=150, d=16):
    centers = rng.standard_normal((n_clusters, d)) * 2
    data = np.concatenate([
        centers[i] + 0.3 * rng.standard_normal((per, d))
        for i in range(n_clusters)]).astype(np.float32)
    return data[rng.permutation(len(data))]


def _port_of(j, dtype=torch.float32, nprobe=None):
    return IVFIndex.from_numpy(
        centroids=j.centroids_np(), grouped=np.asarray(j.grouped, np.float32),
        grouped_sq=np.asarray(j.grouped_sq),
        grouped_valid=np.asarray(j.grouped_valid), row_ids=j.row_ids,
        spill=np.asarray(j.spill, np.float32), spill_sq=np.asarray(j.spill_sq),
        spill_valid=np.asarray(j.spill_valid), spill_row_ids=j.spill_row_ids,
        cell_offsets=np.asarray(j.cell_offsets),
        cell_lens=np.asarray(j.cell_lens), cell_pad=j.cell_pad,
        nprobe=nprobe or j.nprobe, dtype=dtype, device="cpu")


def _reference_rows(jax_ivf, j, q, k, nprobe, force_compact):
    jnp, _, pallas_ivf_search = jax_ivf
    dist, gid = pallas_ivf_search(
        jnp.asarray(q), j.centroids, j.grouped, j.grouped_sq,
        j.grouped_valid, cell_pad=j.cell_pad, k=k, nprobe=nprobe,
        query_tile=8, interpret=True, spill=j.spill, spill_sq=j.spill_sq,
        spill_valid=j.spill_valid, cell_offsets=j.cell_offsets,
        force_compact=force_compact)
    gid = np.asarray(gid)
    n_g = j.grouped.shape[0]
    rows = np.full(gid.shape, -1, np.int64)
    g, s = (gid >= 0) & (gid < n_g), gid >= n_g
    rows[g] = j.row_ids[gid[g]]
    rows[s] = j.spill_row_ids[gid[s] - n_g]
    return np.asarray(dist), rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("force_compact", [False, True])
def test_from_numpy_search_returns_reference_probe_rows(rng, jax_ivf, dtype,
                                                        force_compact):
    jnp, ivf, _ = jax_ivf
    data = _clustered(rng)
    valid = np.ones(len(data), bool)
    valid[rng.choice(len(data), 40, replace=False)] = False
    j = ivf.IVFIndex.build(data, valid, nlist=12, nprobe=4, kmeans_iters=6,
                           dtype=getattr(jnp, dtype), split_oversized=False,
                           cell_cap_quantile=0.6)
    assert j.stats().spill_rows > 0
    j.invalidate_rows(np.arange(0, len(data), 17))
    port = _port_of(j, getattr(torch, dtype))
    q = data[:11] + 0.05 * rng.standard_normal((11, 16)).astype(np.float32)
    want_d, want_r = _reference_rows(jax_ivf, j, q, 10, 4, force_compact)
    got_d, got_r = port.search(q, 10, force_compact=force_compact)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
    assert not np.isin(got_r, np.arange(0, len(data), 17)).any()
    assert not np.isin(got_r, np.flatnonzero(~valid)).any()


def test_build_with_jax_centroids_reproduces_layout(rng, jax_ivf):
    _, ivf, _ = jax_ivf
    data = _clustered(rng, n_clusters=6, per=300)
    data[:400] = data[:400] * 0.2 + data[0]  # one hot cell: bisected
    valid = np.ones(len(data), bool)
    valid[::9] = False
    trained = ivf.IVFIndex.build(data, valid, nlist=6, nprobe=6,
                                 kmeans_iters=6).centroids_np()[:6]
    j = ivf.IVFIndex.build(data, valid, nlist=6, nprobe=6,
                           centroids=trained)
    port = IVFIndex.build(data, valid, nlist=6, nprobe=6, centroids=trained,
                          device="cpu")
    assert port.nlist == j.nlist > 6
    np.testing.assert_array_equal(port.centroids_np(), j.centroids_np())
    np.testing.assert_array_equal(port.cell_offsets_np,
                                  np.asarray(j.cell_offsets))
    np.testing.assert_array_equal(port.cell_lens, np.asarray(j.cell_lens))
    np.testing.assert_array_equal(port.row_ids, j.row_ids)
    np.testing.assert_array_equal(port.spill_row_ids, j.spill_row_ids)
    assert port.cell_pad == j.cell_pad
    np.testing.assert_array_equal(port.grouped.numpy(), np.asarray(j.grouped))
    np.testing.assert_array_equal(port.grouped_valid.numpy(),
                                  np.asarray(j.grouped_valid))


def test_appends_and_deletes_match_jax(rng, jax_ivf):
    _, ivf, _ = jax_ivf
    data = _clustered(rng)
    valid = np.ones(len(data), bool)
    j = ivf.IVFIndex.build(data[:1500], valid[:1500], nlist=12, nprobe=12,
                           kmeans_iters=6)
    port = _port_of(j)
    new = data[1500:] + 0.01
    rows = np.arange(1500, len(data), dtype=np.int64)
    v0 = port.version
    assert j.append_rows(rows, new) and port.append_rows(rows, new)
    j.invalidate_rows(np.arange(0, 1800, 11))
    port.invalidate_rows(np.arange(0, 1800, 11))
    assert port.version == v0 + 2
    np.testing.assert_array_equal(port.row_ids, j.row_ids)
    np.testing.assert_array_equal(port.spill_row_ids, j.spill_row_ids)
    np.testing.assert_array_equal(port.cell_lens, np.asarray(j.cell_lens))
    np.testing.assert_array_equal(port.grouped_valid.numpy(),
                                  np.asarray(j.grouped_valid))
    np.testing.assert_array_equal(port.spill_valid.numpy(),
                                  np.asarray(j.spill_valid))
    assert (port.spill_row_ids >= 1500).any()  # full cells overflowed
    q = new[:9]
    want_d, want_r = _reference_rows(jax_ivf, j, q, 5, 12, False)
    got_d, got_r = port.search(q, 5)
    np.testing.assert_array_equal(got_r, want_r)
    kept = ~np.isin(rows[:9], np.arange(0, 1800, 11))
    assert (got_r[kept, 0] == rows[:9][kept]).all()
    assert not np.isin(got_r, np.arange(0, 1800, 11)).any()
    assert sorted(port.live_phys_rows().tolist()) == \
        sorted(j.live_phys_rows().tolist())


def test_host_helpers_match_reference(rng, jax_ivf):
    """The copied host helpers give the reference's results bit for bit:
    pack_cells, split_oversized_cells, build_inverse_maps and
    lookup_inverse."""
    from tpuvdb_torch.index import ivf as port_ivf

    _, ivf, _ = jax_ivf
    data = _clustered(rng, n_clusters=5, per=120)
    rows = np.flatnonzero(rng.random(len(data)) > 0.1)
    assign = rng.integers(0, 5, len(rows)).astype(np.int32)
    assign[:200] = 2  # one cell past the window: its tail spills
    for a, b in zip(port_ivf.pack_cells(data, rows, assign, 5, 256),
                    ivf.pack_cells(data, rows, assign, 5, 256)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    full = np.full(len(data), -1, np.int32)
    full[rows] = assign
    cents = np.stack([data[full == c].mean(axis=0) for c in range(5)])
    for a, b in zip(port_ivf.split_oversized_cells(data, full, cents, 150),
                    ivf.split_oversized_cells(data, full, cents, 150)):
        np.testing.assert_array_equal(a, b)
    grow = np.where(rng.random(700) > 0.3, rng.permutation(700), -1)
    srow = np.array([700, 701, -1, 705])
    maps = port_ivf.build_inverse_maps(grow, srow)
    for a, b in zip(maps, ivf.build_inverse_maps(grow, srow)):
        np.testing.assert_array_equal(a, b)
    phys = np.array([-1, 0, 5, 700, 705, 999, 3])
    for a, b in zip(port_ivf.lookup_inverse(*maps, phys),
                    ivf.lookup_inverse(*maps, phys)):
        np.testing.assert_array_equal(a, b)


def test_append_reports_full_without_mutating(rng):
    data = _clustered(rng, n_clusters=4, per=100)
    idx = IVFIndex.build(data, np.ones(len(data), bool), nlist=4, nprobe=4,
                         device="cpu")
    before = (idx.row_ids.copy(), idx.spill_row_ids.copy(),
              idx.cell_lens.copy(), idx.version)
    too_many = np.repeat(data[:1], 100_000, axis=0)
    assert not idx.append_rows(np.arange(10 ** 6, 10 ** 6 + 100_000),
                               too_many)
    np.testing.assert_array_equal(idx.row_ids, before[0])
    np.testing.assert_array_equal(idx.spill_row_ids, before[1])
    np.testing.assert_array_equal(idx.cell_lens, before[2])
    assert idx.version == before[3]


def test_kmeans_draws_the_reference_initial_centroids(rng):
    from tpuvdb.kernels.kmeans import kmeans as jax_kmeans

    data = _clustered(rng, n_clusters=5, per=60)
    valid = np.ones(len(data), bool)
    valid[::7] = False
    for nlist in (8, 400):  # 400 > live rows: tiled + jittered
        jc, ja = jax_kmeans(data, valid, nlist=nlist, iters=0)
        tc, ta = kmeans(data, valid, nlist=nlist, iters=0, device="cpu")
        np.testing.assert_array_equal(tc, jc)
        assert (ta[~valid] == -1).all()
        if nlist == 8:  # the tiled copies differ by 1e-4: near-ties there
            np.testing.assert_array_equal(ta, ja)


def test_masked_valid_restricts_the_probe(rng):
    data = _clustered(rng, n_clusters=4, per=100)
    idx = IVFIndex.build(data, np.ones(len(data), bool), nlist=4, nprobe=4,
                         device="cpu")
    allowed = np.arange(0, len(data), 3)
    _, rows = idx.search(data[:5], 10,
                         valid_override=idx.masked_valid(allowed))
    assert np.isin(rows[rows >= 0], allowed).all()
    assert rows[0, 0] == 0 and rows[3, 0] == 3


def test_device_none_means_cuda_and_int8_waits(rng):
    data = _clustered(rng, n_clusters=2, per=50)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            IVFIndex.build(data, np.ones(len(data), bool), nlist=2)
    # int8 cells waited for the int8 slice and no longer do (parity with
    # the reference is in test_torch_ivf_probe_int8.py); other dtypes raise
    idx = IVFIndex.build(data, np.ones(len(data), bool), nlist=2,
                         dtype=torch.int8, device="cpu")
    assert idx.quantized and idx.grouped.dtype == torch.int8
    assert idx.cell_scales.shape == idx.grouped_sq.shape
    _, rows = idx.search(data[:3], 1)
    assert rows[:, 0].tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="IVF cells"):
        IVFIndex.build(data, np.ones(len(data), bool), nlist=2,
                       dtype=torch.float16, device="cpu")
