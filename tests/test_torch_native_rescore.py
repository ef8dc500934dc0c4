"""The port's fused native exact rescore against the numpy forms.

Mirrors tests/test_native_rescore.py on tpuvdb_torch:
* `ShardMirror.rescore_into` against the GEMM form from `rows_f32`, for
  f32 and int8 mirrors in RAM and in mmap files (rtol 2e-4, atol 2e-3, the
  reference's tolerance for its native loop);
* a slot outside the mirror writes +inf and an output position outside the
  window is skipped; non-contiguous inputs are coerced, a wrong output
  buffer is refused;
* the port engine's native `_rescore_exact` and `_exact_masked` against the
  JAX engine's numpy forms on the same rows (the JAX package's
  `native.rescore_available` patched to False, so no test here depends on
  the reference's build): ids equal except inside runs of distances equal
  to within the tolerance, distances at rtol 1e-5, atol 1e-4;
* an IVF-PQ engine's adaptive rescore counts the same `rescored_rows` and
  `rescore_skipped_rows` and returns the same keys on the native and the
  numpy path, with distances at rtol 1e-5 and an atol of 2e-6 |q|^2 (the
  cancellation of |q|^2 - 2 q.v + |v|^2 at that corpus's norms).
"""

import types

import numpy as np
import pytest

import tpuvdb.native as jax_native
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb.index.layout import ShardMirror as JaxMirror
from tpuvdb_torch import DBConfig, VectorDBEngine, native
from tpuvdb_torch.index.layout import ShardMirror

RTOL, ATOL = 1e-5, 1e-4


def _rows(rng, n, d):
    return rng.standard_normal((n, d)).astype(np.float32)


def _mk_mirror(dtype, data, path=None, cls=ShardMirror):
    n, d = data.shape
    kw = {"path": path} if path else {}
    m = cls(d, capacity=4 * n, init_cap=4 * n, dtype=dtype, **kw)
    m.alloc(n)
    m.write_batch(0, data)
    return m


@pytest.mark.parametrize("backing", ["ram", "mmap"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_rescore_into_matches_rows_f32(dtype, backing, tmp_path):
    rng = np.random.default_rng(7)
    n, d, Q, F = 300, 96, 4, 16
    m = _mk_mirror(dtype, _rows(rng, n, d),
                   str(tmp_path / "m" / "shard_0") if backing == "mmap"
                   else None)
    q = _rows(rng, Q, d)
    qsq = np.einsum("qd,qd->q", q, q).astype(np.float32)
    slots = rng.integers(0, n, Q * F).astype(np.int64)
    opos = np.arange(Q * F, dtype=np.int64)
    out = np.full(Q * F, np.inf, np.float32)
    m.rescore_into(q, qsq, F, slots, opos, out)
    vecs = m.rows_f32(slots)
    want = (qsq[:, None]
            - 2.0 * np.einsum("qfd,qd->qf", vecs.reshape(Q, F, d), q)
            + np.einsum("nd,nd->n", vecs, vecs).reshape(Q, F))
    np.testing.assert_allclose(out.reshape(Q, F), want, rtol=2e-4,
                               atol=2e-3)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_rescore_bounds_violation_writes_inf(dtype):
    rng = np.random.default_rng(11)
    n, d, Q, F = 64, 32, 2, 8
    m = _mk_mirror(dtype, _rows(rng, n, d))
    q = _rows(rng, Q, d)
    qsq = np.einsum("qd,qd->q", q, q).astype(np.float32)
    slots = rng.integers(0, n, Q * F).astype(np.int64)
    slots[0] = m.phys_cap + 10_000_000  # far past the physical rows
    slots[1] = -5
    opos = np.arange(Q * F, dtype=np.int64)
    opos[2] = Q * F + 99  # outside the output: skipped
    out = np.full(Q * F, np.inf, np.float32)
    m.rescore_into(q, qsq, F, slots, opos, out)
    assert np.isinf(out[:3]).all()
    assert np.isfinite(out[3:]).all()


def test_rescore_rejects_noncontiguous_inputs():
    rng = np.random.default_rng(4)
    n, d, Q, F = 32, 16, 2, 4
    m = _mk_mirror("float32", _rows(rng, n, d))
    q64 = rng.standard_normal((Q, 2 * d))[:, ::2]  # strided float64 view
    qsq = np.einsum("qd,qd->q", q64, q64).astype(np.float32)
    slots = rng.integers(0, n, Q * F).astype(np.int64)
    opos = np.arange(Q * F, dtype=np.int64)
    want = np.full(Q * F, np.inf, np.float32)
    m.rescore_into(np.ascontiguousarray(q64), qsq, F, slots, opos, want)
    out = np.full(Q * F, np.inf, np.float32)
    m.rescore_into(q64, qsq, F, slots, opos, out)  # coerced: same result
    np.testing.assert_allclose(out, want, rtol=1e-6)
    with pytest.raises(ValueError, match="out must be f32"):
        native.rescore_rows(np.ascontiguousarray(q64, np.float32), qsq, F,
                            m._vec, None, m._sq, slots, opos,
                            np.full(Q * F, np.inf, np.float64))
    with pytest.raises(ValueError, match="vec must be C-contiguous"):
        native.rescore_rows(np.ascontiguousarray(q64, np.float32), qsq, F,
                            m._vec[:, ::2], None, m._sq, slots, opos,
                            np.full(Q * F, np.inf, np.float32))


def _two_packages(dtype, rng, n=200, d=64, shards=2):
    """The same rows in two port mirrors and two JAX mirrors, a stub
    layout, and a (Q, F) candidate window across shards with misses."""
    datas = [_rows(rng, n, d) for _ in range(shards)]
    port = [_mk_mirror(dtype, x) for x in datas]
    jax = [_mk_mirror(dtype, x, cls=JaxMirror) for x in datas]
    layout = types.SimpleNamespace(phys_cap=port[0].phys_cap)
    assert jax[0].phys_cap == layout.phys_cap
    Q, F = 3, 20
    rows = rng.integers(0, n, (Q, F)).astype(np.int64)
    rows += rng.integers(0, shards, (Q, F)) * layout.phys_cap
    rows[0, 3] = rows[2, 0] = -1
    return port, jax, layout, _rows(rng, Q, d), rows


def _assert_same_ranking(d_got, r_got, d_want, r_want):
    np.testing.assert_allclose(d_got, d_want, rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(d_want[np.isfinite(d_want)]).max()
    for qi in range(d_want.shape[0]):
        dq = d_want[qi]
        # a position apart from both neighbours by more than the tolerance
        # holds the same row; inside a near-tie run the rows may permute
        apart = np.ones(len(dq) + 1, bool)
        apart[1:-1] = ~np.isclose(dq[1:], dq[:-1], atol=tol, rtol=0)
        sep = apart[:-1] & apart[1:] & np.isfinite(dq)
        assert (r_got[qi][sep] == r_want[qi][sep]).all()
    assert (np.sort(r_got, axis=1) == np.sort(r_want, axis=1)).all()


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_rescore_exact_native_matches_jax_numpy(dtype, monkeypatch):
    rng = np.random.default_rng(3)
    port, jax, layout, q, rows = _two_packages(dtype, rng)
    d_nat, r_nat = VectorDBEngine._rescore_exact(q, rows, layout, port,
                                                 native=True)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)
    d_np, r_np = JaxEngine._rescore_exact(
        types.SimpleNamespace(mirrors=jax), q, rows, layout)
    _assert_same_ranking(d_nat, r_nat, d_np, r_np)
    assert np.isinf(d_nat[0, -1]) and np.isinf(d_nat[2, -1])  # misses last
    # the port's numpy form is the reference's
    d_pn, r_pn = VectorDBEngine._rescore_exact(q, rows, layout, port)
    np.testing.assert_array_equal(d_pn, d_np)
    np.testing.assert_array_equal(r_pn, r_np)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_exact_masked_native_matches_jax_numpy(dtype, monkeypatch):
    rng = np.random.default_rng(9)
    port, jax, layout, q, rows = _two_packages(dtype, rng)
    mask = rng.random(rows.shape) < 0.6
    got = VectorDBEngine._exact_masked(q, rows, mask, layout, port,
                                       native=True)
    monkeypatch.setattr(jax_native, "rescore_available", lambda: False)
    want = JaxEngine._exact_masked(types.SimpleNamespace(), q, rows, mask,
                                   layout, jax)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        VectorDBEngine._exact_masked(q, rows, mask, layout, port), want)


@pytest.mark.parametrize("mirror_dtype", ["float32", "int8"])
def test_adaptive_rescore_counters_native_equal_numpy(mirror_dtype):
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 4
    data = (centers[rng.integers(0, 8, 2000)]
            + rng.standard_normal((2000, 16)).astype(np.float32))
    eng = VectorDBEngine(DBConfig(
        vector_dim=16, shard_count=2, shard_capacity=4096, block_size=128,
        index_type="ivf", ivf_nlist=8, ivf_nprobe=8, ivf_kmeans_iters=5,
        ivf_delta_max=64, ivf_pq_subq=4, mirror_dtype=mirror_dtype,
        ivf_pq_adaptive_rescore=True, checkpoint_every_puts=10 ** 9,
        compact_every_puts=10 ** 9), device="cpu")
    assert eng.put_rows([f"k{i}" for i in range(2000)], data).success
    eng.flush()
    queries = data[:32] + 0.1
    assert eng.rescore_backend == "native"
    got = {}
    for backend in ("native", "numpy"):
        eng.rescore_backend = backend
        before = dict(eng.stats)
        d, k = eng.search_batch(queries, 10)
        got[backend] = (d, k, {c: eng.stats[c] - before[c] for c in
                               ("rescored_rows", "rescore_skipped_rows")})
    (dn, kn, cn), (dp, kp, cp) = got["native"], got["numpy"]
    assert cn == cp and cn["rescored_rows"] > 0
    assert cn["rescore_skipped_rows"] > 0  # the bound skipped candidates
    assert kn == kp
    # |q|^2 - 2 q.v + |v|^2 cancels at this corpus's norms (~300): allow
    # a few f32 ulps of 2 |q|^2 near 0
    qsq = float(np.einsum("qd,qd->q", queries, queries).max())
    np.testing.assert_allclose(dn, dp, rtol=RTOL, atol=1e-6 * 2 * qsq)
