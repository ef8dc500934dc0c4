"""tpuvdb_torch.kernels.quant and the int8 DeviceExactIndex vs the JAX
package (on the CPU).

* `quantize_rows_np`, `quantize_rows` and `quantize_batch`: codes and scales
  bit-equal to the reference's host function, quantizing scatter and
  `quantize_batch`, an all-zero row and an all-zero batch included
  (rounding is half-to-even in numpy, jax.numpy and torch alike; XLA turns
  the jitted functions' division by 127 into a reciprocal multiply, and the
  port's device functions multiply likewise).
* The flat int8 scan `l2sq_topk_int8` against `l2sq_topk_int8_xla` (whose
  approx_max_k is exact on the CPU): ids equal, distances within rtol 1e-5
  plus atol 1e-4 (||q||^2 - score cancels to a few f32 ulps of ||x||^2 for
  near neighbours); the int32 dots are exact in both, so only the order of
  the f32 score operations could differ. Rows whose distances tie exactly
  are compared in id order. `l2sq_topk_int8_rescored` and
  `exact_rescore` likewise; a `fetch` larger than the corpus clamps.
* `int8_dots` pads to the shapes CUDA's `_int_mm` takes without changing
  the product.
* `DeviceExactIndex` with int8 storage: `from_numpy` of a JAX int8 index
  returns its rows; a scatter writes the codes, scales and sqnorms that
  `_scatter_update_int8` writes; int8 mirrors upload bit-exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvdb.index import exact as jexact
from tpuvdb.index.layout import ShardMirror as JaxMirror
from tpuvdb.kernels import quant as jquant
from tpuvdb_torch.index.exact import DeviceExactIndex
from tpuvdb_torch.index.layout import ShardMirror, StackedLayout
from tpuvdb_torch.kernels import quant

DIST_RTOL, DIST_ATOL = 1e-5, 1e-4


def _rows(rng, n, d, zero_row=True):
    x = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    x[1] *= 1e-3            # a row of small values: its own scale
    x[2, 0] = 50.0          # one large entry: everything else rounds small
    if zero_row:
        x[0] = 0.0
    return x


@pytest.mark.parametrize("d", [32, 27])
def test_quantize_rows_bit_equal(rng, d):
    x = _rows(rng, 257, d)
    # half-way cases: multiples of scale / 2 round to even
    x[3] = np.arange(d, dtype=np.float32) * 0.5
    x[3, -1] = 127.0        # scale exactly 1
    jq, js = jquant.quantize_rows_np(x)
    q, s = quant.quantize_rows_np(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert (q[0] == 0).all() and s[0] == 1.0           # the all-zero row
    # the device form against the reference's quantizing scatter, whose
    # jitted absmax / 127.0 XLA compiles into a reciprocal multiply
    n = len(x)
    dq, ds, _, _ = jexact._scatter_update_int8(
        jnp.zeros((n, d), jnp.int8), jnp.ones(n), jnp.zeros(n),
        jnp.zeros(n, bool), jnp.arange(n, dtype=jnp.int32), jnp.asarray(x),
        jnp.ones(n, bool))
    tq, ts = quant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(dq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ds))
    assert (ts.numpy() != js).any()   # the two forms differ in the last bit
    np.testing.assert_allclose(ts.numpy(), js, rtol=2e-7)
    assert q[3, 1] == 0 and q[3, 3] == 2 and q[3, 5] == 2   # 0.5, 1.5, 2.5


@pytest.mark.parametrize("case", ["random", "zero_batch", "one_row"])
def test_quantize_batch_bit_equal(rng, case):
    for _ in range(1 if case == "zero_batch" else 40):  # many scales
        q = _rows(rng, 19, 24) * np.float32(rng.uniform(0.5, 2.0))
        if case == "one_row":
            q = q[3:4]
        if case == "zero_batch":
            q[:] = 0.0
        jqi, jscale = jquant.quantize_batch(jnp.asarray(q))
        qi, scale = quant.quantize_batch(torch.from_numpy(q))
        assert scale.shape == (1, 1) and qi.dtype == torch.int8
        np.testing.assert_array_equal(qi.numpy(), np.asarray(jqi))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    if case == "zero_batch":
        assert scale.item() == 1.0 and not qi.any()


@pytest.mark.parametrize("qn,d,bn", [(1, 8, 8), (3, 20, 50), (17, 100, 129),
                                     (40, 32, 256)])
def test_int8_dots_exact_at_any_shape(rng, qn, d, bn):
    a = rng.integers(-127, 128, (qn, d)).astype(np.int8)
    b = rng.integers(-127, 128, (bn, d)).astype(np.int8)
    got = quant.int8_dots(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (qn, bn)
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int32) @ b.astype(np.int32).T)


def _assert_same_topk(td, ti, jd, ji):
    """Same ids and distances, with rows of equal distance taken in id
    order on both sides: which of two exactly tied rows comes first is the
    top-k implementation's choice (XLA's and torch's differ)."""
    td, ti, jd, ji = (np.asarray(a) for a in (td, ti, jd, ji))
    for t_d, t_i, j_d, j_i in zip(td, ti, jd, ji):
        np.testing.assert_array_equal(t_i[np.lexsort((t_i, t_d))],
                                      j_i[np.lexsort((j_i, j_d))])
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_ATOL)


def _corpus(rng, n, d, n_dead=0):
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    ci8, scales = jquant.quantize_rows_np(corpus)
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    valid = np.ones(n, bool)
    if n_dead:
        valid[rng.choice(n, n_dead, replace=False)] = False
    return corpus, ci8, scales, sq, valid


def _both(fn_t, fn_j, q, ci8, scales, sq, valid, **kw):
    """(torch result, jax result) of one scan on the same arrays."""
    jd, ji = fn_j(jnp.asarray(q), jnp.asarray(ci8), jnp.asarray(scales),
                  jnp.asarray(sq), jnp.asarray(valid), **kw)
    td, ti = fn_t(torch.from_numpy(q), torch.from_numpy(ci8),
                  torch.from_numpy(scales), torch.from_numpy(sq),
                  torch.from_numpy(valid), **kw)
    return (td.numpy(), ti.numpy()), (np.asarray(jd), np.asarray(ji))


@pytest.mark.parametrize("n,d,k,block", [(2048, 32, 10, 512),
                                         (1000, 27, 10, 384),
                                         (4096, 32, 200, 65536)])
def test_int8_scan_matches_reference(rng, n, d, k, block):
    """Several blocks, a ragged last block and an unaligned d: the blocked
    running top-k returns what the reference's one-shot scan returns."""
    _, ci8, scales, sq, valid = _corpus(rng, n, d, n_dead=n // 50)
    q = rng.standard_normal((16, d)).astype(np.float32)
    jd, ji = jquant.l2sq_topk_int8_xla(
        jnp.asarray(q), jnp.asarray(ci8), jnp.asarray(scales),
        jnp.asarray(sq), jnp.asarray(valid), k=k)
    td, ti = quant.l2sq_topk_int8(
        torch.from_numpy(q), torch.from_numpy(ci8), torch.from_numpy(scales),
        torch.from_numpy(sq), torch.from_numpy(valid), k=k, block_size=block)
    _assert_same_topk(td, ti, jd, ji)
    assert not np.isin(ti.numpy(), np.flatnonzero(~valid)).any()


def test_int8_scan_pads_when_k_exceeds_the_live_rows(rng):
    _, ci8, scales, sq, valid = _corpus(rng, 64, 16)
    valid[8:] = False
    q = rng.standard_normal((3, 16)).astype(np.float32)
    td, ti = quant.l2sq_topk_int8(
        torch.from_numpy(q), torch.from_numpy(ci8), torch.from_numpy(scales),
        torch.from_numpy(sq), torch.from_numpy(valid), k=12)
    ti, td = ti.numpy(), td.numpy()
    assert (np.sort(ti[:, :8], axis=1) == np.arange(8)).all()
    assert (ti[:, 8:] == -1).all() and np.isinf(td[:, 8:]).all()
    with pytest.raises(ValueError, match="int8 rows"):
        quant.l2sq_topk_int8(torch.from_numpy(q), torch.zeros((64, 16)),
                             torch.from_numpy(scales), torch.from_numpy(sq),
                             torch.from_numpy(valid), k=3)


def test_int8_rescored_matches_reference(rng):
    """Tight near-duplicate shells, where int8 noise flips the order and
    the re-rank over dequantized rows restores it."""
    n, d, k = 4096, 32, 10
    base = rng.standard_normal((n // 2, d)).astype(np.float32) * 3
    corpus = np.concatenate(
        [base, base + 0.02 * rng.standard_normal(base.shape)
         .astype(np.float32)])
    ci8, scales = jquant.quantize_rows_np(corpus)
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    valid = np.ones(n, bool)
    q = corpus[rng.choice(n, 32)] + 0.05 * rng.standard_normal(
        (32, d)).astype(np.float32)
    (td, ti), (jd, ji) = _both(quant.l2sq_topk_int8_rescored,
                               jquant.l2sq_topk_int8_rescored, q, ci8, scales,
                               sq, valid, k=k, fetch=128)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_ATOL)
    # exact with respect to the dequantized rows, ascending
    deq = ci8.astype(np.float32) * scales[:, None]
    want = ((q[:, None, :] - deq[ti]) ** 2).sum(-1)
    np.testing.assert_allclose(td, want, rtol=1e-5, atol=1e-5)
    assert (np.diff(td, axis=1) >= 0).all()


def test_exact_rescore_matches_reference(rng):
    n, d, k, f = 512, 16, 5, 24
    _, ci8, scales, _, _ = _corpus(rng, n, d)
    q = rng.standard_normal((9, d)).astype(np.float32)
    cand = rng.integers(0, n, (9, f)).astype(np.int32)
    cand[:, -3:] = -1          # empty candidate slots
    cand[0, :f - 3] = -1       # a query with no candidate at all
    cand[1, 1] = cand[1, 0]    # a repeated candidate: an exact tie
    jd, ji = jquant.exact_rescore(jnp.asarray(q), jnp.asarray(ci8),
                                  jnp.asarray(scales), jnp.asarray(cand), k)
    td, ti = quant.exact_rescore(torch.from_numpy(q), torch.from_numpy(ci8),
                                 torch.from_numpy(scales),
                                 torch.from_numpy(cand), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL)
    assert (ti.numpy()[0] == -1).all() and np.isinf(td.numpy()[0]).all()


def test_exact_rescore_blocks_over_queries(rng, monkeypatch):
    """The (Q, F, d) gather in blocks of queries gives the one-shot
    result."""
    _, ci8, scales, _, _ = _corpus(rng, 256, 16)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    cand = rng.integers(0, 256, (7, 12)).astype(np.int32)
    args = (torch.from_numpy(q), torch.from_numpy(ci8),
            torch.from_numpy(scales), torch.from_numpy(cand), 4)
    want = quant.exact_rescore(*args)
    monkeypatch.setattr(quant, "_RESCORE_GATHER_BYTES", 2 * 12 * 16 * 4)
    got = quant.exact_rescore(*args)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def test_int8_rescored_fetch_clamps_to_corpus(rng):
    n, d, k = 32, 16, 5
    corpus, ci8, scales, sq, valid = _corpus(rng, n, d)
    valid[n // 2:] = False
    (td, ti), (jd, ji) = _both(quant.l2sq_topk_int8_rescored,
                               jquant.l2sq_topk_int8_rescored, corpus[:3],
                               ci8, scales, sq, valid, k=k, fetch=128)
    assert (ti < n // 2).all()                 # dead rows never surface
    assert (ti[:, 0] == np.arange(3)).all()    # self is nearest
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_ATOL)


# ------------------------------------------------------- DeviceExactIndex


def _fill_mirrors(rng, cls, dtype="float32", n=100, dim=32):
    mirrors = [cls(dim=dim, capacity=2048, init_cap=256, block=128,
                   dtype=dtype) for _ in range(2)]
    data = rng.standard_normal((2, n, dim)).astype(np.float32)
    for s, m in enumerate(mirrors):
        first = m.alloc(n)
        m.write_batch(first, data[s])
    mirrors[1].mark_deleted(7)
    return mirrors, data


def test_int8_index_from_numpy_returns_the_jax_rows(rng):
    seed = int(rng.integers(1 << 30))
    jm, data = _fill_mirrors(np.random.default_rng(seed), JaxMirror)
    j = jexact.DeviceExactIndex.build(jm, dtype=jnp.int8, block_size=128)
    lay = StackedLayout(j.layout.num_shards, j.layout.phys_cap, j.layout.dim)
    t = DeviceExactIndex.from_numpy(
        lay, np.asarray(j.vectors), np.asarray(j.sqnorms),
        np.asarray(j.valid), row_scales=np.asarray(j.row_scales),
        block_size=128, device="cpu")
    assert t.quantized and t.vectors.dtype == torch.int8
    q = np.concatenate([data[1, 50:53], data[0, :5]
                        + 0.1 * rng.standard_normal((5, 32))
                        .astype(np.float32)])
    for fetch in (0, 32):
        j.rescore_fetch = t.rescore_fetch = fetch
        jd, jr = j.search(q, 10)
        td, tr = t.search(q, 10)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_ATOL)
    assert lay.shard_slot_of(int(tr[0, 0])) == (1, 50)
    assert t.nbytes() == j.nbytes() + 4 * lay.total_rows  # + the scales
    # the port builds the same index from the same rows
    tm, _ = _fill_mirrors(np.random.default_rng(seed), ShardMirror)
    b = DeviceExactIndex.build(tm, dtype=torch.int8, block_size=128,
                               device="cpu")
    np.testing.assert_array_equal(b.vectors.numpy(), np.asarray(j.vectors))
    np.testing.assert_array_equal(b.row_scales.numpy(),
                                  np.asarray(j.row_scales))
    np.testing.assert_array_equal(b.sqnorms.numpy(), np.asarray(j.sqnorms))
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(j.valid))
    with pytest.raises(ValueError, match="row_scales"):
        DeviceExactIndex.from_numpy(lay, np.asarray(j.vectors),
                                    np.asarray(j.sqnorms),
                                    np.asarray(j.valid), device="cpu")


def test_int8_scatter_writes_what_the_reference_writes(rng):
    seed = int(rng.integers(1 << 30))
    jm, _ = _fill_mirrors(np.random.default_rng(seed), JaxMirror)
    tm, _ = _fill_mirrors(np.random.default_rng(seed), ShardMirror)
    j = jexact.DeviceExactIndex.build(jm, dtype=jnp.int8, block_size=128)
    t = DeviceExactIndex.build(tm, dtype=torch.int8, block_size=128,
                               device="cpu")
    rows = np.array([3, 130, 300, t.layout.total_rows + 5], np.int32)
    vecs = _rows(rng, 4, 32)             # an all-zero row among them
    ok = np.array([True, True, False, True])
    version = t.version
    j.apply_updates(rows, vecs, ok)
    t.apply_updates(rows, vecs, ok)      # the out-of-range row is dropped
    assert t.version == version + 1
    np.testing.assert_array_equal(t.vectors.numpy(), np.asarray(j.vectors))
    np.testing.assert_array_equal(t.row_scales.numpy(),
                                  np.asarray(j.row_scales))
    # the norms are f32 sums of d squares, taken in another order
    np.testing.assert_allclose(t.sqnorms.numpy(), np.asarray(j.sqnorms),
                               rtol=1e-6)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    t.apply_deletes(np.array([130]))
    assert not t.valid[130]
    _, found = t.search(vecs[1:2], 3)
    assert 130 not in found


def test_int8_mirrors_upload_bit_exactly(rng):
    seed = int(rng.integers(1 << 30))
    tm, data = _fill_mirrors(np.random.default_rng(seed), ShardMirror,
                             dtype="int8")
    jm, _ = _fill_mirrors(np.random.default_rng(seed), JaxMirror,
                          dtype="int8")
    t = DeviceExactIndex.build(tm, dtype=torch.int8, block_size=128,
                               device="cpu")
    j = jexact.DeviceExactIndex.build(jm, dtype=jnp.int8, block_size=128)
    n = tm[0].next_slot
    codes, scales, sq = tm[0].rows_raw(np.arange(n))
    np.testing.assert_array_equal(t.vectors[:n].numpy(), codes)
    np.testing.assert_array_equal(t.row_scales[:n].numpy(), scales)
    np.testing.assert_array_equal(t.sqnorms[:n].numpy(), sq)
    np.testing.assert_array_equal(t.vectors.numpy(), np.asarray(j.vectors))
    np.testing.assert_array_equal(t.row_scales.numpy(),
                                  np.asarray(j.row_scales))
    np.testing.assert_array_equal(t.sqnorms.numpy(), np.asarray(j.sqnorms))
    # int8 mirrors into an f32 index: dequantized rows
    f = DeviceExactIndex.build(tm, dtype=torch.float32, block_size=128,
                               device="cpu")
    np.testing.assert_allclose(f.vectors[:n].numpy(), data[0], atol=0.1)
    _, rows = t.search(data[1, 50:51], 1)
    assert t.layout.shard_slot_of(int(rows[0, 0])) == (1, 50)
