"""The port's int8 IVF probe vs tpuvdb.kernels.pallas_ivf (on the CPU).

* The plain twins of the two int8 CUDA kernels (`ivf_candidates_int8_plain`,
  `ivf_candidates_packed_int8_plain`, reached through the wrappers on CPU
  tensors) are held against `pallas_ivf_candidates_int8` and
  `pallas_ivf_candidates_packed_int8` in interpret mode on the same chunk
  lists, segments, offsets and scales: candidate ids identical, scores
  within rtol 1e-4 plus atol 1e-5 (the int32 dots are exact in both and the
  batch goes to both whole, so it is quantized with the same scale; only
  the fusing of the four f32 score operations may differ). The inputs hold
  exact ties: chunks that are copies of chunk 0 (codes, scales and norms)
  land in chunk 0's slots, and the lowest row must win in both, also where
  the lower copy is dead. One case has a width off the kernels' 16-byte
  loads (d = 27); padding rows (code 0, scale 1.0, dead) score nothing.
* `ivf_probe_search` on int8 cells is held against
  `pallas_ivf_search(interpret=True)` in both forms at k=10 and k=200, with
  int8 spill rows and deleted rows: ids identical, distances within rtol
  1e-5 plus atol 1e-4.
* `IVFIndex` on int8 cells: `from_numpy` of a JAX int8 index searches the
  reference's probe rows; given the same centroids, a port build packs the
  same codes, scales and norms; appends quantize and land as the
  reference's do.
* What the s8 tensor-core kernel adds on the host: the padded query
  operand (`int8_query_operand`) leaves every dot as it was, and the
  int32 sums stay exact up to `INT8_MAX_DIM` columns, past which the
  wrappers raise.

The CUDA kernels cannot run here; `test_int8_kernel_matches_plain_on_card`
holds them against the plain twins, bit for bit, when a card is present:

    python -m pytest --noconftest -q -m cuda tests/test_torch_ivf_probe_int8.py
"""

import types

import numpy as np
import pytest
import torch

from tpuvdb_torch.kernels import ivf_probe
from tpuvdb_torch.kernels.quant import (int8_dots, quantize_batch,
                                         quantize_rows_np)

NEG_INF = ivf_probe.NEG_INF
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-5


@pytest.fixture()
def ref():
    """The JAX reference: jax.numpy and tpuvdb.kernels.pallas_ivf."""
    import jax.numpy as jnp

    from tpuvdb.index.ivf import IVFIndex
    from tpuvdb.kernels import pallas_ivf

    return types.SimpleNamespace(jnp=jnp, ivf=pallas_ivf, IVFIndex=IVFIndex)


def _cells_inputs(rng, n_chunks=24, d=24, n_dead=40):
    """int8 cells whose chunks 8 and 16 are copies of chunk 0 (exact ties
    in one slot under both forms' segment rules), one dead copy below a
    live one, ~n_dead other dead rows, and a chunk of padding rows (code 0,
    scale 1.0, dead)."""
    n = n_chunks * 128
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows[20 * 128:21 * 128] = 0.0
    for c in (8, 16):
        rows[c * 128:(c + 1) * 128] = rows[:128]
    codes, scales = quantize_rows_np(rows)
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    mask = np.zeros(n, np.float32)
    mask[rng.choice(np.arange(128, n), n_dead, replace=False)] = NEG_INF
    mask[20 * 128:21 * 128] = NEG_INF
    assert (scales[20 * 128:21 * 128] == 1.0).all()
    mask[5] = NEG_INF            # chunk 0 row 5 dead: chunk 8's copy wins
    mask[8 * 128 + 5] = 0.0
    return rows, codes, scales, sq, mask


def _queries(rng, rows, n):
    q = rng.standard_normal((n, rows.shape[1])).astype(np.float32)
    q[0] = rows[3]  # its best rows tie across the copies of chunk 0
    q[1] = rows[5]  # ... where the lowest copy is dead
    return q


def _to(a, dtype=None):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t if dtype is None else t.to(dtype)


def _check_ties(ids, mask):
    """Chunks 8 and 16 copy chunk 0 and share its slots: the lowest live
    copy wins; no dead or padding row comes back."""
    assert (ids[0] == 3).any()
    assert not np.isin(ids, [8 * 128 + 3, 16 * 128 + 3]).any()
    assert not (ids == 5).any() and (ids[1] == 8 * 128 + 5).any()
    assert not (ids == 16 * 128 + 5).any()
    assert not np.isin(ids, np.flatnonzero(mask < 0)).any()


@pytest.mark.parametrize("d", [24, 27])
def test_expanded_int8_plain_matches_pallas(rng, ref, d):
    jnp = ref.jnp
    n_chunks, qt, tiles, n_seg = 24, 4, 2, 4
    rows, codes, scales, sq, mask = _cells_inputs(rng, n_chunks, d)
    cells = []
    for _ in range(tiles):
        extra = rng.integers(0, n_chunks, 32 - n_chunks)
        cells.append(np.sort(np.concatenate([np.arange(n_chunks), extra])))
    cells = np.asarray(cells, np.int32)
    distinct = np.ones_like(cells, bool)
    distinct[:, 1:] = cells[:, 1:] != cells[:, :-1]
    segs = ((np.cumsum(distinct, axis=1) - 1) % n_seg).astype(np.int32)
    q = _queries(rng, rows, tiles * qt)
    val, idx = ivf_probe.ivf_candidates_int8(
        _to(q), _to(cells), _to(segs), _to(codes), _to(scales), _to(sq),
        _to(mask), n_segments=n_seg, query_tile=qt)
    jval, jidx = ref.ivf.pallas_ivf_candidates_int8(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(segs),
        jnp.asarray(codes), jnp.asarray(scales)[None], jnp.asarray(sq)[None],
        jnp.asarray(mask)[None], cell_pad=128, n_buckets=128,
        query_tile=qt, n_segments=n_seg, cps=1, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    _check_ties(idx.numpy(), mask)


@pytest.mark.parametrize("d", [24, 27])
def test_compact_int8_plain_matches_pallas(rng, ref, d):
    jnp = ref.jnp
    n_chunks, qt, tiles, n_seg, w128 = 24, 4, 2, 8, 3
    rows, codes, scales, sq, mask = _cells_inputs(rng, n_chunks, d)
    # 12 cells, one every 2 chunks: windows of 3 chunks over-scan into the
    # next cell (a chunk reached from two cells) and clamp at the last one
    nlist = 12
    off128 = np.arange(0, 2 * nlist, 2, dtype=np.int32)
    cells = np.sort(np.concatenate(
        [np.tile(np.arange(nlist), (tiles, 1)),
         rng.integers(0, nlist, (tiles, 4))], axis=1), axis=1)
    cells = cells.astype(np.int32)
    q = _queries(rng, rows, tiles * qt)
    val, idx = ivf_probe.ivf_candidates_packed_int8(
        _to(q), _to(cells), _to(off128), _to(codes), _to(scales), _to(sq),
        _to(mask), w128=w128, n_segments=n_seg, query_tile=qt)
    jval, jidx = ref.ivf.pallas_ivf_candidates_packed_int8(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(off128),
        jnp.asarray(codes), jnp.asarray(scales)[None], jnp.asarray(sq)[None],
        jnp.asarray(mask)[None], w128=w128, n_buckets=128, query_tile=qt,
        n_segments=n_seg, cps=1, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    _check_ties(idx.numpy(), mask)


def test_the_query_scale_covers_the_whole_batch(rng):
    """One scale for the batch: a large query coarsens the others' codes,
    so a batch and its first tile alone score differently; zero rows of
    padding change nothing."""
    rows, codes, scales, sq, mask = _cells_inputs(rng)
    cells = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    segs = cells % 4
    q = _queries(rng, rows, 8)
    q[7] *= 20.0
    args = (_to(codes), _to(scales), _to(sq), _to(mask), 4, 4)
    whole, _ = ivf_probe.ivf_candidates_int8(_to(q), _to(cells), _to(segs),
                                             *args)
    first, _ = ivf_probe.ivf_candidates_int8(_to(q[:4]), _to(cells[:1]),
                                             _to(segs[:1]), *args)
    assert not torch.equal(whole[:4], first)
    q0 = q.copy()
    q0[4:] = 0.0
    padded, _ = ivf_probe.ivf_candidates_int8(_to(q0), _to(cells), _to(segs),
                                              *args)
    torch.testing.assert_close(padded[:4], first, rtol=0, atol=0)


def _clustered_index(ref, rng, n_clusters=8, per=160, d=16, **build):
    centers = rng.standard_normal((n_clusters, d)) * 2
    data = np.concatenate([
        centers[i] + 0.3 * rng.standard_normal((per, d))
        for i in range(n_clusters)]).astype(np.float32)
    valid = np.ones(len(data), bool)
    idx = ref.IVFIndex.build(data, valid, nlist=n_clusters,
                             nprobe=n_clusters, kmeans_iters=6,
                             dtype=ref.jnp.int8, **build)
    return data, idx


@pytest.mark.parametrize("force_compact", [False, True])
@pytest.mark.parametrize("k", [10, 200])
def test_int8_probe_search_matches_pallas_ivf_search(rng, ref, force_compact,
                                                     k):
    jnp = ref.jnp
    # no bisection and a median cap: the larger cells spill
    data, j = _clustered_index(ref, rng, split_oversized=False,
                               cell_cap_quantile=0.5)
    assert j.quantized and j.stats().spill_rows > 0
    j.invalidate_rows(np.arange(0, len(data), 13))
    q = data[rng.choice(len(data), 10, replace=False)] + 0.05 * \
        rng.standard_normal((10, data.shape[1])).astype(np.float32)
    in_spill = j.spill_row_ids[np.asarray(j.spill_valid)]
    q[:2] = data[in_spill[:2]]       # two queries whose nearest row spilt
    args = dict(cell_pad=j.cell_pad, k=k, nprobe=3, query_tile=8,
                force_compact=force_compact)
    jd, jg = ref.ivf.pallas_ivf_search(
        jnp.asarray(q), j.centroids, j.grouped, j.grouped_sq,
        j.grouped_valid, interpret=True, cell_offsets=j.cell_offsets,
        spill=j.spill, spill_sq=j.spill_sq, spill_valid=j.spill_valid,
        cell_scales=j.cell_scales, spill_scales=j.spill_scales, **args)
    td, tg = ivf_probe.ivf_probe_search(
        _to(q), _to(np.asarray(j.centroids)), _to(np.asarray(j.grouped)),
        _to(np.asarray(j.grouped_sq)), _to(np.asarray(j.grouped_valid)),
        _to(np.asarray(j.cell_offsets)), spill=_to(np.asarray(j.spill)),
        spill_sq=_to(np.asarray(j.spill_sq)),
        spill_valid=_to(np.asarray(j.spill_valid)),
        cell_scales=_to(np.asarray(j.cell_scales)),
        spill_scales=_to(np.asarray(j.spill_scales)), **args)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    ids = tg.numpy()
    n_g = j.grouped.shape[0]
    assert (ids >= n_g).any()                       # spill rows served
    dead = np.flatnonzero(~np.asarray(j.grouped_valid))
    assert not np.isin(ids, dead).any()
    live = ids[0][ids[0] >= 0]
    assert len(set(live.tolist())) == len(live)     # no duplicates


def _port_of(j, nprobe=None):
    from tpuvdb_torch.index.ivf import IVFIndex

    return IVFIndex.from_numpy(
        centroids=j.centroids_np(), grouped=np.asarray(j.grouped),
        grouped_sq=np.asarray(j.grouped_sq),
        grouped_valid=np.asarray(j.grouped_valid), row_ids=j.row_ids,
        spill=np.asarray(j.spill), spill_sq=np.asarray(j.spill_sq),
        spill_valid=np.asarray(j.spill_valid), spill_row_ids=j.spill_row_ids,
        cell_offsets=np.asarray(j.cell_offsets),
        cell_lens=np.asarray(j.cell_lens), cell_pad=j.cell_pad,
        nprobe=nprobe or j.nprobe, dtype=torch.int8, device="cpu",
        cell_scales=np.asarray(j.cell_scales),
        spill_scales=np.asarray(j.spill_scales))


def _reference_rows(ref, j, q, k, nprobe, force_compact=False):
    dist, gid = ref.ivf.pallas_ivf_search(
        ref.jnp.asarray(q), j.centroids, j.grouped, j.grouped_sq,
        j.grouped_valid, cell_pad=j.cell_pad, k=k, nprobe=nprobe,
        query_tile=8, interpret=True, spill=j.spill, spill_sq=j.spill_sq,
        spill_valid=j.spill_valid, cell_offsets=j.cell_offsets,
        cell_scales=j.cell_scales, spill_scales=j.spill_scales,
        force_compact=force_compact)
    gid = np.asarray(gid)
    n_g = j.grouped.shape[0]
    rows = np.full(gid.shape, -1, np.int64)
    g, s = (gid >= 0) & (gid < n_g), gid >= n_g
    rows[g] = j.row_ids[gid[g]]
    rows[s] = j.spill_row_ids[gid[s] - n_g]
    return np.asarray(dist), rows


@pytest.mark.parametrize("force_compact", [False, True])
def test_int8_index_from_numpy_searches_the_reference_rows(rng, ref,
                                                           force_compact):
    data, j = _clustered_index(ref, rng, split_oversized=False,
                               cell_cap_quantile=0.5)
    j.invalidate_rows(np.arange(0, len(data), 17))
    port = _port_of(j, nprobe=3)
    assert port.quantized and port.nbytes() > 0
    q = data[:11] + 0.05 * rng.standard_normal((11, 16)).astype(np.float32)
    want_d, want_r = _reference_rows(ref, j, q, 10, 3, force_compact)
    got_d, got_r = port.search(q, 10, force_compact=force_compact)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
    assert not np.isin(got_r, np.arange(0, len(data), 17)).any()
    with pytest.raises(ValueError, match="scale"):
        type(port).from_numpy(
            j.centroids_np(), np.asarray(j.grouped), np.asarray(j.grouped_sq),
            np.asarray(j.grouped_valid), j.row_ids, np.asarray(j.spill),
            np.asarray(j.spill_sq), np.asarray(j.spill_valid),
            j.spill_row_ids, np.asarray(j.cell_offsets),
            np.asarray(j.cell_lens), j.cell_pad, 3, dtype=torch.int8,
            device="cpu")


def test_int8_build_and_appends_match_the_reference(rng, ref):
    from tpuvdb_torch.index.ivf import IVFIndex

    data, trained = _clustered_index(ref, rng, n_clusters=6, per=300)
    cents = trained.centroids_np()[:6]
    valid = np.ones(len(data), bool)
    valid[::9] = False
    n0 = 1500
    kw = dict(nlist=6, nprobe=6, centroids=cents)
    j = ref.IVFIndex.build(data[:n0], valid[:n0], dtype=ref.jnp.int8, **kw)
    port = IVFIndex.build(data[:n0], valid[:n0], dtype=torch.int8,
                          device="cpu", **kw)

    def same():
        np.testing.assert_array_equal(port.row_ids, j.row_ids)
        np.testing.assert_array_equal(port.spill_row_ids, j.spill_row_ids)
        for a, b in ((port.grouped, j.grouped), (port.spill, j.spill),
                     (port.cell_scales, j.cell_scales),
                     (port.spill_scales, j.spill_scales),
                     (port.grouped_sq, j.grouped_sq),
                     (port.spill_sq, j.spill_sq),
                     (port.grouped_valid, j.grouped_valid),
                     (port.spill_valid, j.spill_valid)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    assert port.cell_pad == j.cell_pad and port.nlist == j.nlist
    same()
    rows = np.arange(n0, len(data), dtype=np.int64)
    new = data[n0:] + 0.01
    version = port.version
    assert j.append_rows(rows, new) and port.append_rows(rows, new)
    assert port.version == version + 1
    same()
    q = new[:9]
    want_d, want_r = _reference_rows(ref, j, q, 5, 6)
    got_d, got_r = port.search(q, 5)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
    assert (got_r[:, 0] == rows[:9]).all()


def test_int8_wrappers_reject_what_the_kernels_do_not_take():
    z = torch.zeros(128)
    cells = torch.zeros((1, 1), dtype=torch.int32)
    q = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="int8 cells"):
        ivf_probe.ivf_candidates_int8(q, cells, cells, torch.zeros((128, 4)),
                                      z, z, z, 4, 8)
    x = torch.zeros((128, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="one row per tile"):
        ivf_probe.ivf_candidates_packed_int8(torch.zeros((16, 4)), cells,
                                             cells[0], x, z, z, z, 1, 4, 8)
    meta = torch.zeros((128, 4), dtype=torch.int8, device="meta")
    zm = torch.zeros(128, device="meta")
    cm = cells.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ivf_probe.ivf_candidates_int8(q.to("meta"), cm, cm, meta, zm, zm, zm,
                                      4, 8)
    # int8 cells without their scales
    plan = ivf_probe.probe_plan(q, torch.zeros((1, 4)),
                                torch.zeros(1, dtype=torch.int32), 128, 10, 1)
    with pytest.raises(ValueError, match="cell_scales"):
        ivf_probe.plan_candidates(plan, x, z, z)
    # and the f32/bf16 wrappers go on refusing int8 rows
    with pytest.raises(NotImplementedError, match="quant"):
        ivf_probe.ivf_candidates(q, cells, cells, x, z, z, 4, 8)


@pytest.mark.parametrize("d", [27, 100, 128])
def test_the_padded_query_operand_leaves_every_dot_unchanged(rng, d):
    """The int8 kernel reads its queries by TMA, rows padded with zeros to
    a multiple of 16 bytes (int8_query_operand). The pad is zeros and the
    codes are quantize_batch's, so every dot with a row is the unpadded
    one, whatever the row holds past d (the kernel's copy of a ragged row
    zero-fills it; TMA's out-of-range reads give zeros as well)."""
    q = torch.from_numpy(rng.standard_normal((11, d)).astype(np.float32))
    q8, qscale, d_pad = ivf_probe.int8_query_operand(q)
    qi, want_scale = quantize_batch(q)
    assert d_pad % 16 == 0 and d <= d_pad < d + 16
    assert q8.shape == (11, d_pad) and q8.dtype == torch.int8
    assert q8.is_contiguous() and torch.equal(qscale, want_scale)
    assert torch.equal(q8[:, :d], qi) and not q8[:, d:].any()
    rows = torch.from_numpy(rng.integers(-127, 128, (300, d_pad),
                                         dtype=np.int8))
    want = qi.long() @ rows[:, :d].long().T
    got = q8.long() @ rows.long().T   # junk past d in the rows: no matter
    assert torch.equal(got, want)
    assert torch.equal(int8_dots(q8, rows).long(), want)


def test_int8_dots_stay_exact_at_the_widest_row():
    """|q|, |x| <= 127, so a dot of INT8_MAX_DIM columns fits int32 at its
    largest (and smallest), running sums included, one column more may
    not; the wrappers raise for such rows, on either device."""
    wide = ivf_probe.INT8_MAX_DIM
    for sign in (1, -1):
        terms = np.full(wide, sign * 127 * 127, np.int64)
        run64 = np.cumsum(terms)
        run32 = np.cumsum(terms.astype(np.int32), dtype=np.int32)
        assert np.array_equal(run32.astype(np.int64), run64)
        assert abs(int(run64[-1])) <= 2 ** 31 - 1
        assert abs(int(run64[-1]) + sign * 127 * 127) > 2 ** 31 - 1
    x = torch.zeros((128, wide + 1), dtype=torch.int8)
    z = torch.zeros(128)
    cells = torch.zeros((1, 1), dtype=torch.int32)
    q = torch.zeros((8, wide + 1))
    with pytest.raises(ValueError, match="overflow int32"):
        ivf_probe.ivf_candidates_int8(q, cells, cells, x, z, z, z, 4, 8)
    with pytest.raises(ValueError, match="overflow int32"):
        ivf_probe.ivf_candidates_packed_int8(q, cells, cells[0], x, z, z, z,
                                             1, 4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("d", [128, 100])
@pytest.mark.parametrize("k", [10, 2560])
@pytest.mark.parametrize("nq", [1, 8, 32, 37, 256])
def test_int8_kernel_matches_plain_on_card(compact, d, k, nq):
    """Kernel and twin agree bit for bit: exact int32 dots on wgmma s8, and
    the four f32 score operations each rounded once in both. nq = 1 and 8
    walk one tile's list (the width-8 product), 32, 37 and 256 a group
    table (widths 32, 64 and 128). d = 100 is off TMA's 16-byte rows and
    takes the producer's element-wise copy; k = 2,560 the widest candidate
    buffer (40 segments expanded, 80 compact, as a rescore window of 256 *
    k asks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the IVF probe kernels have no CPU "
                    "mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    nlist, cell_pad = 64, 256
    n_g = nlist * cell_pad + cell_pad
    rows = torch.randn((n_g, d), generator=gen, device="cuda")
    valid = torch.rand(n_g, generator=gen, device="cuda") >= 0.01
    valid[-cell_pad:] = False
    rows[-cell_pad:] = 0.0              # padding rows: code 0, scale 1.0
    scales = rows.abs().amax(dim=1) / 127.0
    scales = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.clamp(torch.round(rows / scales[:, None]), -127,
                        127).to(torch.int8)
    sq = rows.pow(2).sum(dim=1)
    cents = torch.randn((nlist, d), generator=gen, device="cuda")
    offs = torch.arange(nlist, dtype=torch.int32, device="cuda") * cell_pad
    q = torch.randn((nq, d), generator=gen, device="cuda")
    mask = torch.zeros(n_g, device="cuda").masked_fill_(~valid, NEG_INF)
    plan = ivf_probe.probe_plan(q, cents, offs, cell_pad, k=k, nprobe=8,
                                force_compact=compact)
    assert plan.n_segments == (1 if k == 10 else 10) * (8 if compact else 4)
    name = "LAUNCHES_COMPACT_INT8" if compact else "LAUNCHES_EXPANDED_INT8"
    launches = getattr(ivf_probe, name)
    val, idx = ivf_probe.plan_candidates(plan, codes, sq, mask,
                                         cell_scales=scales)
    assert getattr(ivf_probe, name) == launches + 1
    pval, pidx = ivf_probe.plan_candidates(plan, codes, sq, mask, plain=True,
                                           cell_scales=scales)
    torch.cuda.synchronize()
    assert (idx >= 0).any() and not (idx >= n_g - cell_pad).any()
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
    torch.testing.assert_close(val, pval, rtol=0, atol=0)
