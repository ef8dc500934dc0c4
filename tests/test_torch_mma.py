"""What the tensor-core kernels (csrc/hopper_mma.cuh, scan.cu, ivf_probe.cu)
rest on, held on the CPU.

* The group table of the IVF probe (`ivf_probe.group_table`): its plain
  consumer `ivf_candidates_grouped_plain` returns exactly what the per-tile
  twins `ivf_candidates_plain` / `ivf_candidates_packed_plain` return, ids
  and scores, in f32 and bf16, with chunks that some tiles of a group list
  and others do not, entries out of range, and a last group of fewer tiles
  (Q not a multiple of the group's queries). The per-tile twins are held
  against `pallas_ivf_candidates(interpret=True)` by
  tests/test_torch_ivf_probe.py, so the table is held to the reference
  through them.
* The same table on int8 cells (the int8 kernel on wgmma s8 walks it
  too): its consumer with `cell_scales` equals the int8
  twins `ivf_candidates_int8_plain` / `ivf_candidates_packed_int8_plain`
  bit for bit, in both forms, at d = 24 and 27 (off 16 bytes), at several
  group sizes, and `pallas_ivf_candidates_int8` /
  `pallas_ivf_candidates_packed_int8(interpret=True)` with the same ids and
  scores within 1e-4 relative + 1e-5.
* 3xTF32: a numpy emulation of the split the f32 kernels use (hi =
  tf32(x), lo = tf32(x - hi), round to nearest, ties away; the sum lo*hi +
  hi*lo + hi*hi, lo*lo dropped) holds the scan's score tolerance (rtol 1e-5
  + atol 1e-3) and the probe's (1e-5 of 2|q||x|max + |x|max^2) against the
  full-f32 product at d = 512 on the shapes chip_smoke.py scores, with the
  f32 sums taken in the worst order the card could take (one long running
  sum), before any card runs the kernels.
"""

import numpy as np
import pytest
import torch

from tpuvdb_torch.kernels import ivf_probe
from tpuvdb_torch.kernels.distance import mma_queries, mma_width
from tpuvdb_torch.kernels.quant import quantize_rows_np

NEG_INF = ivf_probe.NEG_INF
# int8 scores against the reference's: the int32 dots are exact in both and
# the batch goes to both whole (one query scale); XLA may fuse the four f32
# score operations where the port rounds each once (as
# tests/test_torch_ivf_probe_int8.py holds them)
INT8_RTOL, INT8_ATOL = 1e-4, 1e-5


# ------------------------------------------------------------ group table


def _grouped(rng, n_chunks, d, dtype):
    n = n_chunks * 128
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[8 * 128:9 * 128] = g[:128]          # exact ties across chunks
    mask = np.zeros(n, np.float32)
    mask[rng.choice(n, n // 50, replace=False)] = NEG_INF
    grouped = torch.from_numpy(g).to(dtype)
    sq = grouped.float().pow(2).sum(dim=1)
    return grouped, sq, torch.from_numpy(mask)


def _expanded(rng, tiles, n_chunks, width, n_seg):
    """Per tile a sorted list of random chunks (so tiles of a group share
    some and not others), segments by rank, and some entries out of range:
    a chunk id past the array, a negative one, a segment past n_seg."""
    cells, segs = [], []
    for _ in range(tiles):
        c = np.sort(rng.choice(n_chunks + 2, width, replace=True)) - 1
        distinct = np.ones(width, bool)
        distinct[1:] = c[1:] != c[:-1]
        s = (np.cumsum(distinct) - 1) % n_seg
        if rng.random() < 0.5:
            s[rng.integers(width)] = n_seg
        cells.append(c)
        segs.append(s)
    return (torch.tensor(np.asarray(cells), dtype=torch.int32),
            torch.tensor(np.asarray(segs), dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,qt", [(37, 8), (64, 8), (200, 8), (21, 3)])
def test_group_table_equals_per_tile_twin_expanded(rng, dtype, nq, qt):
    n_chunks, d, n_seg = 40, 24, 4
    grouped, sq, mask = _grouped(rng, n_chunks, d, dtype)
    q_pad = -(-nq // qt) * qt
    q = torch.from_numpy(rng.standard_normal((q_pad, d)).astype(np.float32))
    tiles = q_pad // qt
    cells, segs = _expanded(rng, tiles, n_chunks, 30, n_seg)
    group = ivf_probe.group_size(tiles, qt)
    assert group * qt <= ivf_probe.MMA_COLS
    table = ivf_probe.group_table(*ivf_probe.list_entries(
        cells, segs, n_chunks=n_chunks, n_segments=n_seg), n_chunks, group)
    got = ivf_probe.ivf_candidates_grouped_plain(q, table, grouped, sq, mask,
                                                 n_seg, qt)
    want = ivf_probe.ivf_candidates_plain(q, cells, segs, grouped, sq, mask,
                                          n_seg, qt)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert (want[1] >= 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [37, 200])
def test_group_table_equals_per_tile_twin_compact(rng, dtype, nq):
    n_chunks, d, n_seg, qt, w128, nlist = 40, 24, 8, 8, 2, 20
    grouped, sq, mask = _grouped(rng, n_chunks, d, dtype)
    q_pad = -(-nq // qt) * qt
    q = torch.from_numpy(rng.standard_normal((q_pad, d)).astype(np.float32))
    tiles = q_pad // qt
    off128 = torch.arange(nlist, dtype=torch.int32) * w128
    # sorted cells per tile, repeats (cells shared by the tile's queries)
    # and ids out of range (nlist, -1) included
    cells = torch.tensor(np.sort(rng.integers(-1, nlist + 1, (tiles, 12)),
                                 axis=1), dtype=torch.int32)
    group = ivf_probe.group_size(tiles, qt)
    table = ivf_probe.group_table(*ivf_probe.list_entries(
        cells, off128=off128, w128=w128, n_chunks=n_chunks,
        n_segments=n_seg), n_chunks, group)
    got = ivf_probe.ivf_candidates_grouped_plain(q, table, grouped, sq, mask,
                                                 n_seg, qt)
    want = ivf_probe.ivf_candidates_packed_plain(q, cells, off128, grouped,
                                                 sq, mask, w128, n_seg, qt)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


def test_group_table_layout():
    """One row per chunk id and group, the group's tiles as columns: a
    tile's segment where its list names the chunk, -1 elsewhere; repeated
    entries and ids out of range leave nothing."""
    cells = torch.tensor([[0, 0, 3, 5], [3, 4, 9, 9], [1, 2, 2, 2]],
                         dtype=torch.int32)
    segs = torch.tensor([[0, 0, 1, 2], [0, 1, 2, 2], [3, 0, 0, 0]],
                        dtype=torch.int32)
    table = ivf_probe.group_table(*ivf_probe.list_entries(
        cells, segs, n_chunks=6, n_segments=4), 6, 2)
    assert table.shape == (2, 7, 2)
    assert table[0, :6].tolist() == [[0, -1], [-1, -1], [-1, -1],
                                          [1, 0], [-1, 1], [2, -1]]
    assert table[1, :6].tolist() == [[-1, -1], [3, -1], [0, -1],
                                          [-1, -1], [-1, -1], [-1, -1]]


def test_group_size_and_widths():
    assert ivf_probe.group_size(1, 8) == 1        # one tile walks its list
    assert ivf_probe.group_size(5, 8) == 5
    assert ivf_probe.group_size(32, 8) == 16      # 128 queries a group
    assert ivf_probe.group_size(40, 3) == 40 and ivf_probe.group_size(50, 3) == 42
    assert [mma_width(c) for c in (1, 8, 9, 33, 64, 65, 300)] == [
        8, 8, 32, 64, 64, 128, 128]


# --------------------------------------------------- group table, int8


@pytest.fixture()
def ref_ivf():
    """The JAX reference's probe functions, tpuvdb.kernels.pallas_ivf."""
    import jax.numpy as jnp

    from tpuvdb.kernels import pallas_ivf

    return jnp, pallas_ivf


def _grouped_int8(rng, n_chunks, d):
    """int8 cells quantized per row as the index quantizes them, chunk 8 a
    copy of chunk 0 (exact ties), 2% dead rows."""
    n = n_chunks * 128
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows[8 * 128:9 * 128] = rows[:128]
    codes, scales = quantize_rows_np(rows)
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    mask = np.zeros(n, np.float32)
    mask[rng.choice(n, n // 50, replace=False)] = NEG_INF
    return codes, scales, sq, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("d", [24, 27])
@pytest.mark.parametrize("nq,qt", [(37, 8), (64, 8), (21, 3)])
def test_group_table_equals_per_tile_twin_expanded_int8(rng, ref_ivf, d, nq,
                                                        qt):
    """The int8 kernel's group table (the tiles of a group sharing chunks,
    as the f32 / bf16 ones do) folds exactly what the per-tile int8 twin
    folds, ids and scores bit for bit, and what
    pallas_ivf_candidates_int8 folds: the same ids, scores within
    INT8_RTOL / INT8_ATOL."""
    jnp, pallas_ivf = ref_ivf
    n_chunks, n_seg = 24, 4
    codes, scales, sq, mask = _grouped_int8(rng, n_chunks, d)
    q_pad = -(-nq // qt) * qt
    q = rng.standard_normal((q_pad, d)).astype(np.float32)
    tiles = q_pad // qt
    # per tile a sorted list of chunks in range, some shared, with repeats
    cells = np.sort(rng.integers(0, n_chunks, (tiles, 20)), axis=1)
    distinct = np.ones_like(cells, bool)
    distinct[:, 1:] = cells[:, 1:] != cells[:, :-1]
    segs = (np.cumsum(distinct, axis=1) - 1) % n_seg
    cells, segs = cells.astype(np.int32), segs.astype(np.int32)
    tq, tcells, tsegs, tcodes, tscales, tsq, tmask = _t(
        q, cells, segs, codes, scales, sq, mask)
    group = ivf_probe.group_size(tiles, qt)
    table = ivf_probe.group_table(*ivf_probe.list_entries(
        tcells, tsegs, n_chunks=n_chunks, n_segments=n_seg), n_chunks, group)
    got = ivf_probe.ivf_candidates_grouped_plain(
        tq, table, tcodes, tsq, tmask, n_seg, qt, cell_scales=tscales)
    want = ivf_probe.ivf_candidates_int8_plain(
        tq, tcells, tsegs, tcodes, tscales, tsq, tmask, n_seg, qt)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    jval, jidx = pallas_ivf.pallas_ivf_candidates_int8(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(segs),
        jnp.asarray(codes), jnp.asarray(scales)[None], jnp.asarray(sq)[None],
        jnp.asarray(mask)[None], cell_pad=128, n_buckets=128, query_tile=qt,
        n_segments=n_seg, cps=1, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jidx))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jval),
                               rtol=INT8_RTOL, atol=INT8_ATOL)
    assert (want[1] >= 0).any()


@pytest.mark.parametrize("d", [24, 27])
@pytest.mark.parametrize("nq,qt", [(37, 8), (21, 3)])
def test_group_table_equals_per_tile_twin_compact_int8(rng, ref_ivf, d, nq,
                                                       qt):
    """The compact form's table on int8 cells: windows of 3 chunks from
    cells 2 chunks apart (chunks reached from two cells, a clamp at the
    last chunk), against the per-tile twin bit for bit and
    pallas_ivf_candidates_packed_int8 as above."""
    jnp, pallas_ivf = ref_ivf
    n_chunks, n_seg, w128, nlist = 24, 8, 3, 12
    codes, scales, sq, mask = _grouped_int8(rng, n_chunks, d)
    q_pad = -(-nq // qt) * qt
    q = rng.standard_normal((q_pad, d)).astype(np.float32)
    tiles = q_pad // qt
    off128 = np.arange(0, 2 * nlist, 2, dtype=np.int32)
    cells = np.sort(rng.integers(0, nlist, (tiles, 6)), axis=1).astype(
        np.int32)
    tq, tcells, toff, tcodes, tscales, tsq, tmask = _t(
        q, cells, off128, codes, scales, sq, mask)
    group = ivf_probe.group_size(tiles, qt)
    table = ivf_probe.group_table(*ivf_probe.list_entries(
        tcells, off128=toff, w128=w128, n_chunks=n_chunks,
        n_segments=n_seg), n_chunks, group)
    got = ivf_probe.ivf_candidates_grouped_plain(
        tq, table, tcodes, tsq, tmask, n_seg, qt, cell_scales=tscales)
    want = ivf_probe.ivf_candidates_packed_int8_plain(
        tq, tcells, toff, tcodes, tscales, tsq, tmask, w128, n_seg, qt)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    jval, jidx = pallas_ivf.pallas_ivf_candidates_packed_int8(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(off128),
        jnp.asarray(codes), jnp.asarray(scales)[None], jnp.asarray(sq)[None],
        jnp.asarray(mask)[None], w128=w128, n_buckets=128, query_tile=qt,
        n_segments=n_seg, cps=1, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jidx))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jval),
                               rtol=INT8_RTOL, atol=INT8_ATOL)


# ---------------------------------------------------------------- 3xTF32


def _rna_np(x):
    """numpy tf32 rounding: the f32 bits + 0x1000, the low 13 cleared."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_and_query_buffers():
    """The emulation rounds as cvt.rna.tf32.f32 does (to 10 mantissa bits,
    ties away from zero), and the kernels' query scratch is padded to 16
    bytes a row: 4 f32 or 8 bf16."""
    x = np.float32([1.0, -1.0, 0.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                    1 + 2.0 ** -12, 3.14159265])
    got = _rna_np(x)
    assert got[3] == 1 + 2.0 ** -10 and got[4] == -(1 + 2.0 ** -10)
    assert got[5] == 1.0 and got[0] == 1.0 and got[2] == 0.0
    assert not (got.view(np.uint32) & 0x1FFF).any()
    assert abs(got[6] - x[6]) <= 2.0 ** -11 * abs(x[6])
    lo = _rna_np(x - got)
    assert (np.abs(x - got - lo) <= 2.0 ** -22 * np.abs(x) + 1e-45).all()
    for dtype, d, d_pad in ((torch.float32, 99, 100), (torch.float32, 512,
                                                       512),
                            (torch.bfloat16, 99, 104),
                            (torch.bfloat16, 96, 96)):
        q, hi, lo_buf, pad = mma_queries(torch.zeros((3, d)),
                                         torch.zeros((1, d), dtype=dtype))
        assert pad == d_pad and hi.shape == (3, d_pad) and hi.dtype == dtype
        assert q.dtype == torch.float32 and q.is_contiguous()
        assert (lo_buf is hi) == (dtype == torch.bfloat16)


def _dots_3xtf32(q, x):
    """(Q, N) dots as the f32 kernels form them: lo*hi + hi*lo + hi*hi,
    each product exact (tf32 x tf32 fits f32), summed in f32 in one long
    running order over d (the worst order a card's sum could take)."""
    qh = _rna_np(q)
    ql = _rna_np(q - qh)
    xh = _rna_np(x)
    xl = _rna_np(x - xh)
    acc = np.zeros((q.shape[0], x.shape[0]), np.float32)
    for k in range(q.shape[1]):
        for a, b in ((xl, qh), (xh, ql), (xh, qh)):
            acc += (b[:, k:k + 1] * a[None, :, k]).astype(np.float32)
    return acc


def test_3xtf32_holds_the_scan_tolerance():
    """chip_smoke.py's scan inputs: randn rows and queries, d = 512."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2048, 512)).astype(np.float32)
    q = rng.standard_normal((8, 512)).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    want = 2.0 * (torch.from_numpy(q) @ torch.from_numpy(x).T).numpy() - sq
    got = 2.0 * _dots_3xtf32(q, x) - sq
    err = np.abs(got - want)
    assert (err <= 1e-3 + 1e-5 * np.abs(want)).all(), err.max()
    # and without the split a single tf32 product would not hold it
    one = 2.0 * (_rna_np(q) @ _rna_np(x).T) - sq
    assert (np.abs(one - want) > 1e-3 + 1e-5 * np.abs(want)).any()


def test_3xtf32_holds_the_probe_tolerance():
    """chip_smoke.py's IVF inputs: clustered rows (centres x 3, spread
    0.4), queries near rows, d = 512; tolerance 1e-5 of 2|q||x|max +
    |x|max^2 per query."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((16, 512)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 16, 1024)]
         + 0.4 * rng.standard_normal((1024, 512)).astype(np.float32))
    q = x[:8] + 0.05 * rng.standard_normal((8, 512)).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    want = 2.0 * (torch.from_numpy(q) @ torch.from_numpy(x).T).numpy() - sq
    got = 2.0 * _dots_3xtf32(q, x) - sq
    x_max = np.sqrt(sq.max())
    tol = 1e-5 * (2 * np.linalg.norm(q, axis=1, keepdims=True) * x_max
                  + x_max ** 2)
    assert (np.abs(got - want) <= tol).all()
