"""IVF probe: the port of tpuvdb/kernels/pallas_ivf.py (f32, bf16 and int8
cells).

Four candidate functions, one per form of the reference's packed-layout
probe and cell type, each a hand-written CUDA kernel in
`tpuvdb_torch/csrc/ivf_probe.cu` on CUDA tensors (built with nvcc for
sm_90a into `tpuvdb_torch/build/` on first use, bound with ctypes) and a
plain PyTorch twin on CPU tensors:

  ivf_candidates          replaces pallas_ivf._probe_kernel (the
                          `pl.pallas_call` of pallas_ivf_candidates,
                          pallas_ivf.py:401): the tile's sorted chunk ids,
                          with a segment per entry.
  ivf_candidates_packed   replaces pallas_ivf._probe_kernel_packed (the call
                          of pallas_ivf_candidates_packed, :473): the tile's
                          sorted probed cells plus the per-cell chunk start
                          `off128`; segment = chunk mod n_segments.
  ivf_candidates_int8     replaces pallas_ivf._probe_kernel_int8 (the call
                          of pallas_ivf_candidates_int8, :330): the first
                          form on int8 cells with per-row scales.
  ivf_candidates_packed_int8
                          replaces pallas_ivf._probe_kernel_packed_int8 (the
                          call of pallas_ivf_candidates_packed_int8, :549):
                          the second form on int8 cells.

On CUDA tensors all four run on one tensor-core kernel template (bf16,
3xTF32 or s8 products): the wrapper groups `group_size` tiles, builds
their `group_table` (per group and chunk id the segment each tile gives
the chunk, or -1; one scatter on the device, no sort, no host sync) and
the kernel reads each chunk some tile names once a group; a batch of one
tile walks its own list and builds no table.
`ivf_candidates_grouped_plain` is the plain consumer of that table and
returns what the per-tile twins return.

For each tile of `query_tile` queries all return, per query and slot
(segment * 128 + column), the best score `2 q.x - ||x||^2 + mask` among the
rows chunk * 128 + column of the chunks in that segment, and its row (the
lowest on a tie; -1 and f32-min for an empty slot). On int8 cells the
wrappers quantize the query batch with one scale (`quantize_batch`; the
scale covers the whole padded batch, so a batch and a slice of it score
differently) and the score is `((2 s_q) s_r) (q_i8 . x_i8) - ||x||^2 +
mask` with the dot exact in int32 (rows of at most INT8_MAX_DIM columns;
wider ones raise, on either device) and each f32 operation rounded once,
in the kernel as in the twin: the two agree bit for bit. That is what the
reference's sequential strict-`>` fold computes, because a chunk always
lands in the same slots and distinct chunks first appear in ascending order
(csrc/ivf_probe.cu explains why); the plain twins compute it directly, with
a max and a min-id per slot, so neither depends on the order of the list.
An entry whose chunk, segment or cell id is out of range scores nothing;
lists of the wrong shape raise, on either device. On a CUDA tensor a
wrapper launches its kernel or raises; `LAUNCHES_EXPANDED`,
`LAUNCHES_COMPACT`, `LAUNCHES_EXPANDED_INT8` and `LAUNCHES_COMPACT_INT8`
count launches.

`ivf_probe_search` is the port of `pallas_ivf_search` on the packed layout
(cell_offsets given; the fixed-stride layout is not used by IVFIndex): the
coarse pick is a full-f32 matmul and `torch.topk(nprobe)` per query, each
tile of 8 queries (fewer when Q < 8) probes the sorted union of its queries'
cells, the spill rows are scanned exactly (int8 spill rows dequantized and
scored against the unquantized queries), and an exact top-k finishes, all
as in the reference. The dispatch between the forms is kept as a result
contract: the two choose different candidate sets, so the expanded form
runs while Q_pad * nprobe * w128 <= 2**20 (`EXPANDED_MAX`, the reference's
`_EXPANDED_PREFETCH_MAX`, a TPU SMEM limit there) and the compact form above
it or with `force_compact=True`, and the port's candidates equal the
reference's at every size. `cps_override` and `coarse_approx` (TPU grid-step
and partial-reduction levers) are not ported.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tpuvdb_torch.kernels.cuda_build import CudaLibrary
from tpuvdb_torch.kernels.distance import (mma_queries, mma_width,
                                           queries_like)
from tpuvdb_torch.kernels.quant import int8_dots, quantize_batch
from tpuvdb_torch.utils.tracing import span

NEG_INF = float(torch.finfo(torch.float32).min)
CHUNK = 128          # rows per chunk, the reference's lane width
MAX_QUERY_TILE = 8   # queries per tile, the reference's query_tile
EXPANDED_MAX = 1 << 20
MMA_COLS = 128       # queries of the widest tensor-core product
# int8 cells: the widest row whose dot stays exact in int32 (|q|, |x| <= 127)
INT8_MAX_DIM = (2 ** 31 - 1) // 127 ** 2
MIN_BLOCK_CHUNKS = 4  # chunks a block of the tensor-core probe walks, at least
BLOCKS_PER_SM = 16    # blocks the splits aim at, per SM, in all
PLAIN_BLOCK_CHUNKS = 512  # chunks gathered at once by the plain twins

LAUNCHES_EXPANDED = 0  # ivf_candidates kernel launches (CUDA tensors)
LAUNCHES_COMPACT = 0   # ivf_candidates_packed kernel launches
LAUNCHES_EXPANDED_INT8 = 0  # ivf_candidates_int8 kernel launches
LAUNCHES_COMPACT_INT8 = 0   # ivf_candidates_packed_int8 kernel launches

_INT_MAX = torch.iinfo(torch.int32).max
_sm_counts = {}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tpuvdb_ivf_probe_f32, lib.tpuvdb_ivf_probe_bf16,
               lib.tpuvdb_ivf_probe_i8):
        fn.restype = i
        fn.argtypes = [p] * 13 + [i] * 16 + [p]
    lib.tpuvdb_ivf_error.restype = ctypes.c_char_p
    lib.tpuvdb_ivf_error.argtypes = [i]


LIBRARY = CudaLibrary("ivf_probe.cu", "libtpuvdb_ivf_probe.so", _bind,
                      headers=("probe_common.cuh", "hopper_mma.cuh",
                               "device_guard.cuh"))


# ------------------------------------------------------------ plain twins


def _fold_block(run_val, run_idx, scores, ids, slots):
    """Fold (QT, R) scores of rows `ids` landing in `slots` into the
    running (QT, n_slots) best: the max score, then the lowest id among
    the rows reaching it; scores <= f32-min never enter."""
    qn, n_slots = run_val.shape
    slot_e = slots.expand(qn, -1)
    bval = torch.full_like(run_val, NEG_INF).scatter_reduce(
        1, slot_e, scores, "amax")
    hit = (scores == bval.gather(1, slot_e)) & (scores > NEG_INF)
    cand = torch.where(hit, ids.expand(qn, -1), _INT_MAX)
    bidx = torch.full_like(run_idx, _INT_MAX).scatter_reduce(
        1, slot_e, cand, "amin")
    cur = torch.where(run_idx < 0, _INT_MAX, run_idx)
    better = (bval > run_val) | ((bval == run_val) & (bidx < cur))
    better &= bval > NEG_INF
    return (torch.where(better, bval, run_val),
            torch.where(better, bidx, run_idx))


def _plain_fold(score, qp, grouped, tile_chunks, tile_segs, n_segments,
                query_tile, tile_extra=None):
    """Shared body of the plain twins: per tile, the distinct chunks and
    their segments, folded in blocks of PLAIN_BLOCK_CHUNKS.
    score(lo, hi, rows) gives the (hi - lo, len(rows)) f32 scores of queries
    [lo, hi) against the grouped rows `rows`. With `tile_extra`, a third
    per-entry list (the PQ probe's owning cells), a chunk's value is taken
    where its segment is, at its first occurrence, and score gets the
    block's values as a fourth argument."""
    n_chunks = grouped.shape[0] // CHUNK
    dev = grouped.device
    n_slots = CHUNK * n_segments
    val = torch.full((qp, n_slots), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.full((qp, n_slots), -1, dtype=torch.int32, device=dev)
    col = torch.arange(CHUNK, dtype=torch.int64, device=dev)
    for t, (chunks, segs) in enumerate(zip(tile_chunks, tile_segs)):
        keep = (chunks >= 0) & (chunks < n_chunks)
        uniq, first = _first_occurrence(chunks[keep].long())
        useg = segs[keep].long()[first]
        # as the kernel: a chunk whose (first) segment is out of range
        # scores nothing
        ok = (useg >= 0) & (useg < n_segments)
        uniq, useg = uniq[ok], useg[ok]
        if tile_extra is not None:
            uextra = tile_extra[t][keep].long()[first][ok]
        lo_q, hi_q = t * query_tile, (t + 1) * query_tile
        rv, ri = val[lo_q:hi_q], idx[lo_q:hi_q]
        for lo in range(0, uniq.shape[0], PLAIN_BLOCK_CHUNKS):
            c = uniq[lo:lo + PLAIN_BLOCK_CHUNKS]
            rows = (c[:, None] * CHUNK + col).reshape(-1)
            slots = (useg[lo:lo + PLAIN_BLOCK_CHUNKS, None] * CHUNK
                     + col).reshape(1, -1)
            extra = (() if tile_extra is None
                     else (uextra[lo:lo + PLAIN_BLOCK_CHUNKS],))
            rv, ri = _fold_block(rv, ri, score(lo_q, hi_q, rows, *extra),
                                 rows.to(torch.int32)[None], slots)
        val[lo_q:hi_q] = rv
        idx[lo_q:hi_q] = ri
    return val, idx


def _score_float(queries, grouped, grouped_sq, neg_mask):
    """score() of _plain_fold for f32/bf16 cells: 2 q.x - ||x||^2 + mask."""
    q = queries_like(queries, grouped)
    sq, mask = grouped_sq.reshape(-1), neg_mask.reshape(-1)

    def score(lo, hi, rows):
        x = grouped[rows].to(torch.float32)
        return 2.0 * (q[lo:hi] @ x.T) - sq[rows] + mask[rows]

    return score


def check_int8_dim(name: str, d: int) -> None:
    """Raise where an int8 dot of width d could leave int32: the kernel's
    s32 sums and the twin's are exact only below that."""
    if d > INT8_MAX_DIM:
        raise ValueError(f"{name}: int8 rows of {d} > {INT8_MAX_DIM} "
                         "columns: their dots could overflow int32")


def int8_query_operand(queries):
    """The int8 kernel's query input: the batch quantized with one scale
    (quantize_batch), rows padded with zeros to d_pad, a multiple of 16
    bytes, so TMA reads them (a zero column adds 0 to an exact dot).
    Returns (q8 (Q, d_pad) int8, scale (1, 1) f32, d_pad)."""
    qi, qscale = quantize_batch(queries)
    d = qi.shape[1]
    d_pad = -(-d // 16) * 16
    if d_pad != d:
        qi = F.pad(qi, (0, d_pad - d))
    return qi.contiguous(), qscale, d_pad


def _score_int8(queries, grouped_i8, cell_scales, grouped_sq, neg_mask):
    """score() of _plain_fold for int8 cells, in the reference's order:
    ((2 s_q) s_r) f32(q_i8 . x_i8) - ||x||^2 + mask, each tensor op rounded
    once."""
    if grouped_i8.dtype != torch.int8:
        raise ValueError(f"int8 probe takes int8 cells, not "
                         f"{grouped_i8.dtype}")
    check_int8_dim("int8 probe", grouped_i8.shape[1])
    qi, qscale = quantize_batch(queries)
    scales = cell_scales.reshape(-1).to(torch.float32)
    sq, mask = grouped_sq.reshape(-1), neg_mask.reshape(-1)

    def score(lo, hi, rows):
        dots = int8_dots(qi[lo:hi], grouped_i8[rows]).to(torch.float32)
        return (2.0 * qscale * scales[rows][None, :] * dots - sq[rows]
                + mask[rows])

    return score


def _first_occurrence(x: torch.Tensor):
    """(sorted distinct values of x, index in x of each one's first
    occurrence)."""
    uniq, inv = torch.unique(x, sorted=True, return_inverse=True)
    pos = torch.arange(x.shape[0], device=x.device)
    first = torch.full(uniq.shape, x.shape[0], dtype=torch.int64,
                       device=x.device).scatter_reduce(0, inv, pos, "amin")
    return uniq, first


def ivf_candidates_plain(queries, cells, segs, grouped, grouped_sq, neg_mask,
                         n_segments: int, query_tile: int):
    """Plain twin of the expanded-form kernel (see ivf_candidates)."""
    return _plain_fold(_score_float(queries, grouped, grouped_sq, neg_mask),
                       queries.shape[0], grouped, cells, segs, n_segments,
                       query_tile)


def ivf_candidates_int8_plain(queries, cells, segs, grouped_i8, cell_scales,
                              grouped_sq, neg_mask, n_segments: int,
                              query_tile: int):
    """Plain twin of the expanded-form int8 kernel (see
    ivf_candidates_int8)."""
    return _plain_fold(
        _score_int8(queries, grouped_i8, cell_scales, grouped_sq, neg_mask),
        queries.shape[0], grouped_i8, cells, segs, n_segments, query_tile)


def packed_chunks(cells, off128, w128: int, n_chunks: int):
    """The compact form's chunk list: entry g of a tile is chunk
    min(off128[cells[g // w128]] + g % w128, n_chunks - 1), or -1 (no
    chunk) where the cell id is not one of off128's."""
    w = torch.arange(w128, dtype=torch.int64, device=cells.device)
    nlist = off128.numel()
    ok = (cells >= 0) & (cells < nlist)
    start = off128.long()[cells.long().clamp(0, max(nlist - 1, 0))]
    chunks = (start[:, :, None] + w).clamp(max=n_chunks - 1)
    chunks = torch.where(ok[:, :, None], chunks, -1)
    return chunks.reshape(cells.shape[0], -1)


def ivf_candidates_packed_plain(queries, cells, off128, grouped, grouped_sq,
                                neg_mask, w128: int, n_segments: int,
                                query_tile: int):
    """Plain twin of the compact-form kernel (see ivf_candidates_packed)."""
    chunks = packed_chunks(cells, off128, w128, grouped.shape[0] // CHUNK)
    return _plain_fold(_score_float(queries, grouped, grouped_sq, neg_mask),
                       queries.shape[0], grouped, chunks,
                       chunks % n_segments, n_segments, query_tile)


def ivf_candidates_packed_int8_plain(queries, cells, off128, grouped_i8,
                                     cell_scales, grouped_sq, neg_mask,
                                     w128: int, n_segments: int,
                                     query_tile: int):
    """Plain twin of the compact-form int8 kernel (see
    ivf_candidates_packed_int8)."""
    chunks = packed_chunks(cells, off128, w128, grouped_i8.shape[0] // CHUNK)
    return _plain_fold(
        _score_int8(queries, grouped_i8, cell_scales, grouped_sq, neg_mask),
        queries.shape[0], grouped_i8, chunks, chunks % n_segments,
        n_segments, query_tile)


def group_size(tiles: int, query_tile: int) -> int:
    """Tiles a kernel block serves together: as many as the widest product
    (128 queries) holds, so each chunk is read once for up to 128 queries."""
    return max(1, min(tiles, MMA_COLS // query_tile))


def list_entries(cells, segs=None, off128=None, w128: int = 1,
                 n_chunks: int = 0, n_segments: int = 1):
    """(chunk, segment, ok) for every entry of the per-tile lists, as the
    kernel's list walk reads them (entry_chunk in csrc/probe_common.cuh):
    expanded (segs given), an entry that repeats the one before it or names
    no chunk or segment is not ok; compact (off128 given), entry g is chunk
    min(off128[cells[g // w128]] + g % w128, n_chunks - 1) with segment
    chunk mod n_segments, not ok where the cell is out of range (entries
    that repeat a chunk carry its one segment)."""
    if segs is None:
        chunks = packed_chunks(cells, off128, w128, n_chunks)
        ok = chunks >= 0
        return chunks, torch.where(ok, chunks % n_segments, -1), ok
    first = torch.ones_like(cells, dtype=torch.bool)
    first[:, 1:] = cells[:, 1:] != cells[:, :-1]
    ok = (first & (cells >= 0) & (cells < n_chunks) & (segs >= 0)
          & (segs < n_segments))
    return cells, segs, ok


def group_table(chunks, segs, ok, n_chunks: int,
                group: int) -> torch.Tensor:
    """What each group of `group` consecutive tiles reads once, from the
    per-tile entries (chunks, segs, ok, each (tiles, W), from
    list_entries): a (groups, n_chunks + 1, group) int32 table whose
    [g, c, j] is the segment tile g * group + j gives chunk c, or -1 where
    that tile's list does not name it; a chunk no tile of the group names
    is a row of -1, which the kernel skips, and row n_chunks takes the
    entries that name no chunk (it is never read). One scatter, in torch
    ops of fixed shapes: nothing is sorted or read back to the host."""
    tiles, width = chunks.shape
    groups = -(-tiles // group)
    dev = chunks.device
    tile = torch.arange(tiles, device=dev)[:, None]
    chunk = torch.where(ok, chunks.long(), n_chunks)
    flat = ((tile // group) * (n_chunks + 1) + chunk) * group + tile % group
    table = torch.full((groups * (n_chunks + 1) * group,), -1,
                       dtype=torch.int32, device=dev)
    table[flat.reshape(-1)] = segs.to(torch.int32).reshape(-1)
    return table.view(groups, n_chunks + 1, group)


def ivf_candidates_grouped_plain(queries, table, grouped, grouped_sq,
                                 neg_mask, n_segments: int, query_tile: int,
                                 cell_scales=None):
    """Plain consumer of a group_table: each tile folds the chunks its
    column of the table names, in their segments. Equal to the per-tile
    twins (ivf_candidates_plain / ivf_candidates_packed_plain, and with
    `cell_scales` on int8 cells ivf_candidates_int8_plain /
    ivf_candidates_packed_int8_plain) on the lists the table was built
    from."""
    _, rows, group = table.shape
    tile_chunks, tile_segs = [], []
    for t in range(queries.shape[0] // query_tile):
        g, j = divmod(t, group)
        col = table[g, :rows - 1, j]
        listed = torch.nonzero(col >= 0).reshape(-1)
        tile_chunks.append(listed)
        tile_segs.append(col[listed])
    score = (_score_float(queries, grouped, grouped_sq, neg_mask)
             if cell_scales is None else
             _score_int8(queries, grouped, cell_scales, grouped_sq, neg_mask))
    return _plain_fold(score, queries.shape[0], grouped, tile_chunks,
                       tile_segs, n_segments, query_tile)


# --------------------------------------------------------------- wrappers


def _check(name, queries, grouped, f32_arrays, int_arrays,
           dtypes=(torch.float32, torch.bfloat16)):
    """Raise unless the kernel takes these devices, dtypes and layouts."""
    dev = grouped.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in (queries,) + f32_arrays + int_arrays:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device}, cells on {dev}")
    if grouped.dtype not in dtypes:
        raise NotImplementedError(
            f"{name} takes cells of {dtypes}, not {grouped.dtype} (int8 "
            "cells go through ivf_candidates_int8 / "
            "ivf_candidates_packed_int8)")
    for t in f32_arrays:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: per-row arrays must be float32")
        if t.numel() != grouped.shape[0]:
            raise ValueError(f"{name}: per-row arrays must have "
                             f"{grouped.shape[0]} rows")
    for t in int_arrays:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index arrays must be int32")
    if not grouped.is_contiguous():
        raise ValueError(f"{name}: grouped must be contiguous")
    n, d = grouped.shape
    if n % CHUNK or n >= 2 ** 31:
        raise ValueError(f"{name}: grouped rows {n} must be a multiple of "
                         f"{CHUNK} below 2**31")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"{name}: queries {tuple(queries.shape)} vs dim {d}")


def _check_lists(name, queries, query_tile, n_segments, cells, segs=None,
                 off128=None):
    """Raise unless the per-tile lists fit the queries and the outputs: the
    kernel indexes the queries and its outputs by tile, so a list of the
    wrong shape raises here, on either device. Values need no check: an
    entry whose segment or cell id is out of range scores nothing, in the
    kernel and in the plain twins alike."""
    if not 1 <= query_tile <= MAX_QUERY_TILE:
        raise ValueError(f"{name}: query_tile must be 1..{MAX_QUERY_TILE}")
    if queries.shape[0] % query_tile:
        raise ValueError(f"{name}: queries {queries.shape[0]} % query_tile "
                         f"{query_tile} != 0")
    if n_segments < 1:
        raise ValueError(f"{name}: n_segments must be >= 1")
    if cells.dim() != 2 or cells.shape[0] * query_tile != queries.shape[0]:
        raise ValueError(f"{name}: cells {tuple(cells.shape)} must have one "
                         f"row per tile of {query_tile} of the "
                         f"{queries.shape[0]} queries")
    if segs is not None and segs.shape != cells.shape:
        raise ValueError(f"{name}: segs {tuple(segs.shape)} must have the "
                         f"shape of cells {tuple(cells.shape)}")
    if off128 is not None and off128.dim() != 1:
        raise ValueError(f"{name}: off128 must be 1-D")


def _splits(blocks: int, most: int, dev,
            per_sm: Optional[int] = None) -> int:
    """Splits of each block's walk: about `per_sm` (BLOCKS_PER_SM) blocks
    per SM in all, at most `most`."""
    if dev.index not in _sm_counts:
        _sm_counts[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    per_sm = per_sm or BLOCKS_PER_SM
    want = -(-per_sm * _sm_counts[dev.index] // blocks)
    return max(1, min(most, want, 65535))


def _outputs(qp, n_segments, dev):
    n_slots = CHUNK * n_segments
    keys = torch.empty((qp, n_slots), dtype=torch.int64, device=dev)
    val = torch.empty((qp, n_slots), dtype=torch.float32, device=dev)
    idx = torch.empty((qp, n_slots), dtype=torch.int32, device=dev)
    return keys, val, idx


def ivf_candidates(
    queries: torch.Tensor,     # (Q_pad, d) f32; Q_pad % query_tile == 0
    cells: torch.Tensor,       # (tiles, W) int32 chunk ids, sorted per tile
    segs: torch.Tensor,        # (tiles, W) int32 segment of each entry
    grouped: torch.Tensor,     # (n_chunks * 128, d) f32 or bf16
    grouped_sq: torch.Tensor,  # (n_chunks * 128,) f32
    neg_mask: torch.Tensor,    # (n_chunks * 128,) f32: 0 live / NEG_INF dead
    n_segments: int,
    query_tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expanded-form probe: (cand_val f32, cand_idx int32), each
    (Q_pad, 128 * n_segments)."""
    global LAUNCHES_EXPANDED
    _check_lists("ivf_candidates", queries, query_tile, n_segments, cells,
                 segs=segs)
    if grouped.device.type == "cpu":
        return ivf_candidates_plain(queries, cells, segs, grouped,
                                    grouped_sq, neg_mask, n_segments,
                                    query_tile)
    launched, val, idx = _launch(
        "ivf_candidates", queries, grouped, grouped_sq, neg_mask, n_segments,
        query_tile, cells, segs=segs)
    if launched:
        LAUNCHES_EXPANDED += 1
    return val, idx


def ivf_candidates_packed(
    queries: torch.Tensor,     # (Q_pad, d) f32; Q_pad % query_tile == 0
    cells: torch.Tensor,       # (tiles, U) int32 probed cells, sorted
    off128: torch.Tensor,      # (nlist,) int32 per-cell start / 128
    grouped: torch.Tensor,     # (n_chunks * 128, d) f32 or bf16
    grouped_sq: torch.Tensor,  # (n_chunks * 128,) f32
    neg_mask: torch.Tensor,    # (n_chunks * 128,) f32
    w128: int,                 # scan window in chunks
    n_segments: int,
    query_tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact-form probe: (cand_val f32, cand_idx int32), each
    (Q_pad, 128 * n_segments)."""
    global LAUNCHES_COMPACT
    _check_lists("ivf_candidates_packed", queries, query_tile, n_segments,
                 cells, off128=off128)
    if grouped.device.type == "cpu":
        return ivf_candidates_packed_plain(queries, cells, off128, grouped,
                                           grouped_sq, neg_mask, w128,
                                           n_segments, query_tile)
    launched, val, idx = _launch(
        "ivf_candidates_packed", queries, grouped, grouped_sq, neg_mask,
        n_segments, query_tile, cells, off128=off128, w128=w128)
    if launched:
        LAUNCHES_COMPACT += 1
    return val, idx


def _launch(name, queries, grouped, grouped_sq, neg_mask, n_segments,
            query_tile, cells, segs=None, off128=None, w128=None,
            cell_scales=None):
    """Shared body of the four wrappers on CUDA tensors: the expanded
    lists (cells, segs) or the compact ones (cells, off128, w128); int8
    cells take their `cell_scales`. A batch of one tile walks its list;
    more tiles go in groups of group_size through their group_table.
    Returns (launched, val, idx)."""
    # held in names until the launch: a temporary passed as a pointer
    # could be freed, and its memory reused, before the kernel runs
    sq = grouped_sq.reshape(-1).contiguous()
    mask = neg_mask.reshape(-1).contiguous()
    int8 = cell_scales is not None
    compact = off128 is not None
    second = off128 if compact else segs
    per_row = (sq, mask)
    if int8:
        scales = cell_scales.reshape(-1).contiguous()
        per_row += (scales,)
    _check(name, queries, grouped, per_row, (cells, second),
           dtypes=(torch.int8,) if int8 else (torch.float32, torch.bfloat16))
    lib = LIBRARY.load()
    n, d = grouped.shape
    if int8:
        check_int8_dim(name, d)
        q8, qscale, d_pad = int8_query_operand(queries)
        q_ops = (q8, qscale)
        q_rows = q8.shape[0]
    else:
        q, q_hi, q_lo, d_pad = mma_queries(queries, grouped)
        q_ops = (q, q_hi, q_lo)
        q_rows = q.shape[0]
    cells, second = cells.contiguous(), second.contiguous()
    dev = grouped.device
    tiles, width = cells.shape
    keys, val, idx = _outputs(q_rows, n_segments, dev)
    if tiles == 0 or width == 0 or n == 0:
        return False, val.fill_(NEG_INF), idx.fill_(-1)
    n_chunks = n // CHUNK
    group = group_size(tiles, query_tile)
    nlist = off128.numel() if compact else 0
    if group == 1:   # one tile: its own list, no table
        walk = 1 if compact else 0
        n_entries = width * (w128 if compact else 1)
        lists = (cells, None if compact else second,
                 second if compact else None, None)
        tab_width, cols = width, mma_width(query_tile)
    else:
        table = group_table(*list_entries(
            cells, None if compact else second, off128 if compact else None,
            w128 or 1, n_chunks, n_segments), n_chunks, group)
        walk = 2
        n_entries = n_chunks   # chunk ids a group's blocks look at
        lists = (None, None, None, table)
        tab_width, cols = n_chunks, mma_width(group * query_tile)
    blocks = -(-tiles // group)
    # a few chunks a block at least: each block fills its ring anew
    splits = _splits(blocks, max(1, n_entries // MIN_BLOCK_CHUNKS), dev)
    # TMA reads a base and a row stride that are multiples of 16 bytes
    ragged = grouped.data_ptr() % 16 != 0 or (d * grouped.element_size()) % 16
    ptrs = [t.data_ptr() for t in q_ops] + [grouped.data_ptr()]
    if int8:
        ptrs.append(scales.data_ptr())
    ptrs += [sq.data_ptr(), mask.data_ptr()]
    ptrs += [None if t is None else t.data_ptr() for t in lists]
    fn = (lib.tpuvdb_ivf_probe_i8 if int8
          else lib.tpuvdb_ivf_probe_f32 if grouped.dtype == torch.float32
          else lib.tpuvdb_ivf_probe_bf16)
    rc = fn(*ptrs, keys.data_ptr(), val.data_ptr(), idx.data_ptr(), walk,
            tiles, query_tile, group, cols, q_rows, d_pad, d, tab_width,
            w128 or 1, n_chunks, nlist, n_segments, splits, int(bool(ragged)),
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("ivf probe kernel launch failed: "
                           f"{lib.tpuvdb_ivf_error(rc).decode()}")
    return True, val, idx


def ivf_candidates_int8(
    queries: torch.Tensor,      # (Q_pad, d) f32, unquantized
    cells: torch.Tensor,        # (tiles, W) int32 chunk ids, sorted per tile
    segs: torch.Tensor,         # (tiles, W) int32 segment of each entry
    grouped_i8: torch.Tensor,   # (n_chunks * 128, d) int8
    cell_scales: torch.Tensor,  # (n_chunks * 128,) f32 dequant scales
    grouped_sq: torch.Tensor,   # (n_chunks * 128,) f32
    neg_mask: torch.Tensor,     # (n_chunks * 128,) f32: 0 live / NEG_INF dead
    n_segments: int,
    query_tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expanded-form probe of int8 cells: (cand_val f32, cand_idx int32),
    each (Q_pad, 128 * n_segments). The whole batch shares one query
    scale."""
    global LAUNCHES_EXPANDED_INT8
    _check_lists("ivf_candidates_int8", queries, query_tile, n_segments,
                 cells, segs=segs)
    if grouped_i8.device.type == "cpu":
        return ivf_candidates_int8_plain(queries, cells, segs, grouped_i8,
                                         cell_scales, grouped_sq, neg_mask,
                                         n_segments, query_tile)
    launched, val, idx = _launch(
        "ivf_candidates_int8", queries, grouped_i8, grouped_sq, neg_mask,
        n_segments, query_tile, cells, segs=segs, cell_scales=cell_scales)
    if launched:
        LAUNCHES_EXPANDED_INT8 += 1
    return val, idx


def ivf_candidates_packed_int8(
    queries: torch.Tensor,      # (Q_pad, d) f32, unquantized
    cells: torch.Tensor,        # (tiles, U) int32 probed cells, sorted
    off128: torch.Tensor,       # (nlist,) int32 per-cell start / 128
    grouped_i8: torch.Tensor,   # (n_chunks * 128, d) int8
    cell_scales: torch.Tensor,  # (n_chunks * 128,) f32
    grouped_sq: torch.Tensor,   # (n_chunks * 128,) f32
    neg_mask: torch.Tensor,     # (n_chunks * 128,) f32
    w128: int,                  # scan window in chunks
    n_segments: int,
    query_tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact-form probe of int8 cells: (cand_val f32, cand_idx int32),
    each (Q_pad, 128 * n_segments)."""
    global LAUNCHES_COMPACT_INT8
    _check_lists("ivf_candidates_packed_int8", queries, query_tile,
                 n_segments, cells, off128=off128)
    if grouped_i8.device.type == "cpu":
        return ivf_candidates_packed_int8_plain(
            queries, cells, off128, grouped_i8, cell_scales, grouped_sq,
            neg_mask, w128, n_segments, query_tile)
    launched, val, idx = _launch(
        "ivf_candidates_packed_int8", queries, grouped_i8, grouped_sq,
        neg_mask, n_segments, query_tile, cells, off128=off128, w128=w128,
        cell_scales=cell_scales)
    if launched:
        LAUNCHES_COMPACT_INT8 += 1
    return val, idx


# ----------------------------------------------------------- full search


class ProbePlan(NamedTuple):
    """The kernel inputs of one probe: padded queries, the form, the
    per-tile lists and the segment count; `qc2` is the coarse product
    2 q . c that picked the cells (the PQ probe scores with it)."""
    queries: torch.Tensor  # (Q_pad, d) f32
    query_tile: int
    compact: bool
    cells: torch.Tensor    # expanded: chunk ids; compact: cell ids
    segs: Optional[torch.Tensor]   # expanded only
    off128: torch.Tensor
    w128: int
    n_segments: int
    qc2: torch.Tensor      # (Q_pad, nlist) f32


def probe_plan(queries, centroids, cell_offsets, cell_pad: int, k: int,
               nprobe: int, query_tile: int = MAX_QUERY_TILE,
               force_compact: bool = False,
               expanded_chunks: Optional[int] = None) -> ProbePlan:
    """Coarse pick and per-tile lists, as pallas_ivf_search builds them.
    `expanded_chunks=n_chunks` asks for the expanded form at every size,
    with chunk ids clamped to n_chunks - 1 before the sort: the one form of
    the PQ probe (pallas_pq_search), which has no 2**20 dispatch."""
    qn, d = queries.shape
    if qn == 0:
        raise ValueError("ivf_probe_search: empty query batch")
    qt = min(query_tile, max(1, qn))
    q = queries.to(torch.float32)
    pad_q = (-qn) % qt
    if pad_q:
        q = torch.cat([q, q.new_zeros((pad_q, d))])
    c_sq = (centroids * centroids).sum(dim=-1)
    qc2 = 2.0 * (q @ centroids.T)
    c_scores = qc2 - c_sq[None, :]
    cells_pq = torch.topk(c_scores, nprobe, dim=1).indices  # (Q_pad, nprobe)
    cells = torch.sort(cells_pq.reshape(-1, qt * nprobe).to(torch.int32),
                       dim=1).values                       # (tiles, U)
    w128 = cell_pad // CHUNK
    off128 = (cell_offsets // CHUNK).to(torch.int32)
    n_segments = max(4, -(-2 * k // CHUNK))
    n_expanded = cells.shape[0] * cells.shape[1] * w128
    always = expanded_chunks is not None
    if always or (n_expanded <= EXPANDED_MAX and not force_compact):
        w = torch.arange(w128, dtype=torch.int32, device=cells.device)
        chunks = (off128[cells.long()][:, :, None] + w).reshape(
            cells.shape[0], -1)
        if always:
            chunks = chunks.clamp(max=expanded_chunks - 1)
        chunks = torch.sort(chunks, dim=1).values
        # segment = rank among the tile's distinct sorted chunks
        distinct = torch.ones_like(chunks, dtype=torch.bool)
        distinct[:, 1:] = chunks[:, 1:] != chunks[:, :-1]
        ranks = torch.cumsum(distinct.to(torch.int32), dim=1) - 1
        segs = (ranks % n_segments).to(torch.int32)
        return ProbePlan(q, qt, False, chunks, segs, off128, w128, n_segments,
                         qc2)
    # hash-derived segments balance only statistically: 2x, as the reference
    return ProbePlan(q, qt, True, cells, None, off128, w128, 2 * n_segments,
                     qc2)


def plan_candidates(plan: ProbePlan, grouped, grouped_sq, neg_mask,
                    plain: bool = False, cell_scales=None):
    """Run a plan through its form's wrapper (or, with plain=True, through
    the plain twin on the same device); int8 cells take their
    `cell_scales` and the int8 functions."""
    if grouped.dtype == torch.int8:
        if cell_scales is None:
            raise ValueError("int8 cells require cell_scales")
        if plan.compact:
            fn = (ivf_candidates_packed_int8_plain if plain
                  else ivf_candidates_packed_int8)
            return fn(plan.queries, plan.cells, plan.off128, grouped,
                      cell_scales, grouped_sq, neg_mask, plan.w128,
                      plan.n_segments, plan.query_tile)
        fn = ivf_candidates_int8_plain if plain else ivf_candidates_int8
        return fn(plan.queries, plan.cells, plan.segs, grouped, cell_scales,
                  grouped_sq, neg_mask, plan.n_segments, plan.query_tile)
    if plan.compact:
        fn = ivf_candidates_packed_plain if plain else ivf_candidates_packed
        return fn(plan.queries, plan.cells, plan.off128, grouped, grouped_sq,
                  neg_mask, plan.w128, plan.n_segments, plan.query_tile)
    fn = ivf_candidates_plain if plain else ivf_candidates
    return fn(plan.queries, plan.cells, plan.segs, grouped, grouped_sq,
              neg_mask, plan.n_segments, plan.query_tile)


def ivf_probe_search(
    queries: torch.Tensor,        # (Q, d) f32
    centroids: torch.Tensor,      # (nlist, d) f32
    grouped: torch.Tensor,        # (N_g, d) f32 or bf16, cells packed
    grouped_sq: torch.Tensor,     # (N_g,) f32
    grouped_valid: torch.Tensor,  # (N_g,) bool
    cell_offsets: torch.Tensor,   # (nlist,) packed start row per cell
    cell_pad: int,                # scan window (rows), multiple of 128
    k: int,
    nprobe: int,
    query_tile: int = MAX_QUERY_TILE,
    spill: Optional[torch.Tensor] = None,        # (S, d)
    spill_sq: Optional[torch.Tensor] = None,     # (S,)
    spill_valid: Optional[torch.Tensor] = None,  # (S,) bool
    force_compact: bool = False,
    cell_scales: Optional[torch.Tensor] = None,   # (N_g,) f32, int8 cells
    spill_scales: Optional[torch.Tensor] = None,  # (S,) f32, int8 spill
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, grouped_row), each (Q, k): exact ascending squared L2 of the
    candidates; spill row j has id N_g + j; empty slots +inf / -1. Spans:
    index.plan (the coarse pick and the lists), index.launch (the rest)."""
    qn = queries.shape[0]
    with span("index.plan"):
        plan = probe_plan(queries, centroids, cell_offsets, cell_pad, k,
                          nprobe, query_tile, force_compact)
    with span("index.launch"):
        neg_mask = torch.zeros(grouped_valid.shape, dtype=torch.float32,
                               device=grouped.device).masked_fill_(
                                   ~grouped_valid, NEG_INF)
        cand_val, cand_idx = plan_candidates(plan, grouped, grouped_sq,
                                             neg_mask, cell_scales=cell_scales)
        cand_val, cand_idx = cand_val[:qn], cand_idx[:qn]
        if spill is not None and spill.shape[0] > 0:
            if spill.dtype == torch.int8:
                # dequantized rows against the unquantized queries
                spill_f = spill.to(torch.float32) * spill_scales[:, None]
                sdots = queries.to(torch.float32) @ spill_f.T
            else:
                sdots = (queries_like(queries, spill)
                         @ spill.to(torch.float32).T)
            sneg = 2.0 * sdots - spill_sq[None, :]
            sneg = torch.where(spill_valid[None, :], sneg,
                               torch.full_like(sneg, NEG_INF))
            sids = grouped.shape[0] + torch.arange(
                spill.shape[0], dtype=torch.int32, device=grouped.device)
            cand_val = torch.cat([cand_val, sneg], dim=1)
            cand_idx = torch.cat([cand_idx, sids.expand(qn, -1)], dim=1)
        kk = min(k, cand_val.shape[1])
        # a stable sort: equal scores keep candidate order, as lax.top_k does
        neg, pos = torch.sort(cand_val, dim=1, descending=True, stable=True)
        neg, pos = neg[:, :kk], pos[:, :kk]
        idx = torch.gather(cand_idx, 1, pos)
        if kk < k:
            neg = F.pad(neg, (0, k - kk), value=NEG_INF)
            idx = F.pad(idx, (0, k - kk), value=-1)
        q = queries.to(torch.float32)
        q_sq = (q * q).sum(dim=-1, keepdim=True)
        idx = torch.where(neg <= NEG_INF, torch.full_like(idx, -1), idx)
        dist = torch.where(idx >= 0, q_sq - neg,
                           torch.full_like(neg, float("inf")))
        return dist, idx
