"""IVF-Flat index: the port of tpuvdb/index/ivf.py (f32, bf16 and int8
cells).

K-means coarse quantizer + cluster-pruned scan. Cells are laid out
contiguously at 128-row alignment in one grouped array on the device
(`pack_cells`); a probe scans a fixed window of `cell_pad` rows from each
probed cell's start, and rows past a cell's window spill into a region that
every query scans exactly. Each grouped row remembers its physical row id,
so results map straight back to the engine's (shard, slot) space.

Search runs `kernels/ivf_probe.ivf_probe_search` (the hand-written CUDA
probe kernels on the card, their plain twins on the CPU) for the whole
batch in one call. The reference's CPU route `_ivf_search` (an XLA row
gather with approx_max_k) is not ported: the plain twins replace it, so the
port's CPU results are the reference's probe results.

The host helpers (`ArrayRowSource`, `MirrorRowSource`,
`split_oversized_cells`, `_bisect_2means`, `pack_cells`,
`_pack_cells_from_source`, `_fill_rows_from_source`, `build_inverse_maps`,
`lookup_inverse`) are copies of the reference's f32 and int8 branches.

dtype=torch.int8 packs the cells and the spill as int8 codes with per-row
dequant scales (`cell_scales`, `spill_scales`; kernels/quant.py); the
squared norms stay those of the f32 rows. int8 mirrors hand their codes,
scales and norms over bit-exactly (`gather_raw`), other rows are quantized
with `quantize_rows_np` while packing, and appends quantize the same way.
A padding row of a cell has scale 1.0, code 0 and valid false, and scores
nothing. The reference's CPU-only route `_ivf_search_int8` is not ported,
as `_ivf_search` was not.

In-place writes. The reference's scatters are functional (donated
buffers); the port's `append_rows` and `invalidate_rows` write the device
tensors in place with torch index ops and bump `version`, so a search that
overlapped one can tell and retry. The reference's fixed 4096/1024-row
scatter buckets and `warm_append` (XLA compile workarounds) are not needed.

Not ported yet: PQ cells with `packed_capture`/`from_packed` (IVF-PQ), the
mesh-sharded index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpuvdb_torch.device import resolve_device
from tpuvdb_torch.kernels.ivf_probe import ivf_probe_search
from tpuvdb_torch.kernels.kmeans import assign_blockwise, kmeans
from tpuvdb_torch.kernels.quant import quantize_rows_np

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_ASSIGN_CHUNK = 16384


def _check_dtype(dtype) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"IVF cells of {dtype}: not one of {_DTYPES}")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_up_arr(x: np.ndarray, m: int) -> np.ndarray:
    return ((x + m - 1) // m) * m


class ArrayRowSource:
    """Row access over a materialized (n, d) f32 array."""

    def __init__(self, vectors: np.ndarray):
        self.v = np.asarray(vectors)
        self.n, self.dim = self.v.shape
        self.all_int8 = False

    def gather_f32(self, phys_rows: np.ndarray) -> np.ndarray:
        return np.asarray(self.v[phys_rows], np.float32)

    def gather_raw(self, phys_rows):
        raise RuntimeError("ArrayRowSource has no raw int8 rows")

    def iter_blocks_f32(self, block_rows: int):
        for lo in range(0, self.n, block_rows):
            yield lo, np.asarray(self.v[lo:lo + block_rows], np.float32)


class MirrorRowSource:
    """Row access over the shard mirrors without materializing the
    stacked corpus: samples, cell members and packed rows are gathered on
    demand, and the assignment pass streams each shard's written prefix.
    int8 mirrors hand their codes over bit-exactly (gather_raw), so packed
    int8 cells carry the mirrors' own quantization."""

    def __init__(self, mirrors, layout):
        self.mirrors = mirrors
        self.layout = layout
        self.n = layout.total_rows
        self.dim = layout.dim
        self.all_int8 = all(m.quantized for m in mirrors)

    def valid_array(self) -> np.ndarray:
        v = np.zeros(self.n, bool)
        for s, m in enumerate(self.mirrors):
            r0 = s * self.layout.phys_cap
            n = m.next_slot
            if n:
                v[r0:r0 + n] = m.valid[:n]
        return v

    def _split(self, phys_rows: np.ndarray):
        phys = np.asarray(phys_rows, np.int64)
        return phys // self.layout.phys_cap, phys % self.layout.phys_cap

    def gather_f32(self, phys_rows: np.ndarray) -> np.ndarray:
        shards, slots = self._split(phys_rows)
        out = np.empty((len(shards), self.dim), np.float32)
        for sh in np.unique(shards):
            sel = shards == sh
            out[sel] = self.mirrors[sh].rows_f32(slots[sel])
        return out

    def gather_raw(self, phys_rows: np.ndarray):
        """(codes int8, scales, sq): only valid when all_int8."""
        shards, slots = self._split(phys_rows)
        codes = np.empty((len(shards), self.dim), np.int8)
        scales = np.empty(len(shards), np.float32)
        sq = np.empty(len(shards), np.float32)
        for sh in np.unique(shards):
            sel = shards == sh
            c, sc, q = self.mirrors[sh].rows_raw(slots[sel])
            codes[sel] = c
            scales[sel] = sc
            sq[sel] = q
        return codes, scales, sq

    def iter_blocks_f32(self, block_rows: int):
        for s, m in enumerate(self.mirrors):
            r0 = s * self.layout.phys_cap
            for lo in range(0, m.next_slot, block_rows):
                hi = min(lo + block_rows, m.next_slot)
                yield r0 + lo, m.rows_f32(np.arange(lo, hi))


def _as_gather(vectors):
    if callable(vectors):
        return vectors
    return lambda rows: np.asarray(vectors[rows], np.float32)


def split_oversized_cells(
    vectors,                  # (N, d) array OR gather callable rows -> f32
    assign: np.ndarray,       # (N,) cell id, -1 = dead
    centroids: np.ndarray,    # (nlist, d)
    max_cell: int,
    seed: int = 0,
    max_rounds: int = 12,
) -> Tuple[np.ndarray, np.ndarray]:
    """Recursively 2-means-bisect every cell with more than max_cell
    members (children are real centroids, so coarse probing finds them).
    Host numpy, as in the reference. Returns (centroids, assign) with
    nlist grown."""
    rng = np.random.default_rng(seed)
    gather = _as_gather(vectors)
    cents = list(np.asarray(centroids, np.float32))
    assign = np.asarray(assign).copy()
    for _ in range(max_rounds):
        sizes = np.bincount(assign[assign >= 0], minlength=len(cents))
        oversized = np.flatnonzero(sizes > max_cell)
        if len(oversized) == 0:
            break
        for c in oversized:
            members = np.flatnonzero(assign == c)
            x = gather(members)
            sub_a = _bisect_2means(x, rng)
            if (sub_a == 0).all() or (sub_a == 1).all():
                # degenerate (duplicate points): force an even split
                sub_a = (np.arange(len(members)) % 2).astype(sub_a.dtype)
            half0 = x[sub_a == 0]
            half1 = x[sub_a == 1]
            cents[c] = half0.mean(axis=0).astype(np.float32)
            base = len(cents)
            cents.append(half1.mean(axis=0).astype(np.float32))
            assign[members[sub_a == 1]] = base
    return np.asarray(cents, np.float32), assign


def _bisect_2means(x: np.ndarray, rng: np.random.Generator,
                   iters: int = 4, sample: int = 16384) -> np.ndarray:
    """2-means labels for one cell, pure numpy: train on a subsample for
    very large cells, then assign everyone."""
    m = len(x)
    xs = x[rng.choice(m, size=sample, replace=False)] if m > sample else x
    c0 = xs[rng.integers(len(xs))]
    d0 = np.einsum("nd,nd->n", xs - c0, xs - c0)
    c1 = xs[int(np.argmax(d0))]
    cents = np.stack([c0, c1])
    for _ in range(iters):
        d = (np.einsum("nd,nd->n", xs, xs)[:, None]
             - 2.0 * (xs @ cents.T)
             + np.einsum("kd,kd->k", cents, cents)[None, :])
        lab = np.argmin(d, axis=1)
        for j in (0, 1):
            sel = xs[lab == j]
            if len(sel):
                cents[j] = sel.mean(axis=0)
    d = (np.einsum("nd,nd->n", x, x)[:, None]
         - 2.0 * (x @ cents.T)
         + np.einsum("kd,kd->k", cents, cents)[None, :])
    return np.argmin(d, axis=1)


def _cell_layout(rows, assign_live, nlist, window):
    """Shared packing plan: (rows_sorted, gpos of the kept rows, main mask,
    offsets, kept sizes, grouped_rows)."""
    order = np.argsort(assign_live, kind="stable")
    rows_sorted = rows[order]
    cells_sorted = assign_live[order]
    starts = np.searchsorted(cells_sorted, np.arange(nlist))
    counts = np.bincount(cells_sorted, minlength=nlist)
    kept = np.minimum(counts, window)
    offsets = np.zeros(nlist, np.int64)
    np.cumsum(_round_up_arr(kept, 128)[:-1], out=offsets[1:])
    total = int(offsets[-1] + _round_up(int(kept[-1]), 128)) if nlist else 0
    # + one full window of invalid tail rows so the last cells' scan
    # windows never alias a real row
    grouped_rows = _round_up(total + window, 128)
    pos_in_cell = np.arange(len(rows_sorted)) - starts[cells_sorted]
    main = pos_in_cell < window
    gpos = offsets[cells_sorted[main]] + pos_in_cell[main]
    return rows_sorted, gpos, main, offsets, kept, grouped_rows


def pack_cells(
    vectors: np.ndarray,
    rows: np.ndarray,        # physical row id per live vector position
    assign_live: np.ndarray, # cell id per live vector position
    nlist: int,
    window: int,             # scan window (rows), multiple of 128
):
    """Lay cells out contiguously at 128-row alignment. Probes scan
    [offset[c], offset[c] + window); over-scan into following cells reads
    valid rows scored exactly. Rows beyond window in a cell spill.
    Returns (gvec, gval, grow, offsets, sizes, spill_rows)."""
    rows_sorted, gpos, main, offsets, kept, grouped_rows = _cell_layout(
        rows, assign_live, nlist, window)
    gvec = np.zeros((grouped_rows, vectors.shape[1]), np.float32)
    gval = np.zeros(grouped_rows, bool)
    grow = np.full(grouped_rows, -1, np.int64)
    gvec[gpos] = vectors[rows_sorted[main]]
    gval[gpos] = True
    grow[gpos] = rows_sorted[main]
    spill_rows = list(rows_sorted[~main])
    return gvec, gval, grow, offsets.astype(np.int32), kept, spill_rows


def _fill_rows_from_source(source, phys_rows, vec_out, scale_out, sq_out,
                           positions, int8_out: bool, chunk: int = 1_000_000):
    """Copy `phys_rows` from the source into vec/scale/sq at `positions`,
    chunked so the f32 transient stays bounded. int8 output takes the
    bit-exact raw path when the source stores int8; otherwise it gathers
    f32 and quantizes per chunk. sq is the f32 row's (the stored norm on
    the raw path)."""
    raw_ok = int8_out and source.all_int8
    for lo in range(0, len(phys_rows), chunk):
        r = phys_rows[lo:lo + chunk]
        p = positions[lo:lo + chunk]
        if raw_ok:
            codes, scales, sq = source.gather_raw(r)
            vec_out[p] = codes
            scale_out[p] = scales
            sq_out[p] = sq
            continue
        f = source.gather_f32(r)
        sq_out[p] = np.einsum("nd,nd->n", f, f)
        if int8_out:
            vec_out[p], scale_out[p] = quantize_rows_np(f)
        else:
            vec_out[p] = f


def _pack_cells_from_source(source, rows, assign_live, nlist, window,
                            int8_out: bool):
    """pack_cells over a row source, rows copied straight into the target
    dtype. Returns (gvec, gscales|None, gsq, gval, grow, offsets, sizes,
    spill_rows); padding rows of an int8 cell keep scale 1.0."""
    rows_sorted, gpos, main, offsets, kept, grouped_rows = _cell_layout(
        rows, assign_live, nlist, window)
    gscales = np.ones(grouped_rows, np.float32) if int8_out else None
    gval = np.zeros(grouped_rows, bool)
    grow = np.full(grouped_rows, -1, np.int64)
    gval[gpos] = True
    grow[gpos] = rows_sorted[main]
    gvec = np.zeros((grouped_rows, source.dim),
                    np.int8 if int8_out else np.float32)
    gsq = np.zeros(grouped_rows, np.float32)
    _fill_rows_from_source(source, rows_sorted[main], gvec, gscales, gsq,
                           gpos, int8_out)
    spill_rows = np.asarray(rows_sorted[~main], dtype=np.int64)
    return (gvec, gscales, gsq, gval, grow, offsets.astype(np.int32), kept,
            spill_rows)


def build_inverse_maps(row_ids: np.ndarray, spill_row_ids: np.ndarray):
    """phys row -> flat grouped/spill position (-1 = absent)."""
    flat_g = np.asarray(row_ids).reshape(-1)
    flat_s = np.asarray(spill_row_ids).reshape(-1)
    hi = 0
    for ids in (flat_g, flat_s):
        if ids.size:
            hi = max(hi, int(ids.max()) + 1)
    inv_g = np.full(hi, -1, np.int64)
    m = flat_g >= 0
    inv_g[flat_g[m]] = np.flatnonzero(m)
    inv_s = np.full(hi, -1, np.int64)
    m = flat_s >= 0
    inv_s[flat_s[m]] = np.flatnonzero(m)
    return inv_g, inv_s


def lookup_inverse(inv_g: np.ndarray, inv_s: np.ndarray, phys: np.ndarray):
    """Map physical rows to (grouped_hits, spill_hits). Negative rows are
    excluded explicitly: -1 would wrap to inv[-1] under numpy indexing."""
    in_range = (phys >= 0) & (phys < len(inv_g))
    sel = phys[in_range]
    g_hits = inv_g[sel]
    s_hits = inv_s[sel]
    return g_hits[g_hits >= 0], s_hits[s_hits >= 0]


@dataclasses.dataclass
class IVFStats:
    nlist: int
    cell_pad: int
    spill_rows: int
    grouped_rows: int
    fill: float  # live rows / padded capacity


class IVFIndex:
    def __init__(
        self,
        centroids: np.ndarray,
        grouped: torch.Tensor,
        grouped_sq: torch.Tensor,
        grouped_valid: torch.Tensor,
        row_ids: np.ndarray,      # grouped row -> physical row (-1 pad)
        spill: torch.Tensor,
        spill_sq: torch.Tensor,
        spill_valid: torch.Tensor,
        spill_row_ids: np.ndarray,
        cell_pad: int,            # scan window (rows), multiple of 128
        cell_offsets: np.ndarray, # (nlist,) packed start row per cell
        cell_lens: np.ndarray,    # (nlist,) live rows per cell
        nprobe: int = 32,
        cell_scales: Optional[torch.Tensor] = None,   # (N_g,) int8 dequant
        spill_scales: Optional[torch.Tensor] = None,  # (S,)
    ):
        self.device = grouped.device
        _check_dtype(grouped.dtype)
        self.quantized = grouped.dtype == torch.int8
        if self.quantized != (cell_scales is not None
                              and spill_scales is not None):
            raise ValueError("int8 cells take cell_scales and spill_scales, "
                             "other cells take neither")
        self.cell_scales = cell_scales
        self.spill_scales = spill_scales
        self._centroids_np = np.array(centroids, np.float32)  # own copy
        self.centroids = torch.from_numpy(self._centroids_np).to(self.device)
        self.cell_offsets_np = np.array(cell_offsets, np.int32)
        self.cell_offsets = torch.from_numpy(self.cell_offsets_np).to(
            self.device)
        self.cell_lens = np.asarray(cell_lens, np.int32).copy()
        self.grouped = grouped
        self.grouped_sq = grouped_sq
        self.grouped_valid = grouped_valid
        self.row_ids = np.asarray(row_ids, np.int64).copy()
        self.spill = spill
        self.spill_sq = spill_sq
        self.spill_valid = spill_valid
        self.spill_row_ids = np.asarray(spill_row_ids, np.int64).copy()
        self.cell_pad = int(cell_pad)
        self.nprobe = int(nprobe)
        self.nlist = int(self._centroids_np.shape[0])
        self._inv_g = self._inv_s = None
        self.version = 0  # bumped by every in-place device write

    def centroids_np(self) -> np.ndarray:
        return self._centroids_np

    @classmethod
    def from_numpy(
        cls,
        centroids: np.ndarray,
        grouped: np.ndarray,        # (N_g, d) f32 values (bf16 given as f32)
        grouped_sq: np.ndarray,
        grouped_valid: np.ndarray,
        row_ids: np.ndarray,
        spill: np.ndarray,
        spill_sq: np.ndarray,
        spill_valid: np.ndarray,
        spill_row_ids: np.ndarray,
        cell_offsets: np.ndarray,
        cell_lens: np.ndarray,
        cell_pad: int,
        nprobe: int,
        dtype=torch.float32,
        device=None,
        cell_scales: Optional[np.ndarray] = None,   # int8 cells only
        spill_scales: Optional[np.ndarray] = None,
    ) -> "IVFIndex":
        """An index holding given arrays, e.g. a JAX IVFIndex's
        (np.asarray of each field): the same cells, the same probes. int8
        cells come as int8 codes with both scale arrays."""
        dev = resolve_device(device)

        def put(a, dt):
            return torch.from_numpy(np.array(a)).to(dev).to(dt)

        quant = dtype == torch.int8
        if quant and (np.asarray(grouped).dtype != np.int8
                      or np.asarray(spill).dtype != np.int8
                      or cell_scales is None or spill_scales is None):
            raise ValueError("int8 cells take int8 codes and both scale "
                             "arrays")

        def rows(a):
            return put(a if quant else np.asarray(a, np.float32), dtype)

        def f32(a):
            return put(np.asarray(a, np.float32), torch.float32)

        return cls(
            centroids=np.asarray(centroids, np.float32),
            grouped=rows(grouped),
            grouped_sq=f32(grouped_sq),
            grouped_valid=put(np.asarray(grouped_valid, bool), torch.bool),
            row_ids=row_ids,
            spill=rows(spill),
            spill_sq=f32(spill_sq),
            spill_valid=put(np.asarray(spill_valid, bool), torch.bool),
            spill_row_ids=spill_row_ids,
            cell_pad=cell_pad,
            cell_offsets=cell_offsets,
            cell_lens=cell_lens,
            nprobe=nprobe,
            cell_scales=f32(cell_scales) if quant else None,
            spill_scales=f32(spill_scales) if quant else None,
        )

    def live_phys_rows(self) -> np.ndarray:
        """Physical rows present and valid in this index (grouped +
        spill)."""
        g = self.row_ids
        gv = self.grouped_valid.cpu().numpy()[:len(g)]
        s = self.spill_row_ids
        sv = self.spill_valid.cpu().numpy()[:len(s)]
        return np.concatenate([g[(g >= 0) & gv], s[(s >= 0) & sv]])

    # ------------------------------------------------------------------ build

    @classmethod
    def build(cls, vectors: np.ndarray, valid: np.ndarray,
              **kw) -> "IVFIndex":
        """build_streaming over an ArrayRowSource."""
        return cls.build_streaming(ArrayRowSource(vectors), valid, **kw)

    @classmethod
    def build_streaming(
        cls,
        source,                   # ArrayRowSource | MirrorRowSource
        valid: np.ndarray,        # (N,) bool over physical rows
        nlist: int = 1024,
        nprobe: int = 32,
        kmeans_iters: int = 12,
        train_sample: int = 262_144,
        cell_cap_quantile: float = 0.98,
        dtype=torch.float32,
        seed: int = 0,
        split_oversized: bool = True,
        centroids: Optional[np.ndarray] = None,  # skip k-means training
        device=None,
    ) -> "IVFIndex":
        """Train (or reuse) the centroids on a sample, assign every row in
        blocks on the device, bound the largest cell by bisection, pack the
        cells and upload them. The cell window tracks 1.25x the median cell
        with split_oversized (default); cell_cap_quantile applies to the
        no-split path."""
        _check_dtype(dtype)  # before any training
        dev = resolve_device(device)
        n, d = source.n, source.dim
        live_idx = np.flatnonzero(valid)
        if len(live_idx) == 0:
            raise ValueError("cannot build IVF over empty corpus")
        rng = np.random.default_rng(seed)

        # 1. coarse quantizer: k-means on a sample, or caller-provided
        # centroids (checkpoint warm start: assignment only)
        if centroids is not None and centroids.shape[1] == d:
            centroids = np.asarray(centroids, np.float32)
            nlist = len(centroids)
        else:
            if len(live_idx) > train_sample:
                tr = np.sort(rng.choice(live_idx, size=train_sample,
                                        replace=False))
            else:
                tr = live_idx
            sample = source.gather_f32(tr)
            centroids, _ = kmeans(sample, np.ones(sample.shape[0], bool),
                                  nlist=nlist, iters=kmeans_iters, seed=seed,
                                  device=dev)
            del sample

        # 2. assign every row, streamed in blocks; invalid rows -> -1
        cents_t = torch.from_numpy(centroids).to(dev)
        assign = np.full(n, -1, np.int32)
        for g0, blk in source.iter_blocks_f32(262_144):
            a = assign_blockwise(torch.from_numpy(blk).to(dev), cents_t)
            assign[g0:g0 + len(blk)] = a.cpu().numpy()
        assign = np.where(valid, assign, -1)

        # 3. skew control: bound the max cell, then pack
        sizes = np.bincount(assign[assign >= 0], minlength=nlist)
        live_sizes = sizes[sizes > 0]
        if split_oversized and nlist > 1 and len(live_sizes):
            # window ~ 1.25x the median cell; bisect anything bigger
            cap = int(np.quantile(live_sizes, 0.5) * 1.25)
            cell_pad = max(_round_up(max(cap, 1), 128), 128)
            centroids, assign = split_oversized_cells(
                source.gather_f32, assign, centroids, cell_pad, seed=seed)
            nlist = len(centroids)
        else:
            cap = (int(np.quantile(sizes, cell_cap_quantile))
                   if nlist > 1 else int(sizes.max()))
            cell_pad = max(_round_up(max(cap, 1), 128), 128)

        live2 = np.flatnonzero(valid & (assign >= 0))
        int8_out = dtype == torch.int8
        (gvec, gscales, gsq, gval, grow, cell_offsets, cell_lens,
         spill_rows) = _pack_cells_from_source(
            source, live2, assign[live2], nlist, cell_pad, int8_out)

        # spill reserve: free capacity so append_rows can overflow full
        # cells here instead of forcing a rebuild
        reserve = min(8192, max(128, n // 8))
        s = max(len(spill_rows), 1)
        s_pad = _round_up(s + reserve, 128)
        svec = np.zeros((s_pad, d), np.int8 if int8_out else np.float32)
        sscales = np.ones(s_pad, np.float32) if int8_out else None
        ssq = np.zeros(s_pad, np.float32)
        sval = np.zeros(s_pad, bool)
        srow = np.full(s_pad, -1, np.int64)
        ns = len(spill_rows)
        if ns:
            _fill_rows_from_source(source, spill_rows, svec, sscales, ssq,
                                   np.arange(ns), int8_out)
            sval[:ns] = True
            srow[:ns] = spill_rows

        def put(a, dt=None):
            t = torch.from_numpy(a).to(dev)
            return t if dt is None else t.to(dt)

        return cls(
            centroids=centroids,
            grouped=put(gvec, dtype),
            grouped_sq=put(gsq),
            grouped_valid=put(gval),
            row_ids=grow,
            spill=put(svec, dtype),
            spill_sq=put(ssq),
            spill_valid=put(sval),
            spill_row_ids=srow,
            cell_pad=cell_pad,
            cell_offsets=cell_offsets,
            cell_lens=cell_lens,
            nprobe=nprobe,
            cell_scales=put(gscales) if int8_out else None,
            spill_scales=put(sscales) if int8_out else None,
        )

    # ----------------------------------------------------------------- search

    def masked_valid(self, cand_phys: np.ndarray):
        """Device validity masks restricted to `cand_phys` physical rows
        (the filter pushdown); pass as search(valid_override=...)."""
        g_hits, s_hits = lookup_inverse(
            *self._inverse_maps(), np.asarray(cand_phys, np.int64))
        gmask = torch.zeros_like(self.grouped_valid)
        gmask[torch.from_numpy(g_hits).to(self.device)] = True
        smask = torch.zeros_like(self.spill_valid)
        smask[torch.from_numpy(s_hits).to(self.device)] = True
        return self.grouped_valid & gmask, self.spill_valid & smask

    def search(
        self, queries: np.ndarray, k: int, nprobe: Optional[int] = None,
        valid_override=None, force_compact: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists, physical_rows) as numpy, dists ascending squared
        L2 in f32; -1 rows for empty slots. The whole batch is one probe.
        valid_override: (grouped_valid, spill_valid) from masked_valid().
        The reference's `out_w` (a cut to the width the engine consumes,
        with bf16 distances for its relay) is not carried over: the port's
        engine asks for exactly that width, and distances stay f32."""
        nprobe = min(nprobe or self.nprobe, self.nlist)
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            self.device)
        gval, sval = (valid_override if valid_override is not None
                      else (self.grouped_valid, self.spill_valid))
        dist, gid = ivf_probe_search(
            q, self.centroids, self.grouped, self.grouped_sq, gval,
            self.cell_offsets, cell_pad=self.cell_pad, k=k, nprobe=nprobe,
            spill=self.spill, spill_sq=self.spill_sq, spill_valid=sval,
            force_compact=force_compact, cell_scales=self.cell_scales,
            spill_scales=self.spill_scales)
        gid = gid.cpu().numpy()
        dist = dist.cpu().numpy()
        # map grouped/spill ids back to physical rows
        n_g = self.grouped.shape[0]
        rows = np.full(gid.shape, -1, dtype=np.int64)
        g = gid >= 0
        in_spill = gid >= n_g
        rows[g & ~in_spill] = self.row_ids[gid[g & ~in_spill]]
        sp = g & in_spill
        rows[sp] = self.spill_row_ids[gid[sp] - n_g]
        return dist, rows

    # ------------------------------------------------------------- mutations

    def _inverse_maps(self):
        """phys row -> grouped/spill position, built once (O(N)), so each
        delete is O(batch)."""
        if self._inv_g is None:
            self._inv_g, self._inv_s = build_inverse_maps(
                self.row_ids, self.spill_row_ids)
        return self._inv_g, self._inv_s

    def invalidate_rows(self, physical_rows: np.ndarray):
        """Soft-delete: clear the validity of these physical rows' grouped
        and spill slots, in place."""
        phys = np.asarray(physical_rows, np.int64)
        if phys.size == 0:
            return
        g_hits, s_hits = lookup_inverse(*self._inverse_maps(), phys)
        self.version += 1
        if len(g_hits):
            self.grouped_valid.index_fill_(
                0, torch.from_numpy(g_hits).to(self.device), False)
        if len(s_hits):
            self.spill_valid.index_fill_(
                0, torch.from_numpy(s_hits).to(self.device), False)

    def append_rows(self, physical_rows: np.ndarray,
                    vectors: np.ndarray) -> bool:
        """Add rows without re-clustering: each goes to its nearest
        existing centroid's free alignment slots (inside the scan window)
        or, when that cell is full, to the spill reserve. Returns False,
        with no state mutated, when capacity is exhausted (the caller then
        rebuilds)."""
        phys = np.asarray(physical_rows, np.int64)
        vecs = np.asarray(vectors, np.float32)
        m = len(phys)
        if m == 0:
            return True
        assign = np.empty(m, np.int32)
        for lo in range(0, m, _ASSIGN_CHUNK):
            chunk = torch.from_numpy(
                np.ascontiguousarray(vecs[lo:lo + _ASSIGN_CHUNK])).to(
                    self.device)
            assign[lo:lo + _ASSIGN_CHUNK] = assign_blockwise(
                chunk, self.centroids, block_size=2048).cpu().numpy()

        # ---- plan all slot allocations first; bail before any mutation
        offs = self.cell_offsets_np.astype(np.int64)
        lens = self.cell_lens.astype(np.int64)
        glen = self.grouped.shape[0]
        nexts = np.empty_like(offs)
        if len(offs) > 1:
            nexts[:-1] = offs[1:]
        nexts[-1] = min(glen, int(offs[-1]) + self.cell_pad)
        # usable capacity: allocated span, clipped to the scan window
        caps = np.minimum(nexts - offs, self.cell_pad)
        spill_len = int((self.spill_row_ids >= 0).sum())
        s_cap = self.spill.shape[0]
        g_pos: list = []
        g_take: list = []
        s_take: list = []
        for i in range(m):
            c = int(assign[i])
            if lens[c] < caps[c]:
                g_pos.append(int(offs[c] + lens[c]))
                lens[c] += 1
                g_take.append(i)
            elif spill_len + len(s_take) < s_cap:
                s_take.append(i)
            else:
                return False  # out of room everywhere: rebuild

        # ---- commit: host maps, then in-place device writes (rows and
        # norms before validity, so a racing probe sees a half-written
        # row only as masked)
        self.version += 1
        self.cell_lens = lens.astype(np.int32)
        self._inv_g = self._inv_s = None  # inverse maps grew: rebuild lazily
        sq = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
        payload = vecs
        if self.quantized:
            payload, qscales = quantize_rows_np(vecs)
        for take, pos, ids, region, scale_arr in (
                (g_take, g_pos, self.row_ids, "grouped", self.cell_scales),
                (s_take, spill_len + np.arange(len(s_take)),
                 self.spill_row_ids, "spill", self.spill_scales)):
            if not len(take):
                continue
            t = np.asarray(take, np.int64)
            p = np.asarray(pos, np.int64)
            ids[p] = phys[t]
            pt = torch.from_numpy(p).to(self.device)
            vec_arr = getattr(self, region)
            vec_arr.index_copy_(0, pt, torch.from_numpy(payload[t]).to(
                self.device).to(vec_arr.dtype))
            if self.quantized:
                scale_arr.index_copy_(
                    0, pt, torch.from_numpy(qscales[t]).to(self.device))
            getattr(self, f"{region}_sq").index_copy_(
                0, pt, torch.from_numpy(sq[t]).to(self.device))
            getattr(self, f"{region}_valid").index_fill_(0, pt, True)
        return True

    def stats(self) -> IVFStats:
        return IVFStats(
            nlist=self.nlist,
            cell_pad=self.cell_pad,
            spill_rows=int(self.spill_valid.sum()),
            grouped_rows=int(self.grouped.shape[0]),
            fill=float(self.grouped_valid.float().mean()),
        )

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.grouped, self.grouped_sq, self.grouped_valid, self.spill,
            self.spill_sq, self.spill_valid, self.centroids,
            self.cell_scales, self.spill_scales) if t is not None)
