"""IVF index: the port of tpuvdb/index/ivf.py (f32, bf16, int8 and PQ
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

PQ cells (IVF-PQ, `pq_subq > 0`). A cell row is `pq_subq` code bytes of the
residual x - c_cell (kernels/pq.py: 8-bit codes, or two 4-bit codes a byte
with `pq_bits=4`; under `opq` the residual is rotated first), and
`grouped_sq` holds the reconstruction's ||c + r_hat||^2. The codebooks
train on the k-means sample's residuals, every row is encoded in the
assignment pass into a code table that stays on the device (packing is a
device gather), rows whose cell was bisected are encoded again against the
final centroids, and the scan window is clamped to `pq_max_cell` rows.
Search runs `kernels/pq_probe.pq_probe_search` (the hand-written ADC kernel
on the card, its plain twin on the CPU); spill rows remember their cell
(`spill_cells`) for the centroid term. The reference's CPU route
`_ivf_search_pq` is not ported: it masks over-scanned rows where the kernel
scores them against their own cell, and the port follows the kernel. The
reference shapes its build around a slow host link (an int16 assignment
fetch, padded fixed-shape blocks); only the device-resident code table is
kept.

Packed state (`packed_capture`, `packed_fetch`, `from_packed`): the whole
device image for a checkpoint, so a restart uploads it instead of encoding
every row again. The reference captures immutable device arrays by
reference; the port writes in place, so `packed_capture` records `version`
with references to the tensors (no clone under the engine's lock) and
`packed_fetch`, off the lock, copies them to the host and raises if
`version` moved meanwhile: the caller then skips the packed file.

The mesh-sharded index (mesh/sharded_ivf.py) holds one IVFIndex a slot and
calls its `probe`, the device half of `search`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpuvdb_torch.device import resolve_device
from tpuvdb_torch.kernels import pq as pqk
from tpuvdb_torch.kernels.ivf_probe import ivf_probe_search
from tpuvdb_torch.kernels.kmeans import assign_blockwise, kmeans
from tpuvdb_torch.kernels.pq_probe import pq_probe_search
from tpuvdb_torch.kernels.quant import quantize_rows_np
from tpuvdb_torch.utils.hostmem import memlog
from tpuvdb_torch.utils.tracing import span, stage

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_ASSIGN_CHUNK = 16384
_ENCODE_ROWS = 262_144  # rows gathered at once for a re-encode


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

    def stack_f32(self) -> np.ndarray:
        """The whole (n, d) f32 row space (unwritten rows zero): what a
        mesh build takes, as the reference's `layout.stack`."""
        out = np.zeros((self.n, self.dim), np.float32)
        for r0, blk in self.iter_blocks_f32(262_144):
            out[r0:r0 + len(blk)] = blk
        return out

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
                           positions, int8_out: bool, chunk: int = 1_000_000,
                           pq_tables=None):
    """Copy `phys_rows` from the source into vec/scale/sq at `positions`,
    chunked so the f32 transient stays bounded. int8 output takes the
    bit-exact raw path when the source stores int8; otherwise it gathers
    f32 and quantizes per chunk. sq is the f32 row's (the stored norm on
    the raw path). PQ rows come from `pq_tables`, the (codes, recon_sq)
    device tables of the assignment pass indexed by physical row: residual
    codes are tied to their cell, so nothing is encoded here."""
    if pq_tables is not None:
        codes_all, rsq_all = pq_tables
        sel = torch.from_numpy(
            np.asarray(phys_rows, np.int64).clip(min=0)).to(codes_all.device)
        vec_out[positions] = codes_all[sel].cpu().numpy()
        sq_out[positions] = rsq_all[sel].cpu().numpy()
        return
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
                            int8_out: bool, pq_tables=None):
    """pack_cells over a row source, rows copied straight into the target
    dtype. Returns (gvec, gscales|None, gsq, gval, grow, offsets, sizes,
    spill_rows); padding rows of an int8 cell keep scale 1.0. With
    `pq_tables` (device code table and norms by physical row) the packing
    is one device gather driven by a host permutation, and gvec / gsq come
    back as device tensors; a padding row then carries row 0's codes and a
    zero norm, as in the reference, and is masked by its validity."""
    rows_sorted, gpos, main, offsets, kept, grouped_rows = _cell_layout(
        rows, assign_live, nlist, window)
    gscales = np.ones(grouped_rows, np.float32) if int8_out else None
    gval = np.zeros(grouped_rows, bool)
    grow = np.full(grouped_rows, -1, np.int64)
    gval[gpos] = True
    grow[gpos] = rows_sorted[main]
    if pq_tables is not None:
        codes_all, rsq_all = pq_tables
        perm = np.zeros(grouped_rows, np.int64)
        perm[gpos] = rows_sorted[main]
        perm_t = torch.from_numpy(perm).to(codes_all.device)
        gvec = codes_all[perm_t]
        gsq = torch.where(torch.from_numpy(gval).to(codes_all.device),
                          rsq_all[perm_t], torch.zeros_like(rsq_all[:1]))
    else:
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
        pq_codebooks: Optional[np.ndarray] = None,    # (M2, J, d / M2) f32
        spill_cells: Optional[np.ndarray] = None,     # (S,) residual cells
        pq_rotation: Optional[np.ndarray] = None,     # (d, d) OPQ rotation
        pq_err: float = 0.0,  # calibrated ||x - x_hat|| quantile (adaptive
                              # rescore bound; 0 = uncalibrated: full window)
    ):
        self.device = grouped.device
        self.pq = pq_codebooks is not None
        if self.pq:
            if grouped.dtype != torch.uint8 or spill.dtype != torch.uint8:
                raise ValueError("PQ cells hold uint8 codes, not "
                                 f"{grouped.dtype} / {spill.dtype}")
            if cell_scales is not None or spill_scales is not None:
                raise ValueError("PQ cells take no int8 scales")
        else:
            _check_dtype(grouped.dtype)
        self._pq_codebooks_np = self._pq_rotation_np = None
        self.pq_codebooks = self.pq_rotation = self.spill_cells = None
        self.pq_err = float(pq_err) if self.pq else 0.0
        if self.pq:
            self._pq_codebooks_np = np.array(pq_codebooks, np.float32)
            self.pq_codebooks = torch.from_numpy(self._pq_codebooks_np).to(
                self.device)
            if pqk.pq_code_bytes(self._pq_codebooks_np) != grouped.shape[1]:
                raise ValueError(
                    f"codebooks {self._pq_codebooks_np.shape} do not code "
                    f"rows of {grouped.shape[1]} bytes")
            if pq_rotation is not None:
                self._pq_rotation_np = np.array(pq_rotation, np.float32)
                self.pq_rotation = torch.from_numpy(
                    self._pq_rotation_np).to(self.device)
            if spill_cells is None:
                spill_cells = np.zeros(int(spill.shape[0]), np.int32)
            self.spill_cells = torch.from_numpy(
                np.array(spill_cells, np.int32)).to(self.device)
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

    def pq_codebooks_np(self) -> Optional[np.ndarray]:
        return self._pq_codebooks_np

    def pq_rotation_np(self) -> Optional[np.ndarray]:
        return self._pq_rotation_np

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
        pq_codebooks: Optional[np.ndarray] = None,  # PQ cells only
        spill_cells: Optional[np.ndarray] = None,
        pq_rotation: Optional[np.ndarray] = None,
        pq_err: float = 0.0,
    ) -> "IVFIndex":
        """An index holding given arrays, e.g. a JAX IVFIndex's
        (np.asarray of each field): the same cells, the same probes. int8
        cells come as int8 codes with both scale arrays; PQ cells as uint8
        codes with their codebooks (then `dtype` is not read)."""
        dev = resolve_device(device)

        def put(a, dt):
            return torch.from_numpy(np.array(a)).to(dev).to(dt)

        if pq_codebooks is not None:
            if (np.asarray(grouped).dtype != np.uint8
                    or np.asarray(spill).dtype != np.uint8):
                raise ValueError("PQ cells take uint8 codes")
            dtype = torch.uint8
        quant = dtype == torch.int8
        if quant and (np.asarray(grouped).dtype != np.int8
                      or np.asarray(spill).dtype != np.int8
                      or cell_scales is None or spill_scales is None):
            raise ValueError("int8 cells take int8 codes and both scale "
                             "arrays")

        def rows(a):
            raw = quant or pq_codebooks is not None
            return put(a if raw else np.asarray(a, np.float32), dtype)

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
            pq_codebooks=pq_codebooks,
            spill_cells=spill_cells,
            pq_rotation=pq_rotation,
            pq_err=pq_err,
        )

    # ----------------------------------------------------------- packed state

    _PACKED_DEVICE = ("grouped", "grouped_sq", "grouped_valid", "spill",
                      "spill_sq", "spill_valid", "cell_scales",
                      "spill_scales", "spill_cells")

    def packed_capture(self) -> dict:
        """Snapshot of the whole packed state for a checkpoint; call under
        the owning engine's lock. The host maps are copied; the device
        tensors are captured by reference with the `version` they had (no
        clone: the code table is the corpus's codes), and `packed_fetch`
        finds out whether an in-place write got between."""
        cap = {
            "centroids": self._centroids_np.copy(),
            "cell_offsets": self.cell_offsets_np.copy(),
            "cell_lens": self.cell_lens.copy(),
            "cell_pad": np.int64(self.cell_pad),
            "nprobe": np.int64(self.nprobe),
            "row_ids": self.row_ids.copy(),
            "spill_row_ids": self.spill_row_ids.copy(),
            "_dev": {name: getattr(self, name)
                     for name in self._PACKED_DEVICE
                     if getattr(self, name) is not None},
            "_index": self,
            "_version": self.version,
        }
        if self.pq:
            cap["pq_codebooks"] = self._pq_codebooks_np.copy()
            cap["pq_err"] = np.float64(self.pq_err)
        if self._pq_rotation_np is not None:
            cap["pq_rotation"] = self._pq_rotation_np.copy()
        return cap

    @staticmethod
    def packed_fetch(cap: dict) -> dict:
        """Copy the captured device tensors to the host, off the engine's
        lock. Raises if an append or a delete wrote the index in place
        since the capture: the copy may then mix two states."""
        out = {k: v for k, v in cap.items() if not k.startswith("_")}
        for k, t in cap["_dev"].items():
            out[k] = t.cpu().numpy()
        if cap["_index"].version != cap["_version"]:
            raise RuntimeError("the index was written in place while its "
                               "packed state was fetched")
        return out

    @classmethod
    def from_packed(cls, st, device=None) -> "IVFIndex":
        """Rebuild from a packed-state mapping (np.load of a checkpoint's
        ivf_packed.npz, from either package): one upload, no assignment and
        no encode."""
        dev = resolve_device(device)

        def opt(key):
            return np.asarray(st[key]) if key in st else None

        def put(key):
            a = opt(key)
            return None if a is None else torch.from_numpy(
                np.array(a)).to(dev)

        cb, rot = opt("pq_codebooks"), opt("pq_rotation")
        return cls(
            centroids=np.asarray(st["centroids"], np.float32),
            grouped=put("grouped"),
            grouped_sq=put("grouped_sq"),
            grouped_valid=put("grouped_valid"),
            row_ids=np.asarray(st["row_ids"]),
            spill=put("spill"),
            spill_sq=put("spill_sq"),
            spill_valid=put("spill_valid"),
            spill_row_ids=np.asarray(st["spill_row_ids"]),
            cell_pad=int(st["cell_pad"]),
            cell_offsets=np.asarray(st["cell_offsets"]),
            cell_lens=np.asarray(st["cell_lens"]),
            nprobe=int(st["nprobe"]),
            cell_scales=put("cell_scales"),
            spill_scales=put("spill_scales"),
            pq_codebooks=cb,
            spill_cells=opt("spill_cells"),
            pq_rotation=rot,
            pq_err=float(st["pq_err"]) if "pq_err" in st else 0.0,
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
        pq_subq: int = 0,                          # 0 = off; else IVF-PQ
        pq_codebooks: Optional[np.ndarray] = None,  # warm-start codebooks
        pq_max_cell: int = 2048,                   # PQ scan-window clamp
        opq: bool = False,                         # learned OPQ rotation
        pq_rotation: Optional[np.ndarray] = None,  # warm-start rotation
        pq_bits: int = 8,                          # 8 | 4 (two codes a byte)
        pq_err: float = 0.0,                       # warm-start calibration
    ) -> "IVFIndex":
        """Train (or reuse) the centroids on a sample, assign every row in
        blocks on the device, bound the largest cell by bisection, pack the
        cells and upload them. The cell window tracks 1.25x the median cell
        with split_oversized (default); cell_cap_quantile applies to the
        no-split path. With `pq_subq` the cells hold PQ codes (see the
        module docstring); warm codebooks, rotation and calibration are
        reused unless their shape or tier went stale."""
        dev = resolve_device(device)
        n, d = source.n, source.dim
        live_idx = np.flatnonzero(valid)
        if len(live_idx) == 0:
            raise ValueError("cannot build IVF over empty corpus")
        memlog("build: start")
        with stage("build.train"):
            if pq_codebooks is not None and not pq_subq:
                pq_subq = pqk.pq_code_bytes(pq_codebooks)
            if pq_subq:
                if pq_bits not in (8, 4):
                    raise ValueError(f"pq_bits={pq_bits} must be 8 or 4")
                # pq_subq stays bytes/row in both tiers; 4-bit runs 2 * subq
                # half-width subspaces of 16 codes packed two per byte
                pq_m = pq_subq if pq_bits == 8 else 2 * pq_subq
                pq_j = 256 if pq_bits == 8 else 16
                if d % pq_m != 0:
                    raise ValueError(
                        f"pq_subq={pq_subq} at pq_bits={pq_bits} needs "
                        f"{pq_m} subspaces to divide dim={d}")
                if dtype == torch.int8:
                    raise ValueError("pq_subq and int8 cells are exclusive: "
                                     "PQ already compresses below int8")
                if (pq_codebooks is not None
                        and pq_codebooks.shape != (pq_m, pq_j, d // pq_m)):
                    pq_codebooks = None  # stale warm shape or tier: retrain
                if pq_rotation is not None and pq_rotation.shape != (d, d):
                    pq_rotation = None
                    pq_codebooks = None  # codebooks are tied to their rotation
                if opq and pq_codebooks is not None and pq_rotation is None:
                    # warm codebooks trained without a rotation cannot pair
                    # with OPQ coding: retrain the pair together
                    pq_codebooks = None
                if not opq:
                    pq_rotation = None  # a rotation only means something there
            else:
                _check_dtype(dtype)  # before any training
                pq_rotation = None
            rng = np.random.default_rng(seed)

            # 1. coarse quantizer: k-means on a sample, or caller-provided
            # centroids (checkpoint warm start: assignment only). The PQ
            # codebooks train on the same sample.
            warm_cents = centroids is not None and centroids.shape[1] == d
            need_cb = bool(pq_subq) and pq_codebooks is None
            sample = None
            if not warm_cents or need_cb:
                if len(live_idx) > train_sample:
                    tr = np.sort(rng.choice(live_idx, size=train_sample,
                                            replace=False))
                else:
                    tr = live_idx
                sample = source.gather_f32(tr)
            if warm_cents:
                centroids = np.array(centroids, np.float32)  # own, writable
                nlist = len(centroids)
            else:
                centroids, _ = kmeans(sample,
                                      np.ones(sample.shape[0], bool),
                                      nlist=nlist, iters=kmeans_iters,
                                      seed=seed, device=dev)
            cents_t = torch.from_numpy(centroids).to(dev)
            if need_cb:
                # residual codebooks: train on x - c_assign, so the codes model
                # the structure inside a cell (the coarse quantizer already
                # owns which cell a row is in)
                sa = assign_blockwise(torch.from_numpy(sample).to(dev),
                                      cents_t, block_size=4096).cpu().numpy()
                residuals = sample - centroids[sa]
                if opq:
                    pq_codebooks, pq_rotation = pqk.train_opq(
                        residuals, m_subq=pq_m, seed=seed, n_codes=pq_j,
                        device=dev)
                else:
                    pq_codebooks = pqk.train_pq(residuals, m_subq=pq_m,
                                                seed=seed, n_codes=pq_j,
                                                device=dev)
                # the adaptive-rescore error bound, calibrated on the sample
                # the codebooks trained on and checkpointed with them
                pq_err = pqk.calibrate_pq_err(residuals, pq_codebooks,
                                              rotation=pq_rotation, seed=seed)
                del residuals
            del sample
            memlog("build: trained (cents+codebooks)")

        with stage("build.assign"):
            # 2. assign every row, streamed in blocks; invalid rows -> -1. PQ
            # rows are encoded in the same pass, from the same uploaded block,
            # into a code table that stays on the device
            pq_tables = cb_t = rot_t = None
            if pq_codebooks is not None:
                cb_t = torch.from_numpy(
                    np.ascontiguousarray(pq_codebooks, np.float32)).to(dev)
                rot_t = (torch.from_numpy(np.ascontiguousarray(
                    pq_rotation, np.float32)).to(dev)
                    if pq_rotation is not None else None)
                pq_tables = (
                    torch.zeros((n, pq_subq), dtype=torch.uint8, device=dev),
                    torch.zeros(n, dtype=torch.float32, device=dev))
            assign = np.full(n, -1, np.int32)
            for g0, blk in source.iter_blocks_f32(262_144):
                blk_t = torch.from_numpy(blk).to(dev)
                a = assign_blockwise(blk_t, cents_t)
                assign[g0:g0 + len(blk)] = a.cpu().numpy()
                if pq_tables is not None:
                    codes, rsq = pqk.encode_residual(blk_t, a, cents_t, cb_t,
                                                     rot_t)
                    pq_tables[0][g0:g0 + len(blk)] = codes
                    pq_tables[1][g0:g0 + len(blk)] = rsq
            assign = np.where(valid, assign, -1)
            memlog("build: assigned+encoded")

        with stage("build.split"):
            # 3. skew control: bound the max cell, then pack
            sizes = np.bincount(assign[assign >= 0], minlength=nlist)
            live_sizes = sizes[sizes > 0]
            if split_oversized and nlist > 1 and len(live_sizes):
                # window ~ 1.25x the median cell; bisect anything bigger
                cap = int(np.quantile(live_sizes, 0.5) * 1.25)
                if pq_tables is not None:
                    # ADC cost is per candidate (nprobe * window), not per
                    # byte: a clamped window bisects a huge corpus at a modest
                    # nlist into more cells instead of widening every probe
                    cap = min(cap, pq_max_cell)
                cell_pad = max(_round_up(max(cap, 1), 128), 128)
                old_cents = centroids
                centroids, assign = split_oversized_cells(
                    source.gather_f32, assign, centroids, cell_pad, seed=seed)
                nlist = len(centroids)
                if pq_tables is not None and nlist > len(old_cents):
                    # residual codes are tied to their cell's centroid: rows
                    # whose cell was bisected (parent replaced, child appended)
                    # are encoded again against the final centroids and
                    # scattered into the table
                    changed = np.ones(nlist, bool)
                    changed[:len(old_cents)] = np.any(
                        old_cents != centroids[:len(old_cents)], axis=1)
                    rows_re = np.flatnonzero(
                        (assign >= 0) & changed[np.maximum(assign, 0)])
                    cents_t = torch.from_numpy(centroids).to(dev)
                    for lo in range(0, len(rows_re), _ENCODE_ROWS):
                        rr = rows_re[lo:lo + _ENCODE_ROWS]
                        codes, rsq = pqk.encode_residual(
                            torch.from_numpy(source.gather_f32(rr)).to(dev),
                            torch.from_numpy(assign[rr]).to(dev), cents_t,
                            cb_t, rot_t)
                        rr_t = torch.from_numpy(rr).to(dev)
                        pq_tables[0].index_copy_(0, rr_t, codes)
                        pq_tables[1].index_copy_(0, rr_t, rsq)
            else:
                cap = (int(np.quantile(sizes, cell_cap_quantile))
                       if nlist > 1 else int(sizes.max()))
                cell_pad = max(_round_up(max(cap, 1), 128), 128)

            memlog("build: split done")
        with stage("build.pack"):
            live2 = np.flatnonzero(valid & (assign >= 0))
            int8_out = dtype == torch.int8
            pq = pq_tables is not None
            (gvec, gscales, gsq, gval, grow, cell_offsets, cell_lens,
             spill_rows) = _pack_cells_from_source(
                source, live2, assign[live2], nlist, cell_pad, int8_out,
                pq_tables=pq_tables)

            memlog("build: packed")
        with stage("build.upload"):
            # spill reserve: free capacity so append_rows can overflow full
            # cells here instead of forcing a rebuild
            reserve = min(8192, max(128, n // 8))
            s = max(len(spill_rows), 1)
            s_pad = _round_up(s + reserve, 128)
            s_width, s_dtype = ((pq_subq, np.uint8) if pq else
                                (d, np.int8 if int8_out else np.float32))
            svec = np.zeros((s_pad, s_width), s_dtype)
            sscales = np.ones(s_pad, np.float32) if int8_out else None
            ssq = np.zeros(s_pad, np.float32)
            sval = np.zeros(s_pad, bool)
            srow = np.full(s_pad, -1, np.int64)
            scell = np.zeros(s_pad, np.int32)  # residual PQ: its cell
            ns = len(spill_rows)
            if ns:
                _fill_rows_from_source(source, spill_rows, svec, sscales, ssq,
                                       np.arange(ns), int8_out,
                                       pq_tables=pq_tables)
                sval[:ns] = True
                srow[:ns] = spill_rows
                scell[:ns] = assign[spill_rows]

            def put(a, dt=None):
                if isinstance(a, torch.Tensor):  # PQ cells, on the device
                    return a
                t = torch.from_numpy(a).to(dev)
                return t if dt is None else t.to(dt)

            if pq:
                dtype = torch.uint8
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
                pq_codebooks=pq_codebooks,
                spill_cells=scell if pq else None,
                pq_rotation=pq_rotation,
                pq_err=pq_err if pq else 0.0,
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

    def probe(self, q: torch.Tensor, k: int, nprobe: Optional[int] = None,
              valid_override=None, force_compact: bool = False):
        """The probe of a query tensor on this index's device, no host
        read: (dist, grouped id), each (Q, k) on the device; spill row j
        has id N_g + j."""
        nprobe = min(nprobe or self.nprobe, self.nlist)
        gval, sval = (valid_override if valid_override is not None
                      else (self.grouped_valid, self.spill_valid))
        if self.pq:
            if force_compact:
                raise ValueError("the PQ probe has one form, the expanded "
                                 "list: force_compact does not apply")
            with span("index.launch"):
                return pq_probe_search(
                    q, self.centroids, self.grouped, self.pq_codebooks,
                    self.grouped_sq, gval, self.spill, self.spill_cells,
                    self.spill_sq, sval, self.cell_offsets,
                    cell_pad=self.cell_pad, k=k, nprobe=nprobe,
                    rotation=self.pq_rotation)
        return ivf_probe_search(
            q, self.centroids, self.grouped, self.grouped_sq, gval,
            self.cell_offsets, cell_pad=self.cell_pad, k=k,
            nprobe=nprobe, spill=self.spill, spill_sq=self.spill_sq,
            spill_valid=sval, force_compact=force_compact,
            cell_scales=self.cell_scales, spill_scales=self.spill_scales)

    def search(
        self, queries: np.ndarray, k: int, nprobe: Optional[int] = None,
        valid_override=None, force_compact: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists, physical_rows) as numpy, dists ascending squared
        L2 in f32; -1 rows for empty slots. The whole batch is one probe.
        valid_override: (grouped_valid, spill_valid) from masked_valid().
        The reference's `out_w` (a cut to the width the engine consumes,
        with bf16 distances for its relay) is not carried over: the port's
        engine asks for exactly that width, and distances stay f32. Spans:
        index.upload, the probe's (index.plan, index.launch), index.wait,
        index.row_map."""
        with span("index.upload"):
            q = torch.from_numpy(
                np.ascontiguousarray(queries, np.float32)).to(self.device)
        dist, gid = self.probe(q, k, nprobe, valid_override, force_compact)
        with span("index.wait"):
            gid = gid.cpu()
            dist = dist.cpu()
        with span("index.row_map"):
            gid = gid.numpy()
            dist = dist.numpy()
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
        if self.pq:
            # residual encode against each row's assigned cell; sq is the
            # full reconstruction's ||c + r_hat||^2
            payload, sq = pqk.encode_pq_residual_chunked(
                vecs, assign, self.centroids, self.pq_codebooks,
                chunk=_ASSIGN_CHUNK, rotation=self.pq_rotation)
        else:
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
            if self.pq and region == "spill":
                # the cell a spill row's residual was coded against
                self.spill_cells.index_copy_(
                    0, pt, torch.from_numpy(assign[t]).to(self.device))
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
            self.cell_scales, self.spill_scales, self.pq_codebooks,
            self.pq_rotation, self.spill_cells) if t is not None)
