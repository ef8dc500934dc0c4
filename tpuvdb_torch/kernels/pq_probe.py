"""IVF-PQ probe: the port of tpuvdb/kernels/pallas_pq.py.

`pq_candidates` replaces pallas_pq._pq_probe_kernel (the `pl.pallas_call` of
pallas_pq_search, pallas_pq.py:299): a hand-written CUDA kernel in
`tpuvdb_torch/csrc/pq_probe.cu` on CUDA tensors (built with nvcc for sm_90a
into `tpuvdb_torch/build/` on first use, bound with ctypes), and the plain
PyTorch twin `pq_candidates_plain` on CPU tensors. For each tile of
`query_tile` queries and each entry of the tile's sorted chunk list, row
r = chunk * 128 + j scores, per query q of the tile,

    sum_m LUT[q, m, code[r, m]]  +  qc2[q, cellof(entry)]  +  bias[r]

and lands in slot segment * 128 + j, which keeps the best score and, on a
tie, the lowest row (-1 and f32-min for an empty slot), as the probes of
kernels/ivf_probe.py do. The LUT comes rounded to bf16 (the reference rounds
it so on both of its routes); the sum starts at +0 and adds the subspaces in
ascending order, then qc2, then bias, every addition in f32 and rounded
once, in the kernel as in the twin: the two agree bit for bit. The TPU body
builds a one-hot of each chunk and contracts it on the MXU because a TPU
cannot gather; the kernel here looks the table up in shared memory, and
none of that form (the one-hot, `m_block`, the `cps` clamp, the lane-mask
column read, the query chunking for SMEM) is carried over. A kernel block
serves `lut_group` queries of a tile from one table staged interleaved
([m][code][query]), so one load gives a code's entries for all of them; a
table that fits in no block's shared memory raises. On a CUDA tensor the
wrapper launches its kernel or raises; `LAUNCHES_PQ` counts launches.

`pq_probe_search` is the port of `pallas_pq_search`: the coarse product in
full f32 (it picks the cells and feeds the distances), the expanded chunk
list with rank segments at every size (the PQ probe has no compact form),
each chunk scored against its own cell's centroid, so over-scanned rows of
the next cell are scored correctly and kept, the spill rows through
`pq.adc_scores` with `spill_cells` giving their centroid term, and a stable
descending sort for the top-k. `coarse_approx` (a TPU partial-reduction
lever) is not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpuvdb_torch.kernels import pq as pqk
from tpuvdb_torch.kernels.cuda_build import CudaLibrary
from tpuvdb_torch.kernels.ivf_probe import (
    CHUNK,
    MAX_QUERY_TILE,
    NEG_INF,
    _check_lists,
    _outputs,
    _plain_fold,
    _splits,
    probe_plan,
)

LAUNCHES_PQ = 0  # pq_candidates kernel launches (CUDA tensors)

SMEM_MAX = 232_448     # bytes of shared memory a block can have (227 KB)
GROUPS = (8, 4, 2, 1)  # queries a block may serve from one staged table
TEAMS = 8              # 128-thread teams a block (4 with groups of 8)
BLOCKS_PER_SM = 8      # blocks the splits aim at, per SM, in all
MIN_TEAM_ENTRIES = 2   # chunks each team walks at least, per staged table


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpuvdb_pq_probe.restype = i
    lib.tpuvdb_pq_probe.argtypes = [p] * 10 + [i] * 14 + [p]
    lib.tpuvdb_pq_error.restype = ctypes.c_char_p
    lib.tpuvdb_pq_error.argtypes = [i]


LIBRARY = CudaLibrary("pq_probe.cu", "libtpuvdb_pq_probe.so", _bind,
                      headers=("probe_common.cuh", "device_guard.cuh"))


def _geometry(name, lut, codes) -> Tuple[int, int]:
    """(subspaces M2, codes per subspace J) of a (Q, M2 * J) LUT over
    (N, Mb) code bytes: J = 256 with M2 = Mb, or J = 16 with M2 = 2 Mb."""
    mb = codes.shape[1]
    if lut.dim() == 2 and lut.shape[1] == mb * 256:
        return mb, 256
    if lut.dim() == 2 and lut.shape[1] == 2 * mb * 16:
        return 2 * mb, 16
    raise ValueError(f"{name}: LUT {tuple(lut.shape)} fits neither "
                     f"{mb} x 256 nor {2 * mb} x 16 entries per query")


def _check_pq(name, lut, qc2, cells, segs, cellof, codes, bias, n_segments,
              query_tile) -> Tuple[int, int]:
    """Raise unless shapes and types are what the kernel and its twin
    take (on either device); returns (M2, J)."""
    _check_lists(name, lut, query_tile, n_segments, cells, segs=segs)
    if cellof.shape != cells.shape:
        raise ValueError(f"{name}: cellof {tuple(cellof.shape)} must have "
                         f"the shape of cells {tuple(cells.shape)}")
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"{name}: codes must be (N, Mb) uint8, not "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if lut.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the LUT must be bfloat16, not {lut.dtype}")
    n = codes.shape[0]
    if n % CHUNK or n >= 2 ** 31:
        raise ValueError(f"{name}: code rows {n} must be a multiple of "
                         f"{CHUNK} below 2**31")
    if bias.dtype != torch.float32 or bias.numel() != n:
        raise ValueError(f"{name}: bias must be {n} float32")
    if (qc2.dtype != torch.float32 or qc2.dim() != 2
            or qc2.shape[0] != lut.shape[0]):
        raise ValueError(f"{name}: qc2 must be ({lut.shape[0]}, nlist) "
                         "float32")
    for t in (cells, segs, cellof):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index arrays must be int32")
    return _geometry(name, lut, codes)


def pq_candidates_plain(lut, qc2, cells, segs, cellof, codes, bias,
                        n_segments: int, query_tile: int):
    """Plain twin of the PQ probe kernel (see pq_candidates): the same
    tensors added in the same order, a loop over the subspaces."""
    m2, n_codes = _check_pq("pq_candidates_plain", lut, qc2, cells, segs,
                            cellof, codes, bias, n_segments, query_tile)
    nlist = qc2.shape[1]
    lut_f = lut.to(torch.float32).reshape(lut.shape[0], m2, n_codes)
    bias_f = bias.reshape(-1)
    # as the kernel: a chunk whose (first) owning cell is out of range
    # scores nothing
    segs = torch.where((cellof >= 0) & (cellof < nlist), segs,
                       torch.full_like(segs, -1))

    def score(lo, hi, rows, cell_of_chunk):
        code = pqk.maybe_unpack(codes[rows], n_codes)       # (R, M2)
        acc = torch.zeros((hi - lo, rows.shape[0]), dtype=torch.float32,
                          device=codes.device)
        for m in range(m2):
            acc = acc + lut_f[lo:hi, m, :][:, code[:, m]]
        cell = cell_of_chunk.repeat_interleave(CHUNK)
        return acc + qc2[lo:hi][:, cell] + bias_f[rows]

    return _plain_fold(score, lut.shape[0], codes, cells, segs, n_segments,
                       query_tile, tile_extra=cellof)


def lut_group(m2: int, n_codes: int, query_tile: int) -> int:
    """Queries a kernel block serves from one staged table: the widest of
    GROUPS whose interleaved table (M2 x J x G bf16) fits in SMEM_MAX, and
    no wider than the smallest power of two that holds the tile. Raises
    where even one query's table does not fit."""
    cap = 1 << (max(1, query_tile) - 1).bit_length()
    for g in GROUPS:
        if g <= cap and m2 * n_codes * g * 2 <= SMEM_MAX:
            return g
    raise ValueError(
        f"pq_candidates: a query's LUT of {m2} x {n_codes} bf16 entries is "
        f"{m2 * n_codes * 2} bytes, more than the {SMEM_MAX} a block can "
        "stage")


def _launch_shape(blocks: int, n_entries: int, dev) -> Tuple[int, int]:
    """(splits, entries_per_block) of each (tile, query group)'s list:
    about BLOCKS_PER_SM blocks an SM in all, and at least MIN_TEAM_ENTRIES
    chunks for each team of a block, so a staged table is used."""
    splits = _splits(blocks, n_entries // (TEAMS * MIN_TEAM_ENTRIES), dev,
                     BLOCKS_PER_SM)
    epb = -(-n_entries // splits)
    return -(-n_entries // epb), epb


def pq_candidates(
    lut: torch.Tensor,     # (Q_pad, M2 * J) bf16; Q_pad % query_tile == 0
    qc2: torch.Tensor,     # (Q_pad, nlist) f32: 2 q . c
    cells: torch.Tensor,   # (tiles, W) int32 chunk ids, sorted per tile
    segs: torch.Tensor,    # (tiles, W) int32 segment of each entry
    cellof: torch.Tensor,  # (tiles, W) int32 owning cell of each entry
    codes: torch.Tensor,   # (n_chunks * 128, Mb) uint8 packed PQ codes
    bias: torch.Tensor,    # (n_chunks * 128,) f32: -||c + r_hat||^2 / NEG_INF
    n_segments: int,
    query_tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ probe: (cand_val f32, cand_idx int32), each
    (Q_pad, 128 * n_segments)."""
    global LAUNCHES_PQ
    if codes.device.type == "cpu":
        return pq_candidates_plain(lut, qc2, cells, segs, cellof, codes,
                                   bias, n_segments, query_tile)
    name = "pq_candidates"
    m2, n_codes = _check_pq(name, lut, qc2, cells, segs, cellof, codes, bias,
                            n_segments, query_tile)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    # held in names until the launch: a temporary passed as a pointer
    # could be freed, and its memory reused, before the kernel runs
    lut_c, qc2_c, bias_c = (lut.contiguous(), qc2.contiguous(),
                            bias.reshape(-1).contiguous())
    cells, segs, cellof = (t.contiguous() for t in (cells, segs, cellof))
    for t in (lut_c, qc2_c, bias_c, cells, segs, cellof):
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device}, codes on {dev}")
    if not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous")
    if lut_c.data_ptr() % 16:
        lut_c = lut_c.clone()  # the kernel stages it 16 bytes at a time
    group = lut_group(m2, n_codes, query_tile)
    tiles, width = cells.shape
    if tiles > 65535:
        raise ValueError(f"{name}: {tiles} tiles, the grid takes 65,535")
    lib = LIBRARY.load()
    keys, val, idx = _outputs(lut_c.shape[0], n_segments, dev)
    if tiles == 0 or width == 0:
        return val.fill_(NEG_INF), idx.fill_(-1)
    splits, epb = _launch_shape(tiles * -(-query_tile // group), width, dev)
    n, mb = codes.shape
    vec = mb % 16 == 0 and codes.data_ptr() % 16 == 0
    rc = lib.tpuvdb_pq_probe(
        lut_c.data_ptr(), qc2_c.data_ptr(), codes.data_ptr(),
        bias_c.data_ptr(), cells.data_ptr(), segs.data_ptr(),
        cellof.data_ptr(), keys.data_ptr(), val.data_ptr(), idx.data_ptr(),
        tiles, query_tile, mb, n_codes, qc2_c.shape[1], width, n // CHUNK,
        n_segments, group, TEAMS, splits, epb, int(vec), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("pq probe kernel launch failed: "
                           f"{lib.tpuvdb_pq_error(rc).decode()}")
    LAUNCHES_PQ += 1
    return val, idx


def pq_probe_inputs(queries, centroids, codebooks, grouped_valid, grouped_sq,
                    cell_offsets, cell_pad: int, k: int, nprobe: int,
                    n_rows: int, rotation=None,
                    query_tile: int = MAX_QUERY_TILE):
    """What pallas_pq_search hands its kernel, for `pq_candidates`:
    (plan, lut bf16 (Q_pad, M2 * J), cellof, bias)."""
    plan = probe_plan(queries, centroids, cell_offsets, cell_pad, k, nprobe,
                      query_tile, expanded_chunks=n_rows // CHUNK)
    # chunk -> owning cell: starts ascend and are 128-aligned, so the owner
    # is unique
    cellof = (torch.searchsorted(plan.off128, plan.cells, right=True)
              - 1).to(torch.int32)
    lut = pqk.pq_lut(plan.queries, codebooks, rotation)     # (Q_pad, M2, J)
    lut = lut.reshape(lut.shape[0], -1).to(torch.bfloat16)
    # -||c + r_hat||^2, f32-min on a dead row
    bias = torch.where(grouped_valid, -grouped_sq.to(torch.float32),
                       torch.full_like(grouped_sq, NEG_INF,
                                       dtype=torch.float32))
    return plan, lut, cellof, bias


def pq_probe_search(
    queries: torch.Tensor,        # (Q, d) f32
    centroids: torch.Tensor,      # (nlist, d) f32
    grouped_codes: torch.Tensor,  # (N_g, Mb) uint8 packed PQ codes
    codebooks: torch.Tensor,      # (M2, J, dsub) f32
    grouped_sq: torch.Tensor,     # (N_g,) f32 = ||c + r_hat||^2
    grouped_valid: torch.Tensor,  # (N_g,) bool
    spill_codes: torch.Tensor,    # (S, Mb) uint8
    spill_cells: torch.Tensor,    # (S,) int owning cell per spill row
    spill_sq: torch.Tensor,       # (S,) f32
    spill_valid: torch.Tensor,    # (S,) bool
    cell_offsets: torch.Tensor,   # (nlist,) packed 128-aligned starts
    cell_pad: int,                # scan window (rows), multiple of 128
    k: int,
    nprobe: int,
    rotation: Optional[torch.Tensor] = None,
    query_tile: int = MAX_QUERY_TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full IVF-PQ probe: (dist, grouped_row), each (Q, k), spill row j at
    id N_g + j; ascending squared L2 to the reconstruction in f32 (the
    engine's exact re-rank restores the true order); empty slots +inf /
    -1."""
    qn = queries.shape[0]
    n_g = grouped_codes.shape[0]
    nlist = centroids.shape[0]
    plan, lut, cellof, bias = pq_probe_inputs(
        queries, centroids, codebooks, grouped_valid, grouped_sq,
        cell_offsets, cell_pad, k, min(nprobe, nlist), n_g, rotation,
        query_tile)
    cand_val, cand_idx = pq_candidates(
        lut, plan.qc2, plan.cells, plan.segs, cellof, grouped_codes, bias,
        plan.n_segments, plan.query_tile)
    cand_val, cand_idx = cand_val[:qn], cand_idx[:qn]
    s_n = spill_codes.shape[0]
    if s_n > 0:
        m2, n_codes = codebooks.shape[0], codebooks.shape[1]
        lut3 = lut[:qn].to(torch.float32).reshape(qn, m2, n_codes)
        sdots = pqk.adc_scores(lut3, spill_codes)           # (Q, S)
        qc_spill = plan.qc2[:qn][:, spill_cells.long().clamp(0, nlist - 1)]
        sneg = qc_spill + sdots - spill_sq[None, :]
        sneg = torch.where(spill_valid[None, :], sneg,
                           torch.full_like(sneg, NEG_INF))
        sids = n_g + torch.arange(s_n, dtype=torch.int32,
                                  device=grouped_codes.device)
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
