"""Bucketed fused scan: the port of tpuvdb/kernels/pallas_scan.py.

`scan_candidates` computes what `pallas_candidates` computes: for each
query and each of `n_buckets` buckets, the best negated partial score
`2*q.x - ||x||^2 + mask` among the rows r with r mod n_buckets == bucket,
and that row; strict `>` in row order, so the lowest row wins a tie. The
bucket of a row is its global row id mod n_buckets, independent of any
tiling (the reference's block_rows / query_tile / sub_rows were VMEM
tiling and are gone, with fit_block_rows and _fit_sub_rows).

On a CUDA tensor it launches the hand-written kernel in
`tpuvdb_torch/csrc/scan.cu` (replacing `pallas_scan._scan_kernel`, the
`pl.pallas_call` at pallas_scan.py:120), built with nvcc for sm_90a into
`tpuvdb_torch/build/` on first use (kernels/cuda_build.py) and bound
with ctypes, or raises. On a
CPU tensor it runs `scan_candidates_plain`, the same function in torch ops.
`LAUNCHES` counts kernel launches. On either device n_buckets must be a
multiple of 128: a kernel block owns 128 buckets.

The kernel runs on the tensor cores: bf16 x bf16 products for bf16 corpora,
3xTF32 for f32 ones (queries split on the card, once a call), fed by TMA, or
by an element-wise copy where the corpus's base or row stride is off 16
bytes (see scan.cu and hopper_mma.cuh). Bound on an H100 SXM at Q=256,
N=1,048,576, d=512: f32 3 * 2*Q*N*d = 8.2e11 tf32 operations = 1.67 ms at
495 TFLOP/s (the rows, 2.1 GB, take 0.64 ms at 3.35 TB/s); bf16 0.27 ms of
operations, 0.32 ms of bytes. At Q=1 the bytes bound it.

`scan_l2sq_topk` is the port of `pallas_l2sq_topk`: the scan plus an exact
torch.topk over the (Q, n_buckets) candidates and `||q||^2 - score`, which
stays torch ops as it stays XLA in the reference.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from tpuvdb_torch.kernels.cuda_build import CudaLibrary
from tpuvdb_torch.kernels.distance import mma_queries, mma_width, queries_like

NEG_INF = float(torch.finfo(torch.float32).min)

LAUNCHES = 0  # kernel launches through scan_candidates on CUDA tensors

BUCKET_BLOCK = 128            # buckets (and rows a step) of one kernel block
MAX_GROUPS_PER_SPLIT = 65535  # a split's group offsets are kept in 16 bits
PLAIN_BLOCK_ROWS = 16384

_sm_counts = {}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tpuvdb_scan_f32, lib.tpuvdb_scan_bf16):
        fn.restype = i
        fn.argtypes = [p] * 10 + [i] * 10 + [p]
    lib.tpuvdb_scan_error.restype = ctypes.c_char_p
    lib.tpuvdb_scan_error.argtypes = [i]


LIBRARY = CudaLibrary("scan.cu", "libtpuvdb_scan.so", _bind,
                      headers=("hopper_mma.cuh", "device_guard.cuh"))


def _splits(nq: int, n: int, n_buckets: int, tile: int,
            dev: torch.device) -> Tuple[int, int]:
    """(n_splits, groups_per_split) of the n_buckets-row groups: about four
    blocks per SM in all, no empty split, a split's group offsets within
    16 bits."""
    if dev.index not in _sm_counts:
        _sm_counts[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    groups = -(-n // n_buckets)
    others = -(-nq // tile) * (n_buckets // BUCKET_BLOCK)
    want = max(1, 4 * _sm_counts[dev.index] // others)
    s = max(1, min(groups, want, 65535),
            -(-groups // MAX_GROUPS_PER_SPLIT))
    gps = -(-groups // s)
    return -(-groups // gps), gps


def scan_candidates(
    queries: torch.Tensor,     # (Q, d) f32
    corpus: torch.Tensor,      # (N, d) f32 or bf16, contiguous
    sqnorms: torch.Tensor,     # (N,) or (1, N) f32
    neg_mask: torch.Tensor,    # (N,) or (1, N) f32: 0 live / NEG_INF dead
    n_buckets: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cand_val f32, cand_idx int32), each (Q, n_buckets): per bucket the
    best negated partial score and its corpus row (-1 if none)."""
    global LAUNCHES
    if n_buckets < BUCKET_BLOCK or n_buckets % BUCKET_BLOCK:
        # a kernel block owns 128 consecutive buckets
        raise ValueError(f"n_buckets={n_buckets}: the scan takes a positive "
                         f"multiple of {BUCKET_BLOCK} buckets")
    sq = sqnorms.reshape(-1)
    mask = neg_mask.reshape(-1)
    if corpus.device.type == "cpu":
        return scan_candidates_plain(queries, corpus, sq, mask, n_buckets)
    dev = corpus.device
    if dev.type != "cuda":
        raise ValueError(f"scan_candidates: unsupported device {dev}")
    for name, t in (("queries", queries), ("sqnorms", sq), ("neg_mask", mask)):
        if t.device != dev:
            raise ValueError(f"scan_candidates: {name} on {t.device}, "
                             f"corpus on {dev}")
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"scan kernel takes float32 or bfloat16 corpora, not {corpus.dtype}")
    if sq.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError("scan_candidates: sqnorms and neg_mask must be float32")
    if not corpus.is_contiguous():
        raise ValueError("scan_candidates: corpus must be contiguous")
    n, d = corpus.shape
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"queries {tuple(queries.shape)} vs corpus dim {d}")
    if sq.shape[0] != n or mask.shape[0] != n:
        raise ValueError("scan_candidates: sqnorms/neg_mask must have N rows")
    if n + n_buckets >= 2 ** 31:
        raise ValueError(f"scan_candidates: {n} rows, the kernel takes "
                         "fewer than 2**31")
    lib = LIBRARY.load()
    # held in names until the launch: a temporary passed as a pointer could
    # be freed, and its memory reused, before the kernel runs
    q, q_hi, q_lo, d_pad = mma_queries(queries, corpus)
    sq = sq.contiguous()
    mask = mask.contiguous()
    nq = q.shape[0]
    out_val = torch.full((nq, n_buckets), NEG_INF, dtype=torch.float32,
                         device=dev)
    out_idx = torch.full((nq, n_buckets), -1, dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:
        return out_val, out_idx
    tile = mma_width(nq)
    n_splits, gps = _splits(nq, n, n_buckets, tile, dev)
    if n_splits > 1:
        part_val = torch.empty((n_splits, nq, n_buckets), dtype=torch.float32,
                               device=dev)
        part_idx = torch.empty((n_splits, nq, n_buckets), dtype=torch.int32,
                               device=dev)
    else:
        part_val, part_idx = out_val, out_idx
    # TMA reads a base and a row stride that are multiples of 16 bytes
    ragged = (corpus.data_ptr() % 16 != 0
              or (d * corpus.element_size()) % 16 != 0)
    f32 = corpus.dtype == torch.float32
    fn = lib.tpuvdb_scan_f32 if f32 else lib.tpuvdb_scan_bf16
    rc = fn(q.data_ptr(), q_hi.data_ptr(), q_lo.data_ptr(),
            corpus.data_ptr(), sq.data_ptr(), mask.data_ptr(),
            part_val.data_ptr(), part_idx.data_ptr(), out_val.data_ptr(),
            out_idx.data_ptr(), nq, d_pad, n, d, n_buckets, tile, n_splits,
            gps, int(ragged), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"scan kernel launch failed: {lib.tpuvdb_scan_error(rc).decode()}")
    LAUNCHES += 1
    return out_val, out_idx


def scan_candidates_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    sqnorms: torch.Tensor,
    neg_mask: torch.Tensor,
    n_buckets: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in torch ops, blockwise over rows: per block of
    rows (a multiple of n_buckets, starting at a multiple of it) the
    scores reshape to (Q, groups, n_buckets); `max` over the groups takes
    the first, i.e. lowest, row on ties, and a strict `>` folds the blocks
    in row order."""
    sq = sqnorms.reshape(-1).to(torch.float32)
    mask = neg_mask.reshape(-1).to(torch.float32)
    q = queries_like(queries, corpus)
    nq, n = q.shape[0], corpus.shape[0]
    dev = corpus.device
    run_val = torch.full((nq, n_buckets), NEG_INF, dtype=torch.float32,
                         device=dev)
    run_idx = torch.full((nq, n_buckets), -1, dtype=torch.int32, device=dev)
    col = torch.arange(n_buckets, dtype=torch.int64, device=dev)
    block = n_buckets * max(1, PLAIN_BLOCK_ROWS // n_buckets)
    for start in range(0, n, block):
        end = min(start + block, n)
        scores = (2.0 * (q @ corpus[start:end].to(torch.float32).T)
                  - sq[start:end] + mask[start:end])
        pad = (-(end - start)) % n_buckets
        if pad:
            scores = F.pad(scores, (0, pad), value=NEG_INF)
        best, group = scores.view(nq, -1, n_buckets).max(dim=1)
        rows = (start + group * n_buckets + col).to(torch.int32)
        better = best > run_val
        run_val = torch.where(better, best, run_val)
        run_idx = torch.where(better, rows, run_idx)
    return run_val, run_idx


def scan_l2sq_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    valid: torch.Tensor,          # (N,) bool
    k: int,
    n_buckets: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full search: the candidate scan + an exact top-k epilogue. Same
    contract as kernels.distance.l2sq_topk (ascending true L2^2; empty
    slots +inf / -1)."""
    neg_mask = torch.zeros(valid.shape, dtype=torch.float32,
                           device=valid.device).masked_fill_(~valid, NEG_INF)
    cand_val, cand_idx = scan_candidates(queries, corpus, corpus_sqnorms,
                                         neg_mask, n_buckets=n_buckets)
    kk = min(k, n_buckets)
    neg, pos = torch.topk(cand_val, kk, dim=1)
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
