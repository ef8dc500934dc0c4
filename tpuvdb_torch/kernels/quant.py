"""Int8 symmetric quantization for corpus storage (torch port of
tpuvdb.kernels.quant).

  corpus row x  ->  x_int8 = round(x / s_r),  s_r = max|x| / 127  (per row)
  query batch q ->  q_int8 = round(q / s_q),  s_q = max|Q| / 127  (per batch)

One batch-global query scale keeps the score expression
  2 * s_q * s_r * (q_int8 . x_int8) - ||x||^2
free of per-query outer products. Squared norms are kept in f32 from the
original vectors, so the norm term is exact and only the dot is quantized.
The query scale is one number for the whole batch: a batch and a slice of
it quantize differently.

The flat int8 scan has no Pallas kernel in the reference (it is XLA there),
so it is torch ops here. The int32 dots are exact: `torch._int_mm` (int8 x
int8 -> int32), never a float matmul. On CUDA `_int_mm` refuses a first
operand of 16 rows or fewer and inner or output widths off a multiple of 8;
`int8_dots` pads to what it takes and cuts the result, so the answer is that
of the unpadded product. Rounding is half-to-even, as in `jnp.round` and
`np.round`, and codes and scales are bit-equal to the reference's on the
CPU. That takes two forms of the scale: the reference's host function
divides by 127, and XLA compiles the `absmax / 127.0` of its jitted
functions (`quantize_batch`, the quantizing scatter) into a multiplication
by the f32 reciprocal, which differs in the last bit for about 1 value in
20. `quantize_rows_np` divides; `quantize_batch` and `quantize_rows`
multiply. The reference's `approx_max_k` becomes `torch.topk`, exact on every
device, so `recall_target` has no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuvdb_torch.kernels import topk as tk

_INV_127 = float(np.float32(1.0) / np.float32(127.0))
_INT_MM_MIN_ROWS = 17   # CUDA _int_mm: first operand needs more than 16 rows
_RESCORE_GATHER_BYTES = 1 << 28  # (Q, F, d) f32 rows gathered at once


def quantize_rows_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row int8 quantization (host path, used at index build)."""
    x = np.asarray(x, np.float32)
    absmax = np.max(np.abs(x), axis=-1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(x / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization on a device tensor, with the arithmetic
    of the reference's quantizing scatter (`_scatter_update_int8`)."""
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax * _INV_127,
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(
        torch.int8)
    return q, scales


def quantize_batch(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-global int8 quantization for queries: (q_int8, scale (1, 1))."""
    q = q.to(torch.float32)
    absmax = q.abs().max()
    scale = torch.where(absmax > 0, absmax * _INV_127,
                        torch.ones_like(absmax))
    qi = torch.clamp(torch.round(q / scale), -127, 127).to(torch.int8)
    return qi, scale.reshape(1, 1)


def int8_dots(qi: torch.Tensor, rows_i8: torch.Tensor) -> torch.Tensor:
    """(Q, B) int32 dots of int8 queries (Q, d) with int8 rows (B, d),
    exact. Pads to the shapes CUDA's `_int_mm` takes (zero rows and columns
    add nothing to a dot) and cuts the result back."""
    qn, d = qi.shape
    bn = rows_i8.shape[0]
    pad_q = max(_INT_MM_MIN_ROWS - qn, 0)
    pad_d = (-d) % 8
    pad_b = (-bn) % 8
    if pad_q or pad_d:
        qi = F.pad(qi, (0, pad_d, 0, pad_q))
    if pad_b or pad_d:
        rows_i8 = F.pad(rows_i8, (0, pad_d, 0, pad_b))
    # the (d, B) operand as the transpose of row-major rows: the layout
    # the CUDA int8 GEMM takes
    return torch._int_mm(qi.contiguous(), rows_i8.contiguous().T)[:qn, :bn]


def _int8_scores(qi, qscale, rows_i8, row_scales, sqnorms):
    """(Q, B) f32 scores in the reference's order: ((2 s_q) s_r) dot - sq."""
    dots = int8_dots(qi, rows_i8).to(torch.float32)
    return 2.0 * qscale * row_scales[None, :] * dots - sqnorms[None, :]


def l2sq_topk_int8(
    queries: torch.Tensor,         # (Q, d) f32
    corpus_i8: torch.Tensor,       # (N, d) int8
    row_scales: torch.Tensor,      # (N,) f32
    corpus_sqnorms: torch.Tensor,  # (N,) f32 (exact, from original vectors)
    valid: torch.Tensor,           # (N,) bool
    k: int,
    block_size: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 scan (the port of l2sq_topk_int8_xla): exact int32 dots, exact
    norm correction, exact top-k. Works in corpus blocks with a running
    top-k, so no (Q, N) array exists. Returns (dist, idx), each (Q, k);
    empty slots +inf / -1."""
    if corpus_i8.dtype != torch.int8:
        raise ValueError(f"l2sq_topk_int8 takes int8 rows, not "
                         f"{corpus_i8.dtype}")
    queries = queries.to(torch.float32)
    qi, qscale = quantize_batch(queries)
    n = corpus_i8.shape[0]
    neg, idx = tk.empty_topk(queries.shape[0], k, device=corpus_i8.device)
    for start in range(0, n, block_size):
        end = min(start + block_size, n)
        scores = _int8_scores(qi, qscale, corpus_i8[start:end],
                              row_scales[start:end],
                              corpus_sqnorms[start:end])
        scores = tk.mask_scores(scores, valid[None, start:end])
        gidx = torch.arange(start, end, dtype=torch.int32,
                            device=corpus_i8.device).expand(
                                scores.shape[0], -1)
        neg, idx = tk.merge_topk(neg, idx, scores, gidx, k)
    idx = torch.where(neg == float("-inf"), torch.full_like(idx, -1), idx)
    q_sq = (queries * queries).sum(dim=-1, keepdim=True)
    dist = torch.where(idx >= 0, q_sq - neg,
                       torch.full_like(neg, float("inf")))
    return dist, idx


def exact_rescore(
    queries: torch.Tensor,     # (Q, d) f32, unquantized
    corpus_i8: torch.Tensor,   # (N, d) int8
    row_scales: torch.Tensor,  # (N,) f32
    cand: torch.Tensor,        # (Q, F) int32 candidate rows, -1 = empty
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of int8 candidate rows on the device: gathers the rows
    (1 byte/dim), dequantizes, and re-ranks by the f32 distance to the
    unquantized query; only per-row corpus quantization error remains. The
    (Q, F, d) f32 gather runs in blocks of queries."""
    queries = queries.to(torch.float32)
    qn, d = queries.shape
    f = cand.shape[1]
    dist = torch.empty((qn, f), dtype=torch.float32, device=cand.device)
    safe = cand.clamp(min=0).long()
    q_block = max(1, _RESCORE_GATHER_BYTES // max(f * d * 4, 1))
    for lo in range(0, qn, q_block):
        s = safe[lo:lo + q_block]
        rows = corpus_i8[s].to(torch.float32) * row_scales[s][..., None]
        diff = queries[lo:lo + q_block, None, :] - rows
        dist[lo:lo + q_block] = (diff * diff).sum(dim=-1)
    dist = torch.where(cand >= 0, dist, torch.full_like(dist, float("inf")))
    # a stable sort: equal distances keep candidate order, as lax.top_k
    dist, pos = torch.sort(dist, dim=1, stable=True)
    kk = min(k, f)
    dist, idx = dist[:, :kk], torch.gather(cand, 1, pos[:, :kk])
    idx = torch.where(torch.isfinite(dist), idx, torch.full_like(idx, -1))
    if kk < k:
        dist = F.pad(dist, (0, k - kk), value=float("inf"))
        idx = F.pad(idx, (0, k - kk), value=-1)
    return dist, idx


def l2sq_topk_int8_rescored(
    queries: torch.Tensor,
    corpus_i8: torch.Tensor,
    row_scales: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    fetch: int = 128,
    block_size: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 scan + exact re-rank of the `fetch` best candidates on the
    device: removes the query quantization error, leaving only the per-row
    corpus quantization."""
    fetch = min(fetch, corpus_i8.shape[0])
    _, cand = l2sq_topk_int8(queries, corpus_i8, row_scales, corpus_sqnorms,
                             valid, k=fetch, block_size=block_size)
    return exact_rescore(queries, corpus_i8, row_scales, cand, k)
