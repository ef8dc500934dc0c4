"""Exact k-NN scans as torch ops, and the `l2sq_topk` dispatcher (torch
port of tpuvdb.kernels.distance).

Math: for squared L2 the scans track the *negated partial score*
    neg = 2 * q . x - ||x||^2
which orders identically to -(||q - x||^2); the per-query constant ||q||^2
is added back at finalization, so returned scores are true squared-L2
distances, ascending.

Precision: f32 corpora score in full f32 (TF32 is off, see device.py), as
`Precision.HIGHEST` does in the reference. bf16 corpora round the queries
to bf16 and accumulate the exact bf16 x bf16 products in f32, as the
reference's `preferred_element_type=float32` dot does.

Dispatch (`l2sq_topk`):
  "exact"            l2sq_full / l2sq_topk_blockwise, exact torch.topk —
                     the reference leaves these to XLA, so torch ops here.
  "approx", "pallas" the bucketed scan (kernels/scan.py): the hand-written
                     CUDA kernel on the GPU, its plain torch twin on the
                     CPU, wherever its buckets serve k at `recall_target`;
                     the exact path above for any larger k.

The reference's "approx" is jax.lax.approx_max_k at `recall_target`, which
returns k hits at that recall for any k. The scan keeps one row per bucket:
with the true top-k spread over B buckets, the expected share of it lost to
collisions is about k / (2B). So the scan serves k <= 2B(1 - recall_target)
(k <= 51 at B = 512 and the default 0.95), and a larger k takes the exact
path, a torch matmul plus topk, as the reference's approx_max_k is XLA
outside Pallas. The choice depends on k and recall_target only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuvdb_torch import device as _device  # noqa: F401  (TF32 off)
from tpuvdb_torch.kernels import topk as tk


def queries_like(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Queries as f32 carrying the corpus dtype's rounding (bf16 corpora
    see bf16-rounded queries, as the reference's cast does)."""
    q = queries.to(torch.float32)
    if corpus.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).to(torch.float32)
    elif corpus.dtype != torch.float32:
        raise NotImplementedError(
            f"corpus dtype {corpus.dtype}: these scans take float32 and "
            "bfloat16 rows (int8 rows take the functions of kernels/quant.py)")
    return q


MMA_WIDTHS = (8, 32, 64, 128)  # query tiles the tensor-core kernels build


def mma_width(cols: int) -> int:
    """The tensor-core kernels' query tile for `cols` queries: the narrowest
    width that holds them (one query pads to 8), the widest above that."""
    return next((w for w in MMA_WIDTHS if cols <= w), MMA_WIDTHS[-1])


def mma_queries(queries: torch.Tensor, corpus: torch.Tensor):
    """The tensor-core kernels' query inputs (csrc/hopper_mma.cuh): the f32
    queries, contiguous, and scratch for the operands the kernel library
    makes of them (prep_queries_kernel): rows padded to d_pad, a multiple
    of 16 bytes; f32 corpora the tf32 hi and lo parts, bf16 corpora the
    bf16 queries (the second buffer unused). Returns (queries, hi, lo,
    d_pad)."""
    q = queries.to(torch.float32).contiguous()
    nq, d = q.shape
    per = 16 // corpus.element_size()
    d_pad = -(-d // per) * per
    hi = torch.empty((nq, d_pad), dtype=corpus.dtype, device=q.device)
    lo = torch.empty_like(hi) if corpus.dtype == torch.float32 else hi
    return q, hi, lo, d_pad


def _partial_neg_scores(qc: torch.Tensor, chunk: torch.Tensor,
                        chunk_sq: torch.Tensor) -> torch.Tensor:
    """(Q, B) negated partial scores 2 q.x - ||x||^2 in f32."""
    dots = qc @ chunk.to(torch.float32).T
    return 2.0 * dots - chunk_sq[None, :]


def _q_sq(queries: torch.Tensor) -> torch.Tensor:
    q = queries.to(torch.float32)
    return (q * q).sum(dim=-1, keepdim=True)


def _finish(neg: torch.Tensor, idx: torch.Tensor, q_sq: torch.Tensor):
    idx = torch.where(neg == float("-inf"), torch.full_like(idx, -1), idx)
    dist = torch.where(idx >= 0, q_sq - neg,
                       torch.full_like(neg, float("inf")))
    return dist, idx


def l2sq_topk_blockwise(
    queries: torch.Tensor,       # (Q, d) float32
    corpus: torch.Tensor,        # (N, d) storage dtype; N % block_size == 0
    corpus_sqnorms: torch.Tensor,  # (N,) float32
    valid: torch.Tensor,         # (N,) bool
    k: int,
    block_size: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming exact top-k: one (Q, B) block at a time folded into a
    (Q, k) running top-k. Returns (dists, idx), each (Q, k); empty slots
    are +inf / -1 (the reference leaves the row id of a masked slot in
    place; the port returns -1, as l2sq_full does in both)."""
    n = corpus.shape[0]
    if n % block_size != 0:
        raise ValueError(f"corpus rows {n} not a multiple of block_size {block_size}")
    qc = queries_like(queries, corpus)
    neg, idx = tk.empty_topk(queries.shape[0], k, device=corpus.device)
    col = torch.arange(block_size, dtype=torch.int32, device=corpus.device)
    for start in range(0, n, block_size):
        end = start + block_size
        scores = _partial_neg_scores(qc, corpus[start:end],
                                     corpus_sqnorms[start:end])
        scores = tk.mask_scores(scores, valid[None, start:end])
        gidx = (start + col).expand(scores.shape[0], block_size)
        neg, idx = tk.merge_topk(neg, idx, scores, gidx, k)
    return _finish(neg, idx, _q_sq(queries))


def l2sq_full(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    valid: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-GEMM exact top-k for small corpora (materializes (Q, N))."""
    qc = queries_like(queries, corpus)
    scores = _partial_neg_scores(qc, corpus, corpus_sqnorms)
    scores = tk.mask_scores(scores, valid[None, :])
    kk = min(k, corpus.shape[0])
    neg, idx = torch.topk(scores, kk, dim=1)
    idx = idx.to(torch.int32)
    if kk < k:  # pad so callers always see (Q, k)
        neg = torch.nn.functional.pad(neg, (0, k - kk), value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return _finish(neg, idx, _q_sq(queries))


SCAN_BUCKETS = 512


def scan_max_k(recall_target: float, n_buckets: int = SCAN_BUCKETS) -> int:
    """Largest k the bucketed scan serves at `recall_target`: the expected
    share of the true top-k lost to bucket collisions, about k / (2B), must
    stay within 1 - recall_target."""
    return int(2 * n_buckets * (1.0 - recall_target))


def l2sq_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    mode: str = "approx",
    recall_target: float = 0.95,
    block_size: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher: 'exact' (exact top-k merge), or 'approx'/'pallas' (the
    bucketed scan kernel where k <= scan_max_k(recall_target), else exact)."""
    if mode not in ("exact", "approx", "pallas"):
        raise ValueError(f"unknown search mode: {mode}")
    if mode != "exact" and k <= scan_max_k(recall_target):
        from tpuvdb_torch.kernels.scan import scan_l2sq_topk

        return scan_l2sq_topk(queries, corpus, corpus_sqnorms, valid, k=k,
                              n_buckets=SCAN_BUCKETS)
    n = corpus.shape[0]
    if n % block_size != 0 or n <= block_size:
        return l2sq_full(queries, corpus, corpus_sqnorms, valid, k)
    return l2sq_topk_blockwise(queries, corpus, corpus_sqnorms, valid,
                               k=k, block_size=block_size)


def numpy_oracle(queries, corpus, valid, k):
    """Pure-numpy exact scan — the correctness oracle for all scans."""
    import numpy as np

    q = np.asarray(queries, dtype=np.float64)
    c = np.asarray(corpus, dtype=np.float64)
    v = np.asarray(valid, dtype=bool)
    d2 = (
        np.sum(q * q, axis=1, keepdims=True)
        + np.sum(c * c, axis=1)[None, :]
        - 2.0 * (q @ c.T)
    )
    d2[:, ~v] = np.inf
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dist = np.take_along_axis(d2, idx, axis=1)
    idx = np.where(np.isfinite(dist), idx, -1)
    return dist, idx
