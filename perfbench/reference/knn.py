"""The plain reference of k-nearest-neighbour search under squared L2.

Plain torch, importing nothing of the program. Given the corpus rows and
the queries that the harness made (the same arrays the program was handed),
it works the answer out again from scratch:

* `exact_topk`: every corpus row scored against every query, in blocks of
  rows, in float32 with TF32 off; the best `k + margin` of each query are
  scored again in float64 as sum((q - x)^2), which has no cancellation, and
  the best `k` of those are the answer. The margin keeps a row that f32
  rounding ranked just below the cut inside the f64 re-rank.
* `distances64`: the float64 squared distance of given rows to each query,
  the yardstick a served distance is held against.

`precision="tf32"` is the control (see perfbench/check.py): the same
search with both operands rounded to TF32 (10 mantissa bits, round to
nearest even) before an f32 product, which is what a TF32 tensor-core
product computes, on any device. Its answers carry TF32 distances.
`precision="tf32_card"` takes the card's own TF32 products instead
(`allow_tf32`), to hold the rounding above against the hardware.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

MARGIN = 22            # extra f32 candidates re-ranked in f64
BLOCK_ROWS = 1 << 16   # corpus rows scored at once


PRECISIONS = ("float32", "tf32", "tf32_card")


@contextlib.contextmanager
def _tf32(on: bool):
    """f32 products in full f32 (on=False) or in the card's TF32, whatever
    the process set before."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (nearest, ties to
    even), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    low = bits & 0x1FFF
    keep = bits & ~0x1FFF
    odd = (bits >> 13) & 1
    up = (low > 0x1000) | ((low == 0x1000) & (odd == 1))
    return (keep + (up.to(torch.int32) << 13)).view(torch.float32)


def _scores(q: torch.Tensor, x: torch.Tensor, x_sq: torch.Tensor,
            precision: str) -> torch.Tensor:
    """(Q, B) squared distances |q|^2 + |x|^2 - 2 q.x in f32."""
    if precision == "tf32":
        q_op, x_op = round_tf32(q), round_tf32(x)
    else:
        q_op, x_op = q, x
    q_sq = (q * q).sum(dim=1, keepdim=True)
    return q_sq + x_sq[None, :] - 2.0 * (q_op @ x_op.T)


def exact_topk(queries: np.ndarray, corpus: np.ndarray, k: int,
               device="cpu", precision: str = "float32"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64 (Q, k), dists (Q, k)) of the k nearest corpus rows of each
    query, ascending. float32: dists are float64 and ids the f64 order of
    the best k + MARGIN f32 candidates. tf32, tf32_card (the control): ids
    and dists (float32) as the TF32 product ranks them, no f64 re-rank."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    dev = torch.device(device)
    n = corpus.shape[0]
    fetch = min(n, k + (MARGIN if precision == "float32" else 0))
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    best_d = torch.full((q.shape[0], 0), float("inf"), device=dev)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=dev)
    with _tf32(precision == "tf32_card"):
        for lo in range(0, n, BLOCK_ROWS):
            x = torch.from_numpy(corpus[lo:lo + BLOCK_ROWS]).to(dev)
            d = _scores(q, x, (x * x).sum(dim=1), precision)
            top = min(fetch, d.shape[1])
            bd, bi = torch.topk(d, top, dim=1, largest=False)
            best_d = torch.cat([best_d, bd], dim=1)
            best_i = torch.cat([best_i, bi + lo], dim=1)
            best_d, pos = torch.topk(best_d, min(fetch, best_d.shape[1]),
                                     dim=1, largest=False)
            best_i = torch.gather(best_i, 1, pos)
    ids = best_i.cpu().numpy()
    if precision != "float32":
        d = best_d.cpu().numpy()
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(ids, order, axis=1),
                np.take_along_axis(d, order, axis=1))
    d64 = distances64(queries, corpus, ids)
    order = np.argsort(d64, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(ids, order, axis=1),
            np.take_along_axis(d64, order, axis=1))


def distances64(queries: np.ndarray, corpus: np.ndarray,
                ids: np.ndarray) -> np.ndarray:
    """float64 sum((q - x)^2) of corpus row ids[i, j] to query i; +inf where
    an id is outside the corpus."""
    n = corpus.shape[0]
    ids = np.asarray(ids, np.int64)
    ok = (ids >= 0) & (ids < n)
    safe = np.where(ok, ids, 0)
    out = np.empty(ids.shape, np.float64)
    step = 256  # queries a block: the gathered rows stay tens of MB
    for lo in range(0, ids.shape[0], step):
        rows = corpus[safe[lo:lo + step]].astype(np.float64)
        diff = rows - np.asarray(queries[lo:lo + step], np.float64)[:, None]
        out[lo:lo + step] = np.einsum("qkd,qkd->qk", diff, diff)
    return np.where(ok, out, np.inf)


def sqnorms64(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    return np.einsum("...d,...d->...", a, a)
