"""The plain reference of k-nearest-neighbour search under squared L2 over
a store that is written while it is searched.

Plain torch, importing nothing of the program. The rows are versions: the
base rows and every vector the writer put, numbered through the parts
handed in, one after the other. Version j lives from `born[j]` to
`died[j]` (host clock s; -inf / inf for a base row never written over),
and query i asks at `at[i]`, its call's start. The answer of query i is
worked out from the versions live then, born[j] < at[i] <= died[j], as
perfbench/reference/knn.py works it out from the whole corpus, with its
constants and its f32 scores (imported from it):

* `exact_topk_live`: every version scored against every query, in blocks
  of rows, in float32 with TF32 off, a version not live at the query's
  time set to +inf; the best `k + margin` of each query are scored again
  in float64 as sum((q - x)^2) and the best `k` of those are the answer.
* `distances64`: the float64 squared distance of given versions to each
  query, the yardstick a served distance is held against.

`precision="tf32"` is the control (perfbench/control.py), as in knn.py.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.knn import (BLOCK_ROWS, MARGIN, PRECISIONS, _scores,
                                     _tf32, sqnorms64)

__all__ = ["exact_topk_live", "gather", "distances64", "sqnorms64"]


def _blocks(parts: Sequence[np.ndarray]):
    """(first version number, rows) of each block of every part."""
    base = 0
    for part in parts:
        for lo in range(0, part.shape[0], BLOCK_ROWS):
            yield base + lo, part[lo:lo + BLOCK_ROWS]
        base += part.shape[0]


def exact_topk_live(queries: np.ndarray, parts: Sequence[np.ndarray],
                    born: np.ndarray, died: np.ndarray, at: np.ndarray,
                    k: int, device="cpu", precision: str = "float32"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64 (Q, k), dists (Q, k)) of the k nearest versions live at
    each query's time, ascending; as knn.exact_topk for each precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    dev = torch.device(device)
    fetch = k + (MARGIN if precision == "float32" else 0)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    t = torch.from_numpy(np.asarray(at, np.float64)).to(dev)[:, None]
    best_d = torch.full((q.shape[0], 0), float("inf"), device=dev)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=dev)
    with _tf32(precision == "tf32_card"):
        for lo, rows in _blocks(parts):
            x = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
            d = _scores(q, x, (x * x).sum(dim=1), precision)
            b = torch.from_numpy(born[lo:lo + rows.shape[0]]).to(dev)
            e = torch.from_numpy(died[lo:lo + rows.shape[0]]).to(dev)
            live = (b[None, :] < t) & (t <= e[None, :])
            d = torch.where(live, d, torch.full_like(d, float("inf")))
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
    d64 = distances64(queries, parts, ids)
    d64 = np.where(np.isfinite(best_d.cpu().numpy()), d64, np.inf)
    order = np.argsort(d64, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(ids, order, axis=1),
            np.take_along_axis(d64, order, axis=1))


def gather(parts: Sequence[np.ndarray], ids: np.ndarray) -> np.ndarray:
    """The rows of version ids (any shape) from the parts, float64."""
    ids = np.asarray(ids, np.int64)
    flat = ids.reshape(-1)
    out = np.empty((flat.shape[0], parts[0].shape[1]), np.float64)
    base = 0
    for part in parts:
        m = (flat >= base) & (flat < base + part.shape[0])
        out[m] = part[flat[m] - base]
        base += part.shape[0]
    return out.reshape(ids.shape + (parts[0].shape[1],))


def distances64(queries: np.ndarray, parts: Sequence[np.ndarray],
                ids: np.ndarray) -> np.ndarray:
    """float64 sum((q - x)^2) of version ids[i, j] to query i."""
    ids = np.asarray(ids, np.int64)
    out = np.empty(ids.shape, np.float64)
    step = 256  # queries a block: the gathered rows stay tens of MB
    for lo in range(0, ids.shape[0], step):
        rows = gather(parts, ids[lo:lo + step])
        diff = rows - np.asarray(queries[lo:lo + step], np.float64)[:, None]
        out[lo:lo + step] = np.einsum("qkd,qkd->qk", diff, diff)
    return out

