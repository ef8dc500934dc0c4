"""Recall harness: the port's copy of tpuvdb.bench.recall (numpy).

Measures candidate-set quality against the numpy exact-scan oracle
(kernels/distance.py `numpy_oracle`); tests and benchmarks both use it.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from tpuvdb_torch.kernels.distance import numpy_oracle


def recall_at_k(
    got_idx: np.ndarray,     # (Q, k) candidate ids (-1 = empty)
    oracle_idx: np.ndarray,  # (Q, k) true ids
) -> float:
    q, k = oracle_idx.shape
    hits = 0
    for i in range(q):
        hits += len(set(int(x) for x in got_idx[i] if x >= 0)
                    & set(int(x) for x in oracle_idx[i]))
    return hits / (q * k)


def recall_curve(
    search_fn: Callable[[np.ndarray, int, int], np.ndarray],
    queries: np.ndarray,
    corpus: np.ndarray,
    valid: np.ndarray,
    k: int,
    sweep: Sequence[int],
) -> Dict[int, float]:
    """search_fn(queries, k, knob) -> (Q, k) ids; sweeps the knob (e.g.
    nprobe) and returns {knob: recall@k}."""
    _, oidx = numpy_oracle(queries, corpus, valid, k)
    out = {}
    for knob in sweep:
        ids = np.asarray(search_fn(queries, k, knob))
        out[knob] = recall_at_k(ids, oidx)
    return out
