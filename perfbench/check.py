"""What decides `correct`: the window's sampled answers against the plain
reference (the configuration's `reference` module, under
perfbench/reference/).

An answer is one query's (distances, keys) as `search_batch` returned it.
The harness keeps a seeded uniform sample of the window's calls
(reservoir sampling, `Sample`) and hands the queries, the answers and the
corpus it made to `numbers`, which works out three numbers:

* `bad_answers`: answers that are malformed: not k hits, a key that names
  no corpus row, a key twice, a distance that is not finite or out of
  ascending order. Exact: the limit is 0.
* `miss_share`: 1 - recall@k. A returned row is a hit when its exact
  distance is within the k-th exact distance (a near-tie of TIE_REL of the
  terms' scale counts as a hit either way). The configuration states the
  recall it guarantees (`recall_min`), so the limit is 1 - recall_min.
* `dist_gap`: the widest gap between a served distance and the float64
  distance of the row it names, over |q|^2 + |x|^2 (the size of the terms
  whose difference the distance is). Its limit lies between what sound
  runs of the program read and what the TF32 control reads (PERF.md).

`judge` holds each number to its limit from the configuration's `check`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

TIE_REL = 1e-6


class Sample:
    """A seeded uniform sample of `size` calls of the window (Algorithm R):
    every call is equally likely to be kept, whatever the window's length."""

    def __init__(self, size: int, seed: int):
        self.size = max(1, int(size))
        self.rng = np.random.default_rng(seed)
        self.kept: List[Tuple[int, object, object]] = []
        self.seen = 0

    def offer(self, batch: int, dists, keys) -> None:
        if len(self.kept) < self.size:
            self.kept.append((batch, dists, keys))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = (batch, dists, keys)
        self.seen += 1


def answers_to_arrays(dists_list: Sequence, keys_list: Sequence, k: int,
                      row_of: Callable[[object], int]
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids (Q, k) int64, dists (Q, k) f64, malformed (Q,) bool) from the
    answers; an id that names no row is -1."""
    qn = len(keys_list)
    ids = np.full((qn, k), -1, np.int64)
    dist = np.full((qn, k), np.inf)
    bad = np.zeros(qn, bool)
    for i, (d, keys) in enumerate(zip(dists_list, keys_list)):
        d = np.asarray(d, np.float64).reshape(-1)
        if len(keys) != k or d.shape[0] != k:
            bad[i] = True
        for j, key in enumerate(list(keys)[:k]):
            ids[i, j] = row_of(key)
        dist[i, :min(k, d.shape[0])] = d[:k]
    return ids, dist, bad


def numbers(queries: np.ndarray, ids: np.ndarray, dists: np.ndarray,
            malformed: np.ndarray, corpus: np.ndarray, k: int, reference,
            device="cpu") -> Dict[str, float]:
    """The three numbers of the module docstring for these answers."""
    n = corpus.shape[0]
    named = (ids >= 0) & (ids < n)
    dup = np.zeros(ids.shape[0], bool)
    for i in range(ids.shape[0]):
        row = ids[i][named[i]]
        dup[i] = len(np.unique(row)) != len(row)
    finite = np.isfinite(dists)
    ascending = np.all(np.diff(dists, axis=1) >= 0, axis=1)
    bad = (malformed | ~named.all(axis=1) | dup | ~finite.all(axis=1)
           | ~ascending)
    _, ref_d = reference.exact_topk(queries, corpus, k, device=device)
    exact = reference.distances64(queries, corpus, ids)
    scale = (reference.sqnorms64(queries)[:, None]
             + reference.sqnorms64(corpus[np.where(named, ids, 0)]))
    kth = ref_d[:, k - 1:k]
    hits = named & (exact <= kth + TIE_REL * scale)
    for i in np.flatnonzero(dup):
        # a row returned twice is one hit
        seen = set()
        for j in range(k):
            if hits[i, j] and ids[i, j] in seen:
                hits[i, j] = False
            seen.add(int(ids[i, j]))
    ok = named & finite
    gaps = np.abs(dists - exact)[ok] / scale[ok]
    return {
        "bad_answers": float(bad.sum()),
        "miss_share": float(1.0 - hits.sum() / hits.size),
        "dist_gap": float(gaps.max()) if gaps.size else float("inf"),
    }


def limits(config: dict) -> Dict[str, float]:
    """The configuration's limit for each number."""
    chk = config["check"]
    return {"bad_answers": 0.0,
            "miss_share": round(1.0 - config["guarantees"]["recall_min"], 9),
            "dist_gap": float(chk["dist_gap"])}


def judge(values: Dict[str, float], lim: Dict[str, float],
          extra: Optional[Dict[str, Tuple[float, float]]] = None
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or under its limit. `extra` adds (value, limit) pairs judged alike,
    such as the window's failed calls against 0."""
    pairs = {name: (values[name], lim[name]) for name in lim}
    pairs.update(extra or {})
    table = {name: {"value": v, "limit": l} for name, (v, l) in pairs.items()}
    correct = all(np.isfinite(v) and v <= l for v, l in pairs.values())
    return correct, table
