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

A cell whose mix writes beside the searches (perfbench/writes.py) is held
to the same three numbers by `live_numbers`, against the rows live when
each call started, and to exact counts whose limit is 0: `stale_answers`
(a key served with a version deleted or overwritten before the call
started), `unseen_writes` (a self-query of a fresh row acknowledged
before its call was sent that did not find that row first),
`lost_writes` (a written key whose read-back after the crash and the
reopen is not its last acknowledged write, bit for bit), `wal_tail_missed`
(records after the last checkpoint that the reopen did not replay) and
`failed_writes`.
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


def live_numbers(queries: np.ndarray, at: np.ndarray, ret: np.ndarray,
                 dists: Sequence, keys: Sequence, k: int, versions,
                 parts: Sequence[np.ndarray], reference, device="cpu"
                 ) -> Dict[str, float]:
    """The three numbers of the module docstring for answers given while
    the store was written, against the versions live at each call's start
    `at` (perfbench/writes.py `Versions`; the reference's
    `exact_topk_live`), and `stale_answers`.

    A served key stands for the one of its versions whose exact distance
    lies nearest the served one, among those that could be visible during
    the call: live at its start, or written before it returned and
    acknowledged after it started (an in-flight write, in its old state or
    its new). A key whose nearest version is one that was overwritten or
    deleted before the call started is a stale answer; a key with no
    version visible during the call names no row."""
    ref_ids, ref_d = reference.exact_topk_live(
        queries, parts, versions.born_ack, versions.died_ack, at, k,
        device=device)
    qn = len(keys)
    bad = np.zeros(qn, bool)
    served = np.full((qn, k), np.inf)
    pairs_q, pairs_v, where = [], [], []
    for i in range(qn):
        d = np.asarray(dists[i], np.float64).reshape(-1)
        row = list(keys[i])
        if len(row) != k or d.shape[0] != k or len(set(row)) != k \
                or not np.isfinite(d).all() or np.any(np.diff(d) < 0):
            bad[i] = True
        served[i, :min(k, d.shape[0])] = d[:k]
        for j, key in enumerate(row[:k]):
            for v in versions.rows_of(key):
                pairs_q.append(i)
                pairs_v.append(v)
                where.append(j)
    pq = np.asarray(pairs_q, np.int64)
    pv = np.asarray(pairs_v, np.int64)
    exact = np.zeros(0)
    if pq.size:
        exact = reference.distances64(queries[pq], parts, pv[:, None])[:, 0]
    q_sq = reference.sqnorms64(queries)
    v_sq = np.concatenate(
        [np.zeros(0)] + [reference.sqnorms64(
            reference.gather(parts, pv[lo:lo + 4096]))
            for lo in range(0, pv.size, 4096)])
    best = {}  # (i, j) -> (gap, exact, gone, scale) of the nearest version
    for n in range(pq.size):
        i, j, v = int(pq[n]), where[n], int(pv[n])
        gone = versions.died_ack[v] < at[i]  # before the call started
        if not gone and versions.born_send[v] >= ret[i]:
            continue  # sent after the call returned: never visible to it
        scale = q_sq[i] + v_sq[n]
        gap = abs(served[i, j] - exact[n]) / scale
        old = best.get((i, j))
        if old is None or gap < old[0]:
            best[(i, j)] = (gap, exact[n], gone, scale)
    kth = ref_d[:, k - 1]
    hits = 0
    stale = 0
    gaps = []
    for i in range(qn):
        for j in range(min(k, len(keys[i]))):
            got = best.get((i, j))
            if got is None:
                bad[i] = True
                continue
            gap, ex, gone, scale = got
            if gone:
                stale += 1
                continue
            if np.isfinite(served[i, j]):
                gaps.append(gap)
            if list(keys[i]).index(keys[i][j]) == j \
                    and ex <= kth[i] + TIE_REL * scale:
                hits += 1
    return {
        "bad_answers": float(bad.sum()),
        "miss_share": float(1.0 - hits / max(1, qn * k)),
        "dist_gap": float(max(gaps)) if gaps else float("inf"),
        "stale_answers": float(stale),
    }


def unseen_writes(self_checks: Sequence[tuple], key_of, sq_of,
                  dist_gap: float) -> int:
    """Self-queries whose fresh row, acknowledged before the call was
    sent, was not served first: not served, or served further than
    dist_gap (over |q|^2 + |x|^2, here 2 |x|^2) from the first hit. Each
    check is (write, first key, first distance, the row's own served
    distance)."""
    unseen = 0
    for t, first, d0, own in self_checks:
        if first == key_of(t):
            continue
        unseen += not (own - d0 <= dist_gap * 2.0 * sq_of(t))
    return unseen


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
