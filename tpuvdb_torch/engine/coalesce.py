"""Group-commit coalescing of concurrent engine searches: the port of
tpuvdb.engine.coalesce.

Each engine.search_batch pays a fixed cost per call (query upload, kernel
launches, the copy back and the host merge), and one corpus sweep over a
stack of queries costs little more than over one batch, so concurrent
batches should share one sweep. This is the WAL group-commit shape applied
to reads (the write analog is api/batching.py's BatchingWriter): callers
enqueue their batch under a mutex, then contend on a per-(k, overfetch)
leader semaphore. Whoever takes a slot drains every queued batch (up to
max_rows), stacks the queries, runs ONE direct search and resolves each
caller's slice. No worker thread, no window: a solo caller's group is
itself, and stacking happens exactly when calls back up.

The semaphore's width (`inflight`) lets up to that many stacked calls
overlap: when the device is fast the coalescer degrades to overlapped
direct calls (groups of 1), and when calls back up deeper, stacking
resumes.

Groups are keyed by (k, overfetch), so every member shares the leader's
fetch width and rescore semantics; mixed-k workloads form separate groups.

Divergence by design: the reference pads a stack up to a power of two to
bound the number of XLA compiles. The port compiles nothing per shape, and
a pad would cost the scan kernel, the host merge and key resolution real
work for rows nobody asked for, so a stack runs at its own row count. The
results of the real rows are the same.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Tuple

import numpy as np


class SearchCoalescer:
    def __init__(self, direct: Callable, max_rows: int = 4096,
                 inflight: int = 4):
        """direct: fn(queries, k, overfetch) -> (dists, keys), the engine's
        un-coalesced search path (retry loop included). inflight: the most
        concurrent direct calls per (k, overfetch) group key."""
        self._direct = direct
        self._max_rows = max(1, max_rows)
        self._inflight = max(1, inflight)
        self._mu = threading.Lock()
        self._pending: Dict[Tuple[int, bool], List] = {}
        self._leader: Dict[Tuple[int, bool], threading.Semaphore] = {}
        # {batches-per-group: count}: how much stacking the workload gets
        # (engine info surfaces it)
        self.group_sizes: Dict[int, int] = {}

    def search(self, queries: np.ndarray, k: int, overfetch: bool):
        key = (int(k), bool(overfetch))
        fut: Future = Future()
        with self._mu:
            self._pending.setdefault(key, []).append((queries, fut))
            sem = self._leader.setdefault(
                key, threading.Semaphore(self._inflight))
        # a drained group is capped at max_rows, so one _serve may resolve
        # only batches queued ahead of ours: keep taking a leader slot
        # (serving whoever is queued) until our own batch is resolved or in
        # flight under another leader. A solo caller passes through once.
        while not fut.done():
            with sem:
                if fut.done():
                    break
                took_any = self._serve(key, k, overfetch)
            if not fut.done() and not took_any:
                # the queue was empty, so a leader still in flight claimed
                # our batch: block on it instead of spinning
                break
        return fut.result()

    def _serve(self, key, k: int, overfetch: bool) -> bool:
        """Caller holds a leader slot. Drain whole queued batches up to
        max_rows (never split a batch; a single oversized batch still runs
        alone) and resolve their futures from one direct call. Returns
        whether any batch was taken."""
        with self._mu:
            queued = self._pending.get(key, [])
            group, rows = [], 0
            while queued and (not group
                              or rows + queued[0][0].shape[0]
                              <= self._max_rows):
                q, f = queued.pop(0)
                group.append((q, f))
                rows += q.shape[0]
            if group:
                self.group_sizes[len(group)] = self.group_sizes.get(
                    len(group), 0) + 1
        if not group:
            return False
        try:
            if len(group) == 1:
                dists, keys = self._direct(group[0][0], k, overfetch)
                group[0][1].set_result((dists, keys))
                return True
            stacked = np.concatenate(
                [np.asarray(q, np.float32) for q, _ in group])
            dists, keys = self._direct(stacked, k, overfetch)
            lo = 0
            for q, f in group:
                hi = lo + q.shape[0]
                f.set_result((dists[lo:hi], keys[lo:hi]))
                lo = hi
        except BaseException as e:
            for _, f in group:
                if not f.done():
                    f.set_exception(e)
        return True
