"""Query and write coalescing for the serving path: the port of
tpuvdb.api.batching.

One corpus sweep of the scan kernel serves a batch of queries at little
more than the cost of one, so concurrent requests that arrive within a
small window share one engine.search_batch.

Requests enqueue (query, k, future); a worker drains the queue every
`max_wait_s` (or when `max_batch` accumulate), pads all queries to the max
k in the batch, runs ONE engine.search_batch, and resolves the futures.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import List, Tuple

import numpy as np


def _fail_response(msg: str):
    from tpuvdb_torch.core.types import Response

    return Response.fail(msg)


class BatchingWriter:
    """Group commit for single-record writes: a
    solo engine.put() pays one WAL fsync per record (~1k/s ceiling), so
    naive REST ingest through rpc_put was 30x slower than put_batch.
    Concurrent puts enqueue here; the worker drains EVERYTHING queued and
    applies one engine.put_batch — one fsync per flush window. No
    artificial wait: while one batch fsyncs, the next accumulates
    (classic group commit), so a lone sequential client pays no added
    latency and concurrent clients coalesce automatically."""

    def __init__(self, engine, max_batch: int = 1024):
        self.engine = engine
        self.max_batch = max_batch
        self._q: "queue.Queue[Tuple[object, Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tpuvdb-torch-write-batcher")
        self._worker.start()

    def put(self, record, timeout: float = 30.0):
        """Blocking: returns the batch Response once THIS record's batch
        is durably applied (same visibility semantics as a direct put)."""
        fut: Future = Future()
        self._q.put((record, fut))
        return fut.result(timeout=timeout)

    def _drain(self):
        items = []
        try:
            items.append(self._q.get(timeout=0.1))
        except queue.Empty:
            return items
        while len(items) < self.max_batch:
            try:
                items.append(self._q.get_nowait())
            except queue.Empty:
                break
        return items

    def _run(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            # Validate each record BEFORE coalescing: one malformed
            # vector must fail only ITS caller, not every client that
            # happened to share the flush window (put_batch rejects the
            # whole batch on the first bad record).
            dim = self.engine.config.vector_dim
            good = []
            for r, fut in items:
                try:
                    r.vector_np(dim)
                    good.append((r, fut))
                except ValueError as e:
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(_fail_response(str(e)))
            if not good:
                continue
            try:
                resp = self.engine.put_batch([r for r, _ in good])
                for _, fut in good:
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(resp)
            except Exception as e:
                for _, fut in good:
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(e)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2)


class BatchingSearcher:
    def __init__(self, engine, max_batch: int = 256, max_wait_s: float = 0.002):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue[Tuple[np.ndarray, int, Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tpuvdb-torch-batcher")
        self._worker.start()

    def search(self, query: np.ndarray, k: int, timeout: float = 120.0):
        """Blocking: returns (dists (k,), keys list). Raises on timeout
        (the reference's default, kept)."""
        fut: Future = Future()
        self._q.put((np.asarray(query, np.float32).reshape(-1), k, fut))
        return fut.result(timeout=timeout)

    def _drain(self) -> List[Tuple[np.ndarray, int, Future]]:
        items = []
        try:
            items.append(self._q.get(timeout=0.1))
        except queue.Empty:
            return items
        # small coalescing window for followers
        deadline = self.max_wait_s
        import time

        t0 = time.perf_counter()
        while len(items) < self.max_batch:
            remaining = deadline - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _run(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            try:
                queries = np.stack([q for q, _, _ in items])
                kmax = max(k for _, k, _ in items)
                dists, keys = self.engine.search_batch(queries, kmax)
                for i, (_, k, fut) in enumerate(items):
                    if not fut.set_running_or_notify_cancel():
                        continue
                    fut.set_result((dists[i][:k], keys[i][:k]))
            except Exception as e:
                for _, _, fut in items:
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(e)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2)
