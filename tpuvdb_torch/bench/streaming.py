"""Streaming ingest benchmark: the port of tpuvdb.bench.streaming.

    python -m tpuvdb_torch.bench.streaming   (or: cli bench --suite streaming)

Concurrent inserts and queries with WAL durability, at the reference's
shape: 50,000 seeded 512-d vectors put in batches of 512 into a 4-shard
engine with the WAL on (the native group-commit writer where it builds), a
background flush to the device, and a searcher thread that queries every
10 ms meanwhile. It measures:

  * the durable ingest rate (WAL group commit + mirror writes);
  * the searcher's latency while ingest runs (p50, p95);
  * recovery: the WAL is closed without a checkpoint and the engine
    reopened from the last checkpoint plus the WAL tail; the reopened
    engine must count every key put.

The target is 1M vectors an hour (`vs_baseline` divides by it). Stderr
takes the diagnostics, stdout one JSON line with the reference's keys.
`run()` takes the sizes and a `data_dir`, which it leaves in place;
without one it works in a temporary directory and removes it. A failure
of the searcher thread is raised after the ingest.
"""

from __future__ import annotations

import json
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

WARM_ROWS = 512
SEARCH_PAUSE_S = 0.01
TARGET_PER_S = 1e6 / 3600.0  # 1M vectors an hour


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _config(dim: int):
    from tpuvdb_torch.core.config import DBConfig

    # mirrors sized to the corpus: no growth rebuilds
    return DBConfig(vector_dim=dim, shard_count=4, shard_capacity=1 << 17,
                    block_size=8192, checkpoint_every_puts=20_000,
                    compact_every_puts=10 ** 9, mirror_init_cap=1 << 14)


def _ingest(eng, n_total: int, dim: int, batch: int, log):
    """Warms the engine up, then puts n_total seeded rows in batches while
    a searcher thread queries; returns (rows/s, the searches' p50 ms)."""
    from tpuvdb_torch.core.types import SearchRequest, VectorData

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((n_total, dim)).astype(np.float32)

    # serving warm-up: the first search and scatter before timing
    warm = [VectorData(key=f"warm{j}", vector=vecs[j])
            for j in range(WARM_ROWS)]
    r = eng.put_batch(warm)
    if not r.success:
        raise RuntimeError(f"warm-up put_batch: {r.message}")
    eng.flush()
    eng.search(SearchRequest(query_vector=vecs[0], top_k=10))
    log("warmup done")

    qlat = []
    failed = []
    stop = threading.Event()

    def searcher():
        q = vecs[123]
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                r = eng.search(SearchRequest(query_vector=q, top_k=10))
                qlat.append(time.perf_counter() - t0)
                if not r.success:
                    raise RuntimeError(f"search: {r.message}")
                time.sleep(SEARCH_PAUSE_S)
        except Exception as e:  # raised again after the join
            failed.append(e)

    s = threading.Thread(target=searcher, name="bench-searcher")
    t0 = time.perf_counter()
    s.start()
    try:
        for i in range(0, n_total, batch):
            recs = [VectorData(key=f"k{i + j}", vector=vecs[i + j])
                    for j in range(min(batch, n_total - i))]
            r = eng.put_batch(recs)
            if not r.success:
                raise RuntimeError(f"put_batch at {i}: {r.message}")
        ingest_s = time.perf_counter() - t0
    finally:
        stop.set()
        s.join()
    if failed:
        raise failed[0]
    rate = n_total / ingest_s
    log(f"ingested {n_total} x {dim}d durably in {ingest_s:.3f} s "
        f"-> {rate:,.0f} vec/s ({rate * 3600 / 1e6:.2f}M/hr)")
    ql = sorted(qlat)
    p50_ms = ql[len(ql) // 2] * 1e3 if ql else None
    if ql:
        log(f"concurrent search p50 {p50_ms:.3f} ms p95 "
            f"{ql[int(len(ql) * 0.95)] * 1e3:.3f} ms over {len(ql)} queries")
    return rate, p50_ms


def _run(n_total: int, dim: int, batch: int, device, data_dir: str,
         log) -> dict:
    from tpuvdb_torch.engine.engine import VectorDBEngine

    cfg = _config(dim)
    eng = VectorDBEngine(cfg, data_dir=data_dir, device=device)
    try:
        eng.start_background_flush()
        rate, p50_ms = _ingest(eng, n_total, dim, batch, log)
    finally:
        # recovery starts as after a crash: the WAL closed, no checkpoint
        eng.stop_background_flush()
        eng.wal.close()
    t0 = time.perf_counter()
    eng2 = VectorDBEngine(cfg, data_dir=data_dir, device=device)
    rec_s = time.perf_counter() - t0
    try:
        got = eng2.count()
        if got != n_total + WARM_ROWS:
            raise AssertionError(f"reopened engine counts {got} keys, "
                                 f"{n_total + WARM_ROWS} were put")
    finally:
        eng2.close()
    log(f"recovery (checkpoint + WAL tail replay): {rec_s:.3f} s")
    return {
        "metric": "durable_ingest_vectors_per_sec",
        "value": rate,
        "unit": "vec/s",
        "vs_baseline": rate / TARGET_PER_S,
        "ingest_total": n_total,
        "dim": dim,
        "concurrent_search_p50_ms": p50_ms,
        "recovery_s": rec_s,
    }


def run(n_total: int = 50_000, dim: int = 512, batch: int = 512,
        device=None, data_dir: Optional[str] = None, log=log) -> dict:
    """Runs the benchmark on `device` (None = cuda) in `data_dir` (kept),
    or in a temporary directory (removed); returns the JSON record."""
    from tpuvdb_torch.device import resolve_device

    dev = resolve_device(device)
    if data_dir is not None:
        return _run(n_total, dim, batch, dev, data_dir, log)
    with tempfile.TemporaryDirectory(prefix="tpuvdb_torch_bench_") as tmp:
        return _run(n_total, dim, batch, dev, tmp, log)


def main(device: Optional[str] = None):
    print(json.dumps(run(device=device)), flush=True)


if __name__ == "__main__":
    main()
