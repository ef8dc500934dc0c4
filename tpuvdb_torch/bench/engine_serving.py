"""Served-path benchmark: the port of tpuvdb.bench.engine_serving.

The scan benchmark (bench/scan.py) times the kernels alone; this measures
what a client gets from the engine: the device scan, the staged-delta
merge, the generation check, the row -> key resolution and the response
assembly, on the host clock around `search_batch`.

  engine_qps_single    sequential search_batch calls
  engine_qps_pipelined `threads` concurrent client threads (the engine
                       releases its lock around device calls, so requests
                       overlap as a server's do)
  engine_qps_projected batch / (kernel ms + the engine's host assembly
                       p50), and its pipelined form batch / max(the two):
                       what the device and the host bound together

plus recall@10 against the caller's oracle and the search stage timers.
`run_ivf_small_batch` times the IVF engine at a small batch, where IVF
wins: p50 and p95 per query and the build time.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

_INGEST_ROWS = 65536  # rows a put_rows call


def _ingest(eng, corpus_np: np.ndarray) -> None:
    n = len(corpus_np)
    for lo in range(0, n, _INGEST_ROWS):
        hi = min(lo + _INGEST_ROWS, n)
        r = eng.put_rows([f"r{i}" for i in range(lo, hi)], corpus_np[lo:hi])
        if not r.success:
            raise RuntimeError(f"put_rows [{lo}, {hi}): {r.message}")


def run_engine_serving(
    corpus_np: np.ndarray,
    queries_np: np.ndarray,
    oracle_idx: Optional[np.ndarray],
    k: int = 10,
    batch: int = 512,
    iters: int = 12,
    threads: int = 8,
    kernel_ms_per_batch: Optional[float] = None,
    storage_dtype: str = "bfloat16",
    search_mode: str = "pallas",
    coalesce: bool = False,
    log=print,
    device=None,
    keep_answer: bool = False,
) -> Dict:
    """The flat engine over `corpus_np` (keys r0..r{n-1}) in the
    reference's serving configuration: 4 shards, `storage_dtype`, the WAL
    off, no checkpoint or compaction, every write staged until the flush.
    Returns the reference's keys; with `keep_answer` also "first_answer",
    the (distances, keys) of the first search of the batch."""
    from tpuvdb_torch.core.config import DBConfig
    from tpuvdb_torch.engine.engine import VectorDBEngine

    n, dim = corpus_np.shape
    cfg = DBConfig(
        vector_dim=dim, shard_count=4, shard_capacity=n,
        mirror_init_cap=n // 4 + 4096, storage_dtype=storage_dtype,
        search_mode=search_mode, search_coalesce=coalesce,
        wal_enabled=False,
        checkpoint_every_puts=10 ** 12, compact_every_puts=10 ** 12,
        flush_batch=1 << 30,
    )
    eng = VectorDBEngine(cfg, device=device)
    try:
        t0 = time.perf_counter()
        _ingest(eng, corpus_np)
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.flush()
        build_s = time.perf_counter() - t0
        log(f"engine: ingest {n / ingest_s:,.0f} rows/s, device build "
            f"{build_s:.3f} s")

        q = queries_np[:batch].astype(np.float32)
        first = eng.search_batch(q, k)
        keys = first[1]
        # with coalescing, T concurrent streams form stacks up to T * batch
        t0 = time.perf_counter()
        warmed = eng.warm_search(k, batch, max_stack=threads * batch)
        log(f"engine: warmed stack shapes {warmed} "
            f"({time.perf_counter() - t0:.3f} s)")
        recall = None
        if oracle_idx is not None:
            n_check = min(len(oracle_idx), batch)
            want = [{f"r{j}" for j in row} for row in oracle_idx[:n_check]]
            recall = float(np.mean([
                len(set(keys[i][:k]) & want[i]) / k
                for i in range(n_check)]))

        t0 = time.perf_counter()
        for _ in range(iters):
            eng.search_batch(q, k)
        single_s = (time.perf_counter() - t0) / iters
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(lambda _: eng.search_batch(q, k), range(threads)))
            t0 = time.perf_counter()
            total = threads * iters
            list(pool.map(lambda _: eng.search_batch(q, k), range(total)))
            piped_s = (time.perf_counter() - t0) / total

        snap = eng.timers.snapshot()
        # p50, not the mean: a load spike skews the mean
        assemble_ms = snap.get("search.assemble", {}).get("p50_ms", 0.0)
        projected = proj_piped = None
        if kernel_ms_per_batch:
            projected = batch / ((kernel_ms_per_batch + assemble_ms) / 1e3)
            # the device scan and the host assembly are different
            # resources and overlap under concurrent callers: the slower
            # stage bounds the pipelined rate
            proj_piped = batch / (max(kernel_ms_per_batch, assemble_ms)
                                  / 1e3)
        out = {
            "engine_qps_single": batch / single_s,
            "engine_qps_pipelined": batch / piped_s,
            "engine_qps_projected": projected,
            "engine_qps_projected_pipelined": proj_piped,
            "engine_recall_at_10": recall,
            "host_assemble_ms_per_batch": assemble_ms,
            "batch": batch,
            "stage_timers": {k_: v for k_, v in snap.items()
                             if k_.startswith("search")},
            "search_groups": (dict(eng._search_coalescer.group_sizes)
                              if eng._search_coalescer else None),
        }
        if keep_answer:
            out["first_answer"] = first
    finally:
        eng.close()
    log(f"engine serving: single {out['engine_qps_single']:,.0f} QPS, "
        f"pipelined x{threads} {out['engine_qps_pipelined']:,.0f} QPS, "
        f"projected {projected} (pipelined {proj_piped}), assemble "
        f"{assemble_ms:.3f} ms/batch, recall {recall}")
    return out


def run_ivf_small_batch(
    corpus_np: np.ndarray,
    queries_np: np.ndarray,
    k: int = 10,
    batch: int = 8,
    iters: int = 30,
    log=print,
    device=None,
) -> Dict:
    """The IVF engine in the reference's serving configuration (nlist
    1024, nprobe 64, 6 k-means iterations on a 131,072-row sample) at a
    small batch: p50 and p95 latency per query and the build time."""
    from tpuvdb_torch.core.config import DBConfig
    from tpuvdb_torch.engine.engine import VectorDBEngine

    n, dim = corpus_np.shape
    cfg = DBConfig(
        vector_dim=dim, shard_count=4, shard_capacity=n,
        mirror_init_cap=n // 4 + 4096, index_type="ivf",
        ivf_nlist=1024, ivf_nprobe=64, ivf_kmeans_iters=6,
        ivf_train_sample=131072, wal_enabled=False,
        checkpoint_every_puts=10 ** 12, compact_every_puts=10 ** 12,
        flush_batch=1 << 30,
    )
    eng = VectorDBEngine(cfg, device=device)
    try:
        _ingest(eng, corpus_np)
        t0 = time.perf_counter()
        eng.flush()  # the k-means build
        build_s = time.perf_counter() - t0
        q = queries_np[:batch].astype(np.float32)
        eng.search_batch(q, k)
        lats = []
        for _ in range(iters):
            t0 = time.perf_counter()
            eng.search_batch(q, k)
            lats.append((time.perf_counter() - t0) / batch)
    finally:
        eng.close()
    lats.sort()
    p50 = lats[len(lats) // 2] * 1e3
    p95 = lats[int(len(lats) * 0.95)] * 1e3
    log(f"ivf small-batch (b{batch}): p50 {p50:.3f} ms/query, "
        f"p95 {p95:.3f} ms/query, build {build_s:.3f} s")
    # "ivf_batch", not "batch": the serving path's batch shares the dict
    return {"ivf_build_s": build_s, "ivf_p50_ms_per_query": p50,
            "ivf_p95_ms_per_query": p95, "ivf_batch": batch}
