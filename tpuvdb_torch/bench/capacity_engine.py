"""Engine-level capacity: the port of scripts/bench_capacity_engine.py.

    python -m tpuvdb_torch.bench.capacity_engine [--rows 8000000]
        [--dim 768] [--data-dir D] [--batch 256] [--k 10] [--skip-restart]
        [--device cuda]

The whole engine at 8,000,000 x 768 int8 rows on one card, in the
reference's configuration: 4 shards, int8 storage on int8 mmap mirrors
(disk-backed rows), rescore_mode="device" with overfetch 16, the WAL off
(a bulk load; durability is the explicit checkpoint), and the checkpoint,
compaction and flush thresholds out of reach. In order:

  ingest    put_rows of 65,536-row blocks, each drawn as it is put (512
            centres x 3.0, 0.4 noise; the f32 corpus is never held whole)
  build     the first flush: the streaming device build
  recall    recall@10 of 32 held-out rows against the exact scan over the
            stored int8 rows (capacity.stored_oracle)
  serving   b256 QPS over 20 searches in one thread, and over 64 searches
            on 8 threads
  durable   a hard-link checkpoint, then a restart from data_dir that
            must count every row (it raises otherwise), a flush and a
            search

Ingest, build, QPS, checkpoint and restart are host-clock seconds, as in
the reference. Diagnostics go to stderr, and stdout takes one JSON line
with the reference's keys. Without --data-dir the run works in a
temporary directory and removes it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from tpuvdb_torch.bench.capacity import recall_of, rss_gb, stored_oracle
from tpuvdb_torch.utils.hostmem import anon_gb

SHARDS = 4
N_CLUSTERS = 512
BLOCK = 65536        # rows drawn and put at a time
N_QUERIES = 32       # held-out rows whose recall is taken
ITERS = 20           # single-thread searches timed
PIPELINED = 64       # searches spread over 8 threads


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def config(rows: int, dim: int):
    """The reference's DBConfig (scripts/bench_capacity_engine.py:89-99)."""
    from tpuvdb_torch.core.config import DBConfig

    per_shard = (rows // SHARDS) + 65536
    return DBConfig(
        vector_dim=dim, shard_count=SHARDS, shard_capacity=per_shard,
        mirror_init_cap=per_shard, mirror_dtype="int8",
        mirror_backend="mmap", storage_dtype="int8",
        rescore_mode="device", rescore_overfetch=16,
        wal_enabled=False,
        checkpoint_every_puts=10 ** 12, compact_every_puts=10 ** 12,
        flush_batch=1 << 30,
    )


def run(args, device, data_dir: str) -> dict:
    from tpuvdb_torch.engine.engine import VectorDBEngine
    from tpuvdb_torch.utils.hostmem import keep_malloc_warm

    keep_malloc_warm()
    n_rows, dim, k = args.rows, args.dim, args.k
    cfg = config(n_rows, dim)
    log(f"device: {device}, rows={n_rows}, dim={dim}, data_dir={data_dir}, "
        f"base rss {rss_gb():.2f} GB")
    eng = VectorDBEngine(cfg, data_dir=data_dir, device=device)

    rng = np.random.default_rng(0)
    cents = rng.standard_normal((N_CLUSTERS, dim)).astype(np.float32) * 3.0
    t0 = time.perf_counter()
    held_out = None
    for lo in range(0, n_rows, BLOCK):
        n = min(BLOCK, n_rows - lo)
        cid = rng.integers(0, N_CLUSTERS, n)
        block = (cents[cid]
                 + 0.4 * rng.standard_normal((n, dim)).astype(np.float32))
        r = eng.put_rows([f"k{i}" for i in range(lo, lo + n)], block)
        if not r.success:
            raise RuntimeError(f"put_rows at {lo}: {r.message}")
        if lo == 0:
            held_out = block[:64].copy()
        if (lo // BLOCK) % 16 == 0:
            log(f"  ingested {lo + n:,}/{n_rows:,} rows, rss "
                f"{rss_gb():.2f} GB")
    ingest_s = time.perf_counter() - t0
    log(f"ingest: {n_rows / ingest_s:,.1f} rows/s ({ingest_s:.3f}s), rss "
        f"{rss_gb():.2f} GB, anon {anon_gb():.2f} GB")

    t0 = time.perf_counter()
    eng.flush()
    build_s = time.perf_counter() - t0
    info = eng.info()
    log(f"device build: {build_s:.3f}s, device "
        f"{info['device_bytes'] / 2**30:.4f} GiB, rss {rss_gb():.2f} GB, "
        f"anon {anon_gb():.2f} GB")

    queries = held_out[:N_QUERIES]
    oracle_keys = stored_oracle(eng, queries, k, eng._index.layout)
    _, keys = eng.search_batch(queries, k)
    recall = recall_of([ks[:k] for ks in keys], oracle_keys, k)
    log(f"recall@{k} vs exact-over-stored: {recall:.4f}")

    qbatch = rng.standard_normal((args.batch, dim)).astype(np.float32) * 0.1
    qbatch += cents[rng.integers(0, N_CLUSTERS, args.batch)]
    eng.search_batch(qbatch, k)  # warm
    t0 = time.perf_counter()
    for _ in range(ITERS):
        eng.search_batch(qbatch, k)
    single = args.batch * ITERS / (time.perf_counter() - t0)
    with ThreadPoolExecutor(max_workers=8) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda _: eng.search_batch(qbatch, k),
                      range(PIPELINED)))
        piped = args.batch * PIPELINED / (time.perf_counter() - t0)
    log(f"engine serving: {single:,.1f} QPS single-stream, {piped:,.1f} QPS "
        f"pipelined x8 (batch {args.batch})")

    t0 = time.perf_counter()
    ck = eng.save_checkpoint()
    ckpt_s = time.perf_counter() - t0
    log(f"checkpoint: {ckpt_s:.3f}s -> {ck}, rss {rss_gb():.2f} GB, anon "
        f"{anon_gb():.2f} GB")
    restart_s = None
    if not args.skip_restart:
        eng.stop_background_flush()
        del eng
        t0 = time.perf_counter()
        eng = VectorDBEngine(cfg, data_dir=data_dir, device=device)
        if eng.count() != n_rows:
            raise AssertionError(f"the restarted engine counts "
                                 f"{eng.count()} rows, {n_rows} were put")
        eng.flush()
        _, k2 = eng.search_batch(queries, k)
        if any(k2[0][j] is None for j in range(k)):
            raise AssertionError(f"the restarted engine's first answer has "
                                 f"empty hits: {k2[0]}")
        restart_s = time.perf_counter() - t0
        log(f"restart-with-recovery: {restart_s:.3f}s (count="
            f"{eng.count():,}), rss {rss_gb():.2f} GB, anon "
            f"{anon_gb():.2f} GB")

    return {
        "metric": "engine_capacity_8m768_int8",
        "rows": n_rows, "dim": dim,
        "ingest_rows_per_s": round(n_rows / ingest_s, 1),
        "build_s": round(build_s, 1),
        "device_gib": round(info["device_bytes"] / 2 ** 30, 2),
        "recall_at_10": round(recall, 4),
        "engine_qps_single": round(single, 1),
        "engine_qps_pipelined": round(piped, 1),
        "checkpoint_s": round(ckpt_s, 1),
        "restart_s": round(restart_s, 1) if restart_s else None,
        "peak_rss_gb": round(rss_gb(), 2),
        "anon_rss_gb": round(anon_gb(), 2),
    }


def main(argv=None, device: Optional[str] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--skip-restart", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from tpuvdb_torch.device import resolve_device

    dev = resolve_device(device or args.device)
    data_dir = args.data_dir or tempfile.mkdtemp(prefix="tpuvdb_torch_cap_")
    try:
        out = run(args, dev, data_dir)
    finally:
        if args.data_dir is None:
            shutil.rmtree(data_dir)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
