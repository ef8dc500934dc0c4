"""IVF serving under mixed shapes: client threads of several batch sizes
through the engine's search coalescer, while a writer puts and deletes.

    python -m tpuvdb_torch.bench.ivf_mixed [--rows 1000000] [--dim 512]
        [--nlist 1024] [--nprobe 64] [--clients 8] [--batches 1,8,64]
        [--seconds 20] [--warm-seconds 5] [--write-ms 20] [--puts 8]
        [--deletes 4] [--k 10] [--seed 0] [--device cuda]

The engine is the f32 IVF node of perfbench's `clip-b32-ivf-f32-1m`
(4 shards, coalescing on, no WAL) over --rows clustered unit rows. Each
client thread loops: draw a batch size from --batches, send that many
queries (corpus rows plus noise) through `search_batch`. The coalescer
stacks what arrives together, so the probe sees many batch sizes, and the
writer's staged deletes widen the engine's fetch (k plus the staged
deletes): the stream varies both parts of an IVF probe graph's key
(index/probe_graphs.py). After --warm-seconds of the same stream it times
--seconds. Stdout takes one JSON line: queries and requests a second, the
p50 and p95 ms of a request, the window's `ivf_graph_*` counts from
info()["stats"] and the share of probes that replayed (None where the
engine has no such counts), the search retries, and the device memory
reserved at the window's start and end. The default write rate keeps the
puts under `ivf_delta_max`, so the index is not rebuilt (which would
start its counts anew) within a run.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Optional

import numpy as np

INGEST_BLOCK = 65536
POOL = 4096   # queries drawn from


def corpus(rows: int, dim: int, clusters: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = 3.0 * rng.standard_normal((clusters, dim), np.float32)
    x = centres[rng.integers(0, clusters, rows)]
    x += 0.4 * rng.standard_normal((rows, dim), np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _counts(engine) -> dict:
    st = engine.info()["stats"]
    return {n: v for n, v in st.items()
            if n.startswith("ivf_graph_") or n in ("searches",
                                                   "search_retries")}


def _reserved_mib(device) -> Optional[float]:
    import torch

    if device.type != "cuda":
        return None
    return round(torch.cuda.memory_reserved(device) / 2**20, 1)


def run(args, device) -> dict:
    from tpuvdb_torch.core.config import DBConfig
    from tpuvdb_torch.engine.engine import VectorDBEngine

    data = corpus(args.rows, args.dim, args.nlist, args.seed)
    engine = VectorDBEngine(DBConfig(
        vector_dim=args.dim, shard_count=4, index_type="ivf",
        storage_dtype="float32", ivf_nlist=args.nlist,
        ivf_nprobe=args.nprobe, ivf_kmeans_iters=6,
        ivf_train_sample=131072, wal_enabled=False,
        checkpoint_every_puts=10**12, compact_every_puts=10**12,
        search_coalesce=True), device=device)
    try:
        for lo in range(0, args.rows, INGEST_BLOCK):
            hi = min(lo + INGEST_BLOCK, args.rows)
            r = engine.put_rows([f"r{i}" for i in range(lo, hi)],
                                data[lo:hi])
            if not r.success:
                raise RuntimeError(f"put_rows at {lo}: {r.message}")
        engine.flush()
        batches = [int(b) for b in args.batches.split(",")]
        rng = np.random.default_rng(args.seed + 1)
        pool = data[rng.integers(0, args.rows, POOL)] + 0.05 * (
            rng.standard_normal((POOL, args.dim), np.float32))
        doomed = rng.permutation(args.rows)
        state = {"stop": 0.0, "timed": False, "deleted": 0, "puts": 0,
                 "deletes": 0}
        lat = [[] for _ in range(args.clients)]
        rows = [0] * args.clients
        errors = []

        def client(i):
            r = np.random.default_rng(args.seed + 2 + i)
            try:
                while time.perf_counter() < state["stop"]:
                    b = batches[r.integers(len(batches))]
                    lo = int(r.integers(0, POOL - b + 1))
                    t0 = time.perf_counter()
                    engine.search_batch(pool[lo:lo + b], args.k)
                    if state["timed"]:
                        lat[i].append(time.perf_counter() - t0)
                        rows[i] += b
            except Exception as e:   # noqa: BLE001 - raised below
                errors.append(e)

        def writer():
            r = np.random.default_rng(args.seed + 1000)
            n = 0
            try:
                while time.perf_counter() < state["stop"]:
                    new = pool[r.integers(0, POOL, args.puts)] + 0.01
                    engine.put_rows([f"w{n + j}" for j in range(args.puts)],
                                    new / np.linalg.norm(new, axis=1,
                                                         keepdims=True))
                    for _ in range(args.deletes):
                        engine.delete(f"r{doomed[state['deleted']]}")
                        state["deleted"] += 1
                    n += args.puts
                    if state["timed"]:
                        state["puts"] += args.puts
                        state["deletes"] += args.deletes
                    time.sleep(args.write_ms / 1e3)
            except Exception as e:   # noqa: BLE001 - raised below
                errors.append(e)

        def phase(seconds, timed):
            state["stop"] = time.perf_counter() + seconds
            state["timed"] = timed
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(args.clients)]
            threads.append(threading.Thread(target=writer))
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            return time.perf_counter() - t0

        phase(args.warm_seconds, False)
        before, mib0 = _counts(engine), _reserved_mib(device)
        wall = phase(args.seconds, True)
        after, mib1 = _counts(engine), _reserved_mib(device)
        got = {n: after[n] - before.get(n, 0) for n in after}
        graph = {n[len("ivf_graph_"):]: v for n, v in got.items()
                 if n.startswith("ivf_graph_")} or None
        s = np.sort(np.concatenate([np.asarray(x) for x in lat])) * 1e3
        out = {
            "bench": "ivf_mixed", "rows": args.rows, "dim": args.dim,
            "batches": batches, "clients": args.clients, "k": args.k,
            "seconds": round(wall, 3),
            "qps": round(sum(rows) / wall, 1),
            "requests_per_s": round(len(s) / wall, 1),
            "p50_ms": round(float(np.percentile(s, 50)), 3),
            "p95_ms": round(float(np.percentile(s, 95)), 3),
            "searches": got.get("searches"),
            "search_retries": got.get("search_retries"),
            "puts": state["puts"], "deletes": state["deletes"],
            "graph": graph,
            "replay_share": (round(graph["replays"] / max(1, sum(
                graph.values()) - graph["captures"]), 4)
                if graph else None),
            "reserved_mib": [mib0, mib1],
        }
        print(json.dumps(out), flush=True)
        return out
    finally:
        engine.close()


def main(argv=None, device: Optional[str] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=64)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--warm-seconds", type=float, default=5.0)
    ap.add_argument("--write-ms", type=float, default=20.0)
    ap.add_argument("--puts", type=int, default=8)
    ap.add_argument("--deletes", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from tpuvdb_torch.device import resolve_device

    return run(args, resolve_device(device or args.device))


if __name__ == "__main__":
    main()
