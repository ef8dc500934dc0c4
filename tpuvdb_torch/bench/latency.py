"""Host-inclusive search latency: the port of bench_latency.py.

    python -m tpuvdb_torch.bench.latency [--rows 100000] [--dim 512]
        [--reps 200] [--k 10] [--mode exact|approx|int8|pallas]
        [--index flat|ivf] [--device cuda]

The whole serving path an embedded `DBService` user waits for: a
JSON-shaped request dict in, the response dict out, through
`DBService.rpc_search` (b1) and `rpc_search_batch` (b8, b64): decoding,
the batcher, the device search, key mapping, the reply. --rows seeded
gaussian rows go in through put_rows, then each batch size runs 3 warm-up
calls and --reps timed ones on the host clock: p50, p95 and p99 a request
and the p50 a query.

The dispatch floor is the steady-state round trip of a micro cycle on the
device: upload a fresh 8 x 8 array, multiply it by itself, copy the result
back to numpy (p50 of 30). On the card that is the card's own floor; the
`*_minus_dispatch_ms` figures subtract it from the p50.

`--mode int8` (the default) stores int8 rows and scans them in "approx"
mode; the other modes are search modes over f32 rows (the reference's
mapping, bench_latency.py:43-57). Stdout takes one JSON line per batch
size with the reference's keys; the table, the floor, the engine's
stage timers and, for IVF, its probe-graph counts go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

BATCHES = (1, 8, 64)
WARM = 3
FLOOR_REPS = 30
INGEST_BLOCK = 65536


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def config(args):
    """The reference's DBConfig (bench_latency.py:43-57)."""
    from tpuvdb_torch.core.config import DBConfig

    storage = "int8" if args.mode == "int8" else "float32"
    search_mode = "approx" if args.mode == "int8" else args.mode
    return DBConfig(vector_dim=args.dim, shard_count=4,
                    shard_capacity=max(args.rows, 1024),
                    mirror_init_cap=max(args.rows, 1024) // 4 + 4096,
                    storage_dtype=storage, search_mode=search_mode,
                    index_type=args.index,
                    ivf_nlist=max(64, min(1024, args.rows // 256)),
                    ivf_nprobe=32, ivf_kmeans_iters=6)


def dispatch_floor_ms(device) -> float:
    """p50 ms of the micro cycle: upload an 8 x 8 array, x @ x, copy the
    result back to numpy."""
    import torch

    x_np = np.ones((8, 8), np.float32)

    def cycle():
        x = torch.from_numpy(x_np).to(device)
        return (x @ x).cpu().numpy()

    cycle()
    floor = []
    for _ in range(FLOOR_REPS):
        t0 = time.perf_counter()
        cycle()
        floor.append(time.perf_counter() - t0)
    return round(float(np.percentile(np.asarray(floor) * 1e3, 50)), 3)


def _request(svc, qs: np.ndarray, k: int):
    if len(qs) == 1:
        return svc.rpc_search({"query_vector": qs[0].tolist(), "top_k": k})
    return svc.rpc_search_batch({"query_vectors": qs.tolist(), "top_k": k})


def run(args, device) -> dict:
    """Prints one JSON line per batch size; returns {batch: row}."""
    from tpuvdb_torch.api.service import DBService

    svc = DBService(config(args), device=device)
    try:
        rng = np.random.default_rng(0)
        dispatch_ms = dispatch_floor_ms(device)
        log(f"dispatch floor (micro upload + product + copy-back cycle on "
            f"{device}): p50 {dispatch_ms} ms")
        log(f"ingest {args.rows} x {args.dim} ...")
        for lo in range(0, args.rows, INGEST_BLOCK):
            n = min(INGEST_BLOCK, args.rows - lo)
            vecs = rng.standard_normal((n, args.dim)).astype(np.float32)
            r = svc.engine.put_rows([f"k{lo + i}" for i in range(n)], vecs)
            if not r.success:
                raise RuntimeError(f"put_rows at {lo}: {r.message}")
        svc.engine.flush()

        results = {}
        for batch in BATCHES:
            qs = rng.standard_normal(
                (args.reps, batch, args.dim)).astype(np.float32)
            for w in range(WARM):
                _request(svc, qs[w], args.k)
            lat = []
            for r in range(args.reps):
                t0 = time.perf_counter()
                resp = _request(svc, qs[r], args.k)
                lat.append(time.perf_counter() - t0)
                if not resp["success"]:
                    raise RuntimeError(f"b{batch} request {r}: {resp}")
            s = np.sort(np.asarray(lat)) * 1e3  # ms a request
            per_q = s / batch
            p50 = float(np.percentile(s, 50))
            adj = max(0.0, p50 - dispatch_ms)
            row = {
                "batch": batch,
                "p50_ms": round(p50, 3),
                "p95_ms": round(float(np.percentile(s, 95)), 3),
                "p99_ms": round(float(np.percentile(s, 99)), 3),
                "per_query_p50_ms": round(float(np.percentile(per_q, 50)), 4),
                "p50_minus_dispatch_ms": round(adj, 3),
                "per_query_p50_minus_dispatch_ms": round(adj / batch, 4),
            }
            results[batch] = row
            print(json.dumps({
                "metric": f"search_latency_b{batch}",
                "unit": "ms_host_p50", "value": row["p50_ms"],
                "per_query_p50_ms": row["per_query_p50_ms"],
                "p99_ms": row["p99_ms"], "mode": args.mode,
                "index": args.index,
                "dispatch_floor_ms": dispatch_ms,
                "p50_minus_dispatch_ms": row["p50_minus_dispatch_ms"],
                "per_query_p50_minus_dispatch_ms":
                    row["per_query_p50_minus_dispatch_ms"],
                "rows": args.rows}), flush=True)

        log("batch  p50_ms  p95_ms  p99_ms  per-query p50 | minus-dispatch "
            "(batch / per-query)")
        for b, r in results.items():
            log(f"{b:5d}  {r['p50_ms']:6.3f}  {r['p95_ms']:6.3f}  "
                f"{r['p99_ms']:6.3f}  {r['per_query_p50_ms']:.4f} ms | "
                f"{r['p50_minus_dispatch_ms']:.3f} / "
                f"{r['per_query_p50_minus_dispatch_ms']:.4f} ms")
        log("per-stage timers (service.search = host-inclusive):")
        snap = svc.engine.timers.snapshot()
        for name in sorted(snap):
            log(f"  {name:24s} {snap[name]}")
        graphs = {n: v for n, v in svc.engine.info()["stats"].items()
                  if n.startswith("ivf_graph_") and v}
        if graphs:
            log(f"IVF probe graphs (index/probe_graphs.py): {graphs}")
        return results
    finally:
        svc.close()


def main(argv=None, device: Optional[str] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--mode", default="int8",
                    choices=["exact", "approx", "int8", "pallas"])
    ap.add_argument("--index", default="flat", choices=["flat", "ivf"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from tpuvdb_torch.device import resolve_device

    run(args, resolve_device(device or args.device))


if __name__ == "__main__":
    main()
