"""The IVF-PQ recall grid on a kept corpus: the port of
scripts/diag_pq_recall.py.

    python -m tpuvdb_torch.bench.diag_pq_recall --data-dir D
        [--rows 8000000] [--dim 768] [--subq 96] [--nlist 4096]
        [--nprobes 16,64] [--overfetches 10,40,100] [--k 10]
        [--device cuda]

Reopens the data dir that `python -m tpuvdb_torch.bench.capacity_pq
--data-dir D` left (its checkpoint: the mirrors, the codebooks and
centroids, the packed codes) with that bench's configuration, flushes it
(the index comes back from the packed file, or is encoded again), and
sweeps nprobe x `rescore_overfetch` over the bench's 32 held-out queries,
regenerated draw for draw from its first ingest block. Each cell's
recall@10 is taken against the exact scan of the stored int8 rows
(capacity.stored_oracle, on the engine's device), so the grid separates
the two recall ceilings:

  * recall that rises with nprobe: under-probing (the true neighbours
    sit in cells the probe never opened);
  * recall that rises with overfetch at a fixed nprobe: the ADC precision
    cap (the neighbours were probed but ranked outside the re-rank window
    k x max(rescore_overfetch, ivf_pq_rescore_overfetch)).

The PQ probe of csrc/pq_probe.cu runs every search on the card. Stdout
takes one JSON line, {"metric": "pq8m_recall_vs_nprobe", "results":
{"np{N}_ov{O}": {"recall_at_10", "batch32_ms", "window"}}}; `window` (the
candidates re-ranked) is the port's addition. With fewer than 65,536
--rows the first block, and so the queries, is the bench's own smaller
block (the reference always draws 65,536 rows).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

from tpuvdb_torch.bench.capacity import recall_of, stored_oracle
from tpuvdb_torch.bench.capacity_pq import BLOCK, N_CLUSTERS, N_QUERIES


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_queries(rows: int, dim: int) -> np.ndarray:
    """capacity_pq's held-out queries: the first N_QUERIES rows of its
    first ingest block, drawn as it draws them."""
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((N_CLUSTERS, dim)).astype(np.float32) * 3.0
    n = min(BLOCK, rows)
    cid = rng.integers(0, N_CLUSTERS, n)
    noise = rng.standard_normal((n, dim), dtype=np.float32)
    block = noise * 0.4 + cents[cid]
    return block[:N_QUERIES].copy()


def main(argv=None, device: Optional[str] = None) -> dict:
    """Prints the result line and returns it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--rows", type=int, default=8_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--subq", type=int, default=96)
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--nprobes", default="16,64")
    ap.add_argument("--overfetches", default="10,40,100")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    nprobes = [int(x) for x in args.nprobes.split(",")]
    overfetches = [int(x) for x in args.overfetches.split(",")]
    k = args.k

    from tpuvdb_torch.bench import capacity_pq
    from tpuvdb_torch.device import resolve_device
    from tpuvdb_torch.engine.engine import VectorDBEngine

    dev = resolve_device(device or args.device)
    queries = bench_queries(args.rows, args.dim)
    cfg = capacity_pq.config(argparse.Namespace(
        rows=args.rows, dim=args.dim, subq=args.subq, bits=8, opq=False,
        nlist=args.nlist, nprobe=nprobes[0], overfetch=None))
    t0 = time.perf_counter()
    # never closed, as in the reference: a close would checkpoint into D
    eng = VectorDBEngine(cfg, data_dir=args.data_dir, device=dev)
    log(f"engine open {time.perf_counter() - t0:.1f}s on {dev}, "
        f"count={eng.count():,}")
    # the index comes back at the first flush: from the packed file when
    # the checkpoint holds one, else assigned and encoded again
    t0 = time.perf_counter()
    eng.flush()
    log(f"ivf rebuild: {time.perf_counter() - t0:.1f}s, packed restores "
        f"{eng.stats.get('ivf_packed_restores', 0)}")

    t0 = time.perf_counter()
    oracle_keys = stored_oracle(eng, queries, k, eng._ivf_layout)
    log(f"oracle scan: {time.perf_counter() - t0:.1f}s")

    results = {}
    for nprobe in nprobes:
        eng._ivf.nprobe = nprobe
        for ovf in overfetches:
            eng.config.rescore_overfetch = ovf
            window = k * max(ovf, cfg.ivf_pq_rescore_overfetch)
            eng.search_batch(queries, k)  # warm at this config
            t0 = time.perf_counter()
            _, keys = eng.search_batch(queries, k)
            dt = time.perf_counter() - t0
            rec = recall_of([row[:k] for row in keys], oracle_keys, k)
            log(f"nprobe={nprobe} overfetch={ovf} (window {window}): "
                f"recall@{k} {rec:.4f}, batch-32 search {dt * 1000:.1f} ms")
            results[f"np{nprobe}_ov{ovf}"] = {
                "recall_at_10": round(rec, 4),
                "batch32_ms": round(dt * 1000, 1),
                "window": window}
    out = {"metric": "pq8m_recall_vs_nprobe", "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
