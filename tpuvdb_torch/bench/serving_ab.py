"""Serving A/B, search coalescing off against on: the port of
scripts/bench_serving_ab.py.

    python -m tpuvdb_torch.bench.serving_ab [--rows 1000000] [--dim 128]
        [--batches 32,512] [--threads 8] [--device cuda]

Runs the same engine serving bench (bench/engine_serving.py: the flat bf16
engine, search_mode "pallas", so the scan kernel of csrc/scan.cu on the
card) with `search_coalesce` off and on, at each client batch, on one
seeded corpus (rng(0): --rows x --dim normals, then 2,048 queries), so the
coalescing default is set by measurement. Diagnostics go to stderr, and
stdout takes one JSON line with the reference's keys: for each
`b{B}_{direct|coalesce}`, the single-stream and pipelined QPS, the
coalescer's group sizes (None when direct) and the run's wall seconds.
`main` also returns the first answer of each run's engine to its batch of
queries (`answers`), which the line leaves out.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

N_QUERIES = 2048


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None, device: Optional[str] = None) -> tuple:
    """Prints the result line; returns (its dict, {tag: (distances, keys)}
    of each run's first search)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batches", default="32,512")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpuvdb_torch.bench.engine_serving import run_engine_serving
    from tpuvdb_torch.device import resolve_device

    dev = resolve_device(device or args.device)
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((args.rows, args.dim)).astype(np.float32)
    queries = rng.standard_normal((N_QUERIES, args.dim)).astype(np.float32)

    out = {"metric": "serving_coalesce_ab", "rows": args.rows,
           "dim": args.dim, "threads": args.threads, "ab": {}}
    answers = {}
    for b in (int(x) for x in args.batches.split(",")):
        for coalesce in (False, True):
            tag = f"b{b}_{'coalesce' if coalesce else 'direct'}"
            log(f"--- {tag} ---")
            t0 = time.perf_counter()
            stats = run_engine_serving(
                corpus, queries, None, batch=b, threads=args.threads,
                coalesce=coalesce, log=log, device=dev, keep_answer=True)
            out["ab"][tag] = {
                "qps_single": stats.get("engine_qps_single"),
                "qps_pipelined": stats.get("engine_qps_pipelined"),
                "groups": stats.get("search_groups"),
                "wall_s": round(time.perf_counter() - t0, 1),
            }
            answers[tag] = stats["first_answer"]
    print(json.dumps(out), flush=True)
    return out, answers


if __name__ == "__main__":
    main()
