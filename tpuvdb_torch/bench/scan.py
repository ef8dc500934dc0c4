"""Headline benchmark: scan QPS per card on a SIFT1M-shaped corpus
(1M x 128): the port of tpuvdb.bench.scan.

    python -m tpuvdb_torch.bench.scan     (or: cli bench --suite scan)

It times the reference's paths on `device` at k = 10 and reports the
fastest that clears the recall bar:

  approx_bf16       kernels/distance.l2sq_topk(mode="approx"), bf16 rows:
                    the bucketed scan kernel (csrc/scan.cu), Q = 256
  pallas_bf16       kernels/scan.scan_l2sq_topk(n_buckets=512), Q = 256
  pallas_bf16_b512  the same at Q = 512
  int8, int8_b128   kernels/quant.l2sq_topk_int8 (torch ops), Q = 256, 128
  int8_rescored     kernels/quant.l2sq_topk_int8_rescored(fetch=32)

then the served path (bench/engine_serving.py): the flat bf16 engine at
b512 and the IVF engine (nlist 1024, nprobe 64) at b8. Recall@10 is
taken on the first 64 queries against an exact numpy scan.

The corpus is SIFT1M where $TPUVDB_DATASET_DIR holds it, else the
reference's seeded adversarial corpus (bench/datasets.adversarial_corpus,
draw for draw), padded with invalid rows to a multiple of 65,536. Times
are `bench/harness.chained_timer`'s: CUDA events on the card, the host
clock on the CPU.

Output: diagnostics on stderr. On stdout one JSON line per finished stage,
{"stage": <path> | "engine" | "ivf", ...} with its numbers, so a run that
is cut still leaves what it measured; then the last line with the
reference's keys. `vs_baseline` divides by the north-star target of
50,000 QPS, a target and not a measurement.

Divergences by design from the reference:
  * the pallas paths run on every device: the scan kernel on the card, its
    plain twin on the CPU (the reference runs them on a TPU only);
  * `capacity_pq` is null: the reference fills it from docs/BENCH_PQ*.json,
    the results of runs on a TPU, and the port publishes no TPU figure;
  * nothing is caught: a failure of the engine stage ends the run with its
    exception after the stage lines already printed (the reference
    publishes {"error": ...} and exits 0), and a time that is not positive
    raises in chained_timer (the reference skips the path).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

N, DIM, K = 1_000_000, 128, 10
Q_BATCH = 256
MAX_BATCH = 512       # the widest batch of a path below
BLOCK = 65536         # the corpus pads to a multiple of this
RECALL_TARGET = 0.95
N_CHECK = 64          # queries whose recall is taken
SERVE_BATCH = 512
TARGET_QPS = 50_000.0
RECALL_BARS = (0.97, 0.95, 0.0)  # the headline's bar, then the fallbacks


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _stage(name: str, numbers: dict) -> None:
    print(json.dumps({"stage": name, **numbers}), flush=True)


def load_corpus(n: int = N, dim: int = DIM, log=log):
    """(corpus (n, dim) f32, queries (MAX_BATCH, dim) f32, dataset note):
    SIFT1M when it is at hand, else the adversarial corpus and gaussian
    queries, all drawn from one default_rng(0) as the reference does."""
    from tpuvdb_torch.bench.datasets import (adversarial_corpus,
                                             sift1m_if_available)

    rng = np.random.default_rng(0)
    real = sift1m_if_available(max_rows=n)
    if real is not None:
        corpus_np, queries_real = real
        n, dim = corpus_np.shape
        note = f"real SIFT1M {n}x{dim}"
        log(f"using real SIFT1M: {n} x {dim}")
    else:
        root = os.environ.get("TPUVDB_DATASET_DIR", "<unset>")
        note = (f"synthetic-adversarial (real dataset absent: "
                f"TPUVDB_DATASET_DIR={root} has no sift/sift_base.fvecs)")
        log("synthesizing adversarial clustered corpus")
        corpus_np = adversarial_corpus(n, dim, rng)
        queries_real = None
    if queries_real is not None and len(queries_real) >= MAX_BATCH:
        queries_np = queries_real[:MAX_BATCH].astype(np.float32)
    else:
        queries_np = rng.standard_normal((MAX_BATCH, dim)).astype(np.float32)
    return corpus_np, queries_np, note


def padded_arrays(corpus_np: np.ndarray):
    """(padded rows, their squared norms, valid mask), padded with zero,
    invalid rows to a multiple of BLOCK as the reference pads."""
    n, dim = corpus_np.shape
    n_pad = -(-n // BLOCK) * BLOCK
    padded = np.zeros((n_pad, dim), np.float32)
    padded[:n] = corpus_np
    sq = np.zeros(n_pad, np.float32)
    sq[:n] = np.einsum("nd,nd->n", corpus_np, corpus_np)
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    return padded, sq, valid


def run(device=None, log=log) -> dict:
    """Runs every stage on `device` (None = cuda), printing each stage's
    line as it finishes; returns the last line's record."""
    from tpuvdb_torch.bench import engine_serving
    from tpuvdb_torch.bench.harness import chained_timer
    from tpuvdb_torch.device import resolve_device
    from tpuvdb_torch.kernels.distance import l2sq_topk, numpy_oracle
    from tpuvdb_torch.kernels.quant import (l2sq_topk_int8,
                                            l2sq_topk_int8_rescored,
                                            quantize_rows_np)
    from tpuvdb_torch.kernels.scan import scan_l2sq_topk

    dev = resolve_device(device)
    name_of = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu")
    log(f"device: {dev} {name_of}")
    corpus_np, queries_np, dataset_note = load_corpus(log=log)
    n, dim = corpus_np.shape
    padded, sq_np, valid_np = padded_arrays(corpus_np)
    ci8_np, scales_np = quantize_rows_np(padded)
    corpus_f32 = torch.from_numpy(padded).to(dev)
    corpus_bf16 = corpus_f32.to(torch.bfloat16)
    del corpus_f32
    corpus_i8 = torch.from_numpy(ci8_np).to(dev)
    row_scales = torch.from_numpy(scales_np).to(dev)
    sqnorms = torch.from_numpy(sq_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    del padded, ci8_np

    def approx_fn(q, c, s, v):
        return l2sq_topk(q, c, s, v, k=K, mode="approx",
                         recall_target=RECALL_TARGET, block_size=BLOCK)

    def pallas_fn(q, c, s, v):
        return scan_l2sq_topk(q, c, s, v, k=K, n_buckets=512)

    def int8_fn(q, c, r, s, v):
        return l2sq_topk_int8(q, c, r, s, v, k=K, block_size=BLOCK)

    # the int8 scan with an exact re-rank of 32 candidates a query on the
    # device: removes the query's quantization and the selection error
    def int8_rescored_fn(q, c, r, s, v):
        return l2sq_topk_int8_rescored(q, c, r, s, v, k=K, fetch=32,
                                       block_size=BLOCK)

    bf16_arrays = (corpus_bf16, sqnorms, valid)
    int8_arrays = (corpus_i8, row_scales, sqnorms, valid)
    paths = {
        "approx_bf16": (approx_fn, bf16_arrays, Q_BATCH),
        "int8": (int8_fn, int8_arrays, Q_BATCH),
        "int8_b128": (int8_fn, int8_arrays, 128),
        "int8_rescored": (int8_rescored_fn, int8_arrays, Q_BATCH),
        "pallas_bf16": (pallas_fn, bf16_arrays, Q_BATCH),
        # 512-query tiles amortize one corpus sweep over twice the queries
        "pallas_bf16_b512": (pallas_fn, bf16_arrays, MAX_BATCH),
    }

    _, oidx = numpy_oracle(queries_np[:N_CHECK], corpus_np,
                           np.ones(n, bool), K)

    results = {}
    for name, (fn, arrays, batch_n) in paths.items():
        bq = queries[:batch_n]
        t0 = time.perf_counter()
        _, idx = fn(bq, *arrays)
        got = idx[:N_CHECK].cpu().numpy()
        log(f"{name}: first call {time.perf_counter() - t0:.3f} s")
        recall = float(np.mean([len(set(got[i]) & set(oidx[i])) / K
                                for i in range(N_CHECK)]))
        best = chained_timer(fn, (bq, *arrays))
        results[name] = {"qps": batch_n / best, "recall_at_10": recall,
                         "batch": batch_n, "batch_latency_ms": best * 1e3}
        log(f"{name}: {best * 1e3:.3f} ms/batch -> {batch_n / best:,.0f} "
            f"QPS, recall@10 {recall:.4f}")
        _stage(name, results[name])
    del corpus_bf16, corpus_i8, row_scales, sqnorms, valid, queries
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the served path: the engine end to end at the serving batch (device
    # scan, delta merge, key resolution, assembly), and IVF at b8
    kb = results["pallas_bf16_b512"]
    kernel_ms = kb["batch_latency_ms"] * SERVE_BATCH / kb["batch"]
    serving = engine_serving.run_engine_serving(
        corpus_np, queries_np, oidx, k=K, batch=SERVE_BATCH,
        kernel_ms_per_batch=kernel_ms,
        search_mode="pallas" if dev.type == "cuda" else "approx",
        log=log, device=dev)
    _stage("engine", serving)
    ivf = engine_serving.run_ivf_small_batch(corpus_np, queries_np, k=K,
                                             log=log, device=dev)
    _stage("ivf", ivf)

    # the headline path clears 0.97 where one does (a thin margin over
    # the 0.95 floor is not headlined), else 0.95, else any
    for bar in RECALL_BARS:
        qualifying = {p: r for p, r in results.items()
                      if r["recall_at_10"] >= bar}
        if qualifying:
            break
    best_name = max(qualifying, key=lambda p: qualifying[p]["qps"])
    best = results[best_name]
    return {
        "metric": "scan_qps_per_chip_sift1m_shape",
        "value": best["qps"],
        "unit": "qps",
        "vs_baseline": best["qps"] / TARGET_QPS,
        "recall_at_10": best["recall_at_10"],
        "best_path": best_name,
        "batch": best["batch"],
        "corpus": [n, dim],
        "dataset": dataset_note,
        "paths": results,
        "engine": {**serving, **ivf},
        "capacity_pq": None,
    }


def main(device: Optional[str] = None):
    print(json.dumps(run(device)), flush=True)


if __name__ == "__main__":
    main()
