"""Engine-level IVF-PQ capacity: the port of scripts/bench_capacity_pq.py.

    python -m tpuvdb_torch.bench.capacity_pq [--rows 32000000] [--dim 768]
        [--subq 96] [--bits 8|4] [--nlist 4096] [--nprobe 16]
        [--data-dir D] [--batch 32] [--k 10] [--overfetch N] [--opq]
        [--skip-restart] [--out FILE] [--device cuda]

The whole engine on one card with IVF-PQ cells of --subq code bytes a row
(96: 8x below int8), in the reference's configuration: 4 shards, int8
mmap mirrors, nlist 4096, 8 k-means iterations on 262,144 sampled rows,
the exact host re-rank from the mirrors, the WAL off (durability is the
explicit checkpoint). In order:

  ingest    put_rows of 65,536-row blocks drawn into two reused buffers
            (4,096 centres x 3.0, 0.4 noise)
  build     the first flush: the streaming IVF-PQ build (sampled
            training, blockwise assignment and encoding, packing); its
            split between the build's memory tags is printed on stderr
            as `build split: {...}`
  recall    the exact scan over the stored int8 rows
            (capacity.stored_oracle), then the served recall@10 of 32
            held-out rows at nprobe --nprobe, 32 and 64, stopping at the
            first that reaches 0.96
  kernel    the PQ probe alone (`ivf.probe`: csrc/pq_probe.cu on the
            card) at b32 and b256 with k = 10 x max(rescore_overfetch,
            ivf_pq_rescore_overfetch), timed by `harness.chained_timer`
            (CUDA events on the card; the reference chains an on-device
            loop to see past its relay)
  serving   b32 and b256: QPS over 20 searches in one thread and over 64
            on 8 threads; the adaptive re-rank's counters
  durable   a checkpoint (codebooks and centroids, the packed codes),
            then a restart that must count every row, with its split

Ingest, build, QPS, checkpoint and restart are host-clock seconds. With
--out the JSON line is also written to FILE, and rewritten whole at each
stage boundary ("recall", "serving", "complete"), so a run that fails
leaves the stages it finished. Diagnostics go to stderr, and stdout takes
one JSON line with the reference's keys; `rss_stages` are the anonymous
RSS samples of `utils.hostmem.MEM_STAGES`. Divergences by design: a
failed serving batch or kernel timing raises (the reference records a
failed batch as 0.0 QPS and logs a failed timing), after `--out` holds the
stages that finished.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from tpuvdb_torch.bench.capacity import (nbytes, recall_of, rss_gb,
                                         stored_oracle)
from tpuvdb_torch.utils.hostmem import MEM_STAGES, anon_gb, memlog

SHARDS = 4
N_CLUSTERS = 4096
BLOCK = 65536        # rows drawn and put at a time
N_QUERIES = 32       # held-out rows whose recall is taken
SWEEP = (32, 64)     # nprobes tried after --nprobe
SWEEP_STOP = 0.96    # served recall that ends the sweep
ITERS = 20           # single-thread searches timed
PIPELINED = 64       # searches spread over 8 threads
KERNEL_ITERS = 10    # probe calls in a timed window
SERVE_BATCH = 256    # timed beside --batch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def config(args):
    """The reference's DBConfig (scripts/bench_capacity_pq.py:98-112)."""
    from tpuvdb_torch.core.config import DBConfig

    per_shard = (args.rows // SHARDS) + 65536
    return DBConfig(
        vector_dim=args.dim, shard_count=SHARDS, shard_capacity=per_shard,
        mirror_init_cap=per_shard, mirror_dtype="int8",
        mirror_backend="mmap",
        index_type="ivf", ivf_pq_subq=args.subq, ivf_pq_bits=args.bits,
        ivf_opq=args.opq,
        ivf_nlist=args.nlist, ivf_nprobe=args.nprobe,
        ivf_kmeans_iters=8, ivf_train_sample=262_144,
        rescore_mode="exact", rescore_overfetch=10,
        **({"ivf_pq_rescore_overfetch": args.overfetch}
           if args.overfetch else {}),
        wal_enabled=False,
        checkpoint_every_puts=10 ** 12, compact_every_puts=10 ** 12,
        flush_batch=1 << 30,
    )


class _TagTimes(logging.Handler):
    """Collects (tag, record.created) of each memlog line."""

    def __init__(self):
        super().__init__()
        self.tags = []

    def emit(self, record):
        self.tags.append((record.args[0], record.created))


def timed_build(eng):
    """eng.flush() with `tpuvdb_torch.memlog` logging on: (seconds,
    {tag: seconds since the previous tag}), the first tag counted from the
    flush's start and "flush end" from the last tag."""
    logger = logging.getLogger("tpuvdb_torch.memlog")
    handler = _TagTimes()
    logger.addHandler(handler)
    before = os.environ.get("TPUVDB_MEMLOG")
    os.environ["TPUVDB_MEMLOG"] = "1"
    try:
        start = time.time()
        t0 = time.perf_counter()
        eng.flush()
        build_s = time.perf_counter() - t0
        end = time.time()
    finally:
        logger.removeHandler(handler)
        if before is None:
            del os.environ["TPUVDB_MEMLOG"]
        else:
            os.environ["TPUVDB_MEMLOG"] = before
    split, prev = {}, start
    for tag, created in handler.tags:
        split[tag] = created - prev
        prev = created
    split["flush end"] = end - prev
    return build_s, split


def run(args, device, data_dir: str) -> tuple:
    """The bench's stages: (the result line, the index the engine ends
    with: the restarted engine's, else the built one)."""
    from tpuvdb_torch.bench.harness import chained_timer
    from tpuvdb_torch.engine.engine import VectorDBEngine
    from tpuvdb_torch.utils.hostmem import keep_malloc_warm

    keep_malloc_warm()
    n_rows, dim, k = args.rows, args.dim, args.k
    cfg = config(args)
    log(f"device: {device}, rows={n_rows}, dim={dim}, subq={args.subq}, "
        f"bits={args.bits}, nlist={args.nlist}, data_dir={data_dir}, "
        f"base rss {rss_gb():.2f} GB")
    eng = VectorDBEngine(cfg, data_dir=data_dir, device=device)

    rng = np.random.default_rng(0)
    cents = rng.standard_normal((N_CLUSTERS, dim)).astype(np.float32) * 3.0
    t0 = time.perf_counter()
    held_out = None
    noise = np.empty((BLOCK, dim), np.float32)  # reused: no fresh pages
    block = np.empty((BLOCK, dim), np.float32)
    for lo in range(0, n_rows, BLOCK):
        n = min(BLOCK, n_rows - lo)
        cid = rng.integers(0, N_CLUSTERS, n)
        rng.standard_normal(out=noise[:n], dtype=np.float32)
        np.multiply(noise[:n], 0.4, out=block[:n])
        block[:n] += cents[cid]
        r = eng.put_rows([f"k{i}" for i in range(lo, lo + n)], block[:n])
        if not r.success:
            raise RuntimeError(f"put_rows at {lo}: {r.message}")
        if lo == 0:
            held_out = block[:64].copy()
        if (lo // BLOCK) % 64 == 0:
            log(f"  ingested {lo + n:,}/{n_rows:,} rows, rss "
                f"{rss_gb():.2f} GB")
    ingest_s = time.perf_counter() - t0
    log(f"ingest: {n_rows / ingest_s:,.1f} rows/s ({ingest_s:.3f}s), rss "
        f"{rss_gb():.2f} GB, anon {anon_gb():.2f} GB")
    memlog("bench: ingest done")

    build_s, split = timed_build(eng)
    log("build split: " + json.dumps(split))
    ivf = eng._ivf
    code_gib = (nbytes(ivf.grouped) + nbytes(ivf.grouped_sq)
                + nbytes(ivf.spill)) / 2 ** 30
    st = ivf.stats()
    log(f"IVF-PQ build: {build_s:.3f}s, codes+norms {code_gib:.4f} GiB on "
        f"the device (nlist={st.nlist}, cell_pad={st.cell_pad}, "
        f"fill={st.fill:.2f}, spill={st.spill_rows}), rss {rss_gb():.2f} GB, "
        f"anon {anon_gb():.2f} GB")

    queries = held_out[:N_QUERIES]
    t0 = time.perf_counter()
    oracle_keys = stored_oracle(eng, queries, k, eng._ivf_layout)
    log(f"oracle scan: {time.perf_counter() - t0:.3f}s")
    memlog("bench: oracle done")

    def served_recall():
        _, ks = eng.search_batch(queries, k)
        return recall_of([row[:k] for row in ks], oracle_keys, k)

    sweep = {}
    nprobe_used = args.nprobe
    for np_ in sorted({args.nprobe, *SWEEP}):
        if np_ > eng._ivf.nlist:
            continue
        eng._ivf.nprobe = np_
        t0 = time.perf_counter()
        r_ = served_recall()
        sweep[np_] = r_
        log(f"served recall@{k} nprobe={np_}: {r_:.4f} "
            f"({time.perf_counter() - t0:.3f}s)")
        nprobe_used = np_
        if r_ >= SWEEP_STOP:
            break
    eng._ivf.nprobe = nprobe_used
    recall = sweep[nprobe_used]
    log(f"recall@{k} vs exact-over-stored: {recall:.4f} (nprobe "
        f"{nprobe_used})")

    metric = (f"engine_capacity_pq_{n_rows // 10**6}m{dim}"
              + ("" if args.bits == 8 else f"_b{args.bits}"))

    def write_partial(stage, extra):
        if not args.out:
            return
        part = {
            "metric": metric,
            "rows": n_rows, "dim": dim, "pq_subq": args.subq,
            "pq_bits": args.bits, "opq": args.opq, "stage": stage,
            "ingest_rows_per_s": round(n_rows / ingest_s, 1),
            "build_s": round(build_s, 1),
            "codes_gib_hbm": round(code_gib, 2),
            "recall_at_10": round(recall, 4),
            "recall_sweep": {str(k_): round(v, 4)
                             for k_, v in sweep.items()},
            "peak_rss_gb": round(rss_gb(), 2),
            "anon_rss_gb": round(anon_gb(), 2),
            "rss_stages": [list(t) for t in MEM_STAGES],
        }
        part.update(extra)
        with open(args.out, "w") as f:
            f.write(json.dumps(part) + "\n")

    write_partial("recall", {})

    kk = k * max(cfg.rescore_overfetch, cfg.ivf_pq_rescore_overfetch)
    kernel = {}
    for name, b in (("b32", 32), ("b256", 256)):
        qb = torch.from_numpy(np.ascontiguousarray(
            np.tile(queries, (max(1, b // len(queries) + 1), 1))[:b])).to(
                device)
        t0 = time.perf_counter()
        d_, _ = ivf.probe(qb, kk, nprobe_used)
        d_.cpu()
        log(f"kernel {name}: first call {time.perf_counter() - t0:.3f}s")
        sec = chained_timer(ivf.probe, (qb, kk, nprobe_used),
                            iters=KERNEL_ITERS, reps=3)
        ms = sec * 1000
        kernel[name] = {"ms_per_batch": round(ms, 3),
                        "qps": round(b / ms * 1000, 1)}
        log(f"kernel {name}: {ms:.4f} ms/batch -> {b / ms * 1000:,.1f} QPS "
            f"(k={kk}, nprobe={nprobe_used})")

    serving = {}
    for b in sorted({args.batch, SERVE_BATCH}):
        qbatch = rng.standard_normal((b, dim)).astype(np.float32) * 0.1
        qbatch += cents[rng.integers(0, N_CLUSTERS, b)]
        eng.search_batch(qbatch, k)  # warm
        t0 = time.perf_counter()
        for _ in range(ITERS):
            eng.search_batch(qbatch, k)
        single_b = b * ITERS / (time.perf_counter() - t0)
        with ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda _: eng.search_batch(qbatch, k),
                          range(PIPELINED)))
            piped_b = b * PIPELINED / (time.perf_counter() - t0)
        serving[b] = (single_b, piped_b)
        log(f"engine serving b{b}: {single_b:,.1f} QPS single-stream, "
            f"{piped_b:,.1f} QPS pipelined x8")
    single, piped = serving[args.batch]
    resc = {k_: int(eng.stats.get(k_, 0))
            for k_ in ("rescored_rows", "rescore_skipped_rows")}
    tot = resc["rescored_rows"] + resc["rescore_skipped_rows"]
    if tot:
        resc["skip_frac"] = round(resc["rescore_skipped_rows"] / tot, 4)
    log(f"adaptive rescore: {resc}")
    memlog("bench: serving done")
    serving_by_batch = {str(b): [round(s_, 1), round(p_, 1)]
                        for b, (s_, p_) in serving.items()}
    write_partial("serving", {
        "kernel_probe": kernel,
        "engine_qps_single": round(single, 1),
        "engine_qps_pipelined": round(piped, 1),
        "serving_by_batch": serving_by_batch,
        "adaptive_rescore": resc,
    })

    t0 = time.perf_counter()
    ck = eng.save_checkpoint()
    ckpt_s = time.perf_counter() - t0
    log(f"checkpoint: {ckpt_s:.3f}s -> {ck}")
    restart_s = None
    restart_split = None
    if not args.skip_restart:
        del eng, ivf
        t0 = time.perf_counter()
        eng = VectorDBEngine(cfg, data_dir=data_dir, device=device)
        t_init = time.perf_counter() - t0
        if eng.count() != n_rows:
            raise AssertionError(f"the restarted engine counts "
                                 f"{eng.count()} rows, {n_rows} were put")
        eng.flush()  # the packed upload, no re-encode
        t_flush = time.perf_counter() - t0 - t_init
        _, k2 = eng.search_batch(queries, k)
        if any(k2[0][j] is None for j in range(k)):
            raise AssertionError(f"the restarted engine's first answer has "
                                 f"empty hits: {k2[0]}")
        restart_s = time.perf_counter() - t0
        restart_split = {"init_s": round(t_init, 1),
                         "index_s": round(t_flush, 1),
                         "first_search_s": round(
                             restart_s - t_init - t_flush, 1),
                         "packed_restores": eng.stats.get(
                             "ivf_packed_restores", 0)}
        r2 = recall_of([row[:k] for row in k2], oracle_keys, k)
        log(f"restart-with-recovery: {restart_s:.3f}s {restart_split} "
            f"(count={eng.count():,}, recall {r2:.4f}), rss "
            f"{rss_gb():.2f} GB")

    return {
        "metric": metric,
        "rows": n_rows, "dim": dim, "pq_subq": args.subq,
        "pq_bits": args.bits,
        "nprobe": nprobe_used,
        "ingest_rows_per_s": round(n_rows / ingest_s, 1),
        "build_s": round(build_s, 1),
        "codes_gib_hbm": round(code_gib, 2),
        "recall_at_10": round(recall, 4),
        "recall_sweep": {str(k_): round(v, 4) for k_, v in sweep.items()},
        "kernel_probe": kernel,
        "engine_qps_single": round(single, 1),
        "engine_qps_pipelined": round(piped, 1),
        "serving_by_batch": serving_by_batch,
        "checkpoint_s": round(ckpt_s, 1),
        "restart_s": round(restart_s, 1) if restart_s else None,
        "restart_split": restart_split,
        "peak_rss_gb": round(rss_gb(), 2),
        "anon_rss_gb": round(anon_gb(), 2),
        "adaptive_rescore": resc,
        "pq_err": round(getattr(eng._ivf, "pq_err", 0.0), 4),
        "opq": args.opq,
        "stage": "complete",
        "rss_stages": [list(t) for t in MEM_STAGES],
    }, eng._ivf


def main(argv=None, device: Optional[str] = None) -> tuple:
    """Prints the result line; returns (the line's dict, the index)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=32_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--subq", type=int, default=96)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4),
                    help="4 = the fast-scan tier: the same bytes a row, "
                         "2 x subq subspaces of 16 codes")
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--overfetch", type=int, default=None,
                    help="ivf_pq_rescore_overfetch (default: the config's)")
    ap.add_argument("--opq", action="store_true",
                    help="a learned OPQ rotation of the residual space")
    ap.add_argument("--skip-restart", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from tpuvdb_torch.device import resolve_device

    dev = resolve_device(device or args.device)
    data_dir = args.data_dir or tempfile.mkdtemp(prefix="tpuvdb_torch_pq_")
    try:
        out, index = run(args, dev, data_dir)
    finally:
        if args.data_dir is None:
            shutil.rmtree(data_dir)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out, index


if __name__ == "__main__":
    main()
