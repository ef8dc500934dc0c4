"""Smoke run of the PyTorch/CUDA port (tpuvdb_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It runs every phase, in this order; any failure exits non-zero, and nothing
is caught and carried on. The kernels (csrc/scan.cu, csrc/ivf_probe.cu) are
built first with nvcc for sm_90a, one nvcc per source, side by side.

  kernel      Holds the scan
              kernel against its plain PyTorch version on 1,048,576 x 512
              corpora in f32 and bf16 (about 1% dead rows), at Q = 1, 64
              and 256, plus a ragged N. Candidate rows must agree in >= 99.9%
              of (query, bucket) slots and every candidate score within
              rtol 1e-5 + atol 1e-3 (rows differ only at near-ties); the
              top-10 distances within rtol 1e-5. The same checks run on
              70,001-row corpora whose width or alignment leaves the
              kernel's vector loads (d = 99 and 100, a corpus pointer off
              16 bytes). Prints the kernel's time,
              the plain version's, `library_ms` (torch.topk over
              2 q.x^T - |x|^2, a yardstick the port never calls) and the
              bound, each in ms.
  engine      The port's main path at real size: DBConfig(vector_dim=512),
              4 shards, f32, search_mode="approx". Ingests 1,000,000 seeded
              unit vectors with put_rows (device corpus 1,048,576 x 512 f32),
              searches batches of 1, 32 and 256 at k=10 through search_batch
              (110 closed-loop searches each: p50, p90, QPS as all the
              queries over all the time, and the engine's own stage
              timers; then 10 b256 searches under torch.profiler for the
              device's busy share) and through search(SearchRequest), and
              requires recall@10 >= 0.95 against an exact scan of the same
              device corpus. Then
              overwrites, deletes and gets a few keys and checks that
              searches see the changes before and after flush(). The scan
              kernel's launch count is zeroed before this phase and read
              after it; it must be > 0.
  durability  A data_dir engine with the WAL on, 50,000 rows: checkpoint,
              more puts and deletes, then reopen twice (after a crash that
              leaves a WAL tail to replay, and after close()); search
              results and count() must be identical each time.
  ivf kernel  Builds an IVFIndex (nlist 1,024, nprobe 64) over a clustered
              1,048,576 x 512 corpus with ~1% dead rows and holds both IVF
              probe kernels against their plain twins, f32 and bf16, at
              Q = 1, 8 and 256: the expanded form as the search picks it,
              the compact form through force_compact, and the compact form
              at Q = 1,024 with a probe set above 2**20 entries. Candidate
              ids must agree in >= 99.9% of slots; scores and top-10
              distances within 1e-5 of 2|q||x|max + |x|max^2 (f32 sums of
              d products taken in another order). Prints each kernel's
              time, its plain twin's and its bound (there is no single
              PyTorch call that computes the probe: library_ms is null).
  ivf engine  The reference's IVF serving configuration
              (tpuvdb/bench/engine_serving.py:158-165): DBConfig(vector_dim=
              512, index_type="ivf", ivf_nlist=1024, ivf_nprobe=64,
              ivf_kmeans_iters=6, ivf_train_sample=131072, wal_enabled=
              False), 4 shards, f32, over 1,000,000 rows of a seeded copy of
              tpuvdb/bench/datasets.py:55-72 (clustered, 1,024 clusters,
              spread 0.4). Build time (put_rows + flush); b1, b8, b32 and
              b256 at k=10 (110 closed-loop searches each: p50, p90, QPS
              over the window); b256 under torch.profiler; recall@10 >= 0.95
              against an exact scan of the same rows. The probe launches
              are zeroed before this phase and read after it; the expanded
              kernel's must be > 0. Then one IVFIndex.search at b1,024 with
              nprobe chosen so Q * nprobe * w128 > 2**20, which takes the
              compact form (its launches, zeroed before, must be > 0), with
              its recall; overwrite, delete and get before and after flush;
              a delta overflow that drains by append; and a 50,000-row
              data_dir restart that reuses the warm centroids (k-means is
              made to fail) and returns identical keys.

The last two lines of standard output are the card's name and power limit
(as nvidia-smi reports them) and the JSON result line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth,
# f32 outside the tensor cores, dense bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

SCAN_N = 1 << 20
SCAN_D = 512
SCAN_QS = (1, 64, 256)
BUCKETS = 512
SLOT_AGREE_MIN = 0.999
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-3
TOPK_RTOL = 1e-5
# (d, corpus dtype, corpus pointer offset in elements)
RAGGED_WIDTHS = ((100, torch.float32, 0), (99, torch.float32, 0),
                 (128, torch.float32, 1), (100, torch.bfloat16, 0),
                 (96, torch.bfloat16, 1))
RAGGED_N, RAGGED_Q = 70_001, 37

ENGINE_ROWS = 1_000_000
ENGINE_BATCHES = (1, 32, 256)
SEARCH_REPS = 110  # p90 then has 11 samples beyond it
RECALL_MIN = 0.95
DURABLE_ROWS = 50_000

IVF_N = 1 << 20
IVF_D = 512
IVF_NLIST = 1024
IVF_NPROBE = 64
IVF_QS = (1, 8, 256)
IVF_COMPACT_Q = 1024     # with a probe set above 2**20 entries
IVF_SCORE_TOL = 1e-5     # of 2|q||x|max + |x|max^2 per query
IVF_ENGINE_ROWS = 1_000_000
IVF_BATCHES = (1, 8, 32, 256)
IVF_RESTART_ROWS = 50_000


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_bound_ms(nq: int, n: int, d: int, dtype) -> tuple:
    """(ms, 'bytes'|'operations'): each input read once, each output
    written once, over the HBM rate; 2*Q*N*d operations over the peak for
    the corpus type."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n * d * item + 2 * n * 4 + nq * d * 4
              + nq * BUCKETS * (4 + 4))
    return _bound({"bytes": nbytes, "ops": 2.0 * nq * n * d}, dtype)


def _bound(work: dict, dtype) -> tuple:
    """(ms, 'bytes'|'operations'): the larger of the bytes over the HBM
    rate and the operations over the peak for the data type."""
    t_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = work["ops"] / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 1


def phase_kernel(scan) -> dict:
    """Kernel vs plain at full size; returns the figures for the JSON."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    corpus32 = torch.randn((SCAN_N, SCAN_D), generator=gen, device=dev)
    sq = {}
    corpora = {torch.float32: corpus32,
               torch.bfloat16: corpus32.to(torch.bfloat16)}
    for dt, c in corpora.items():
        sq[dt] = c.float().pow(2).sum(dim=1)
    valid = torch.rand(SCAN_N, generator=gen, device=dev) >= 0.01
    neg_mask = torch.zeros(SCAN_N, device=dev).masked_fill_(~valid,
                                                            scan.NEG_INF)
    queries = torch.randn((max(SCAN_QS), SCAN_D), generator=gen, device=dev)
    rows = []
    max_err = 0.0
    for dt, corpus in corpora.items():
        cases = [(nq, SCAN_N) for nq in SCAN_QS] + [(64, SCAN_N - 123)]
        for nq, n in cases:
            q = queries[:nq]
            x, s, m, v = corpus[:n], sq[dt][:n], neg_mask[:n], valid[:n]
            name = f"{str(dt).split('.')[-1]} Q={nq} N={n} d={SCAN_D}"
            max_err = max(max_err, _hold(scan, name, q, x, s, m, v))
            if n != SCAN_N:
                continue
            reps = 20 if nq <= 64 else 5
            ms = cuda_ms(lambda: scan.scan_candidates(q, x, s, m, BUCKETS),
                         reps)
            plain_ms = cuda_ms(
                lambda: scan.scan_candidates_plain(q, x, s, m, BUCKETS), 3, 1)
            lib_ms = cuda_ms(lambda: _library_topk(q, x, s, 10), 3, 1)
            bound, by = scan_bound_ms(nq, n, SCAN_D, dt)
            row = {"dtype": str(dt).split(".")[-1], "Q": nq, "N": n,
                   "d": SCAN_D, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bound, "bound_by": by}
            rows.append(row)
            log("kernel timing " + json.dumps(row))
    del corpora, corpus32
    torch.cuda.empty_cache()

    # widths and alignments off the kernel's vector loads: d % 16 != 0
    # leaves a partial last depth slice; d % 4 (f32) or d % 8 (bf16) != 0,
    # or a corpus pointer off 16 bytes, takes the scalar loads
    for d, dt, offset in RAGGED_WIDTHS:
        flat = torch.randn(RAGGED_N * d + offset, generator=gen,
                           device=dev).to(dt)
        x = flat[offset:].view(RAGGED_N, d)
        s = x.float().pow(2).sum(dim=1)
        v, m = valid[:RAGGED_N], neg_mask[:RAGGED_N]
        q = torch.randn((RAGGED_Q, d), generator=gen, device=dev)
        name = (f"{str(dt).split('.')[-1]} Q={RAGGED_Q} N={RAGGED_N} d={d} "
                f"pointer mod 16 = {x.data_ptr() % 16}")
        max_err = max(max_err, _hold(scan, name, q, x, s, m, v))

    main = next(r for r in rows if r["dtype"] == "float32" and r["Q"] == 256)
    return {"rows": rows, "main": main, "max_abs_err": max_err}


def _hold(scan, name, q, x, s, m, v) -> float:
    """Holds the kernel against the plain version on one input; raises on
    disagreement, returns the largest candidate score difference."""
    val_k, idx_k = scan.scan_candidates(q, x, s, m, BUCKETS)
    val_p, idx_p = scan.scan_candidates_plain(q, x, s, m, BUCKETS)
    torch.cuda.synchronize()
    agree = (idx_k == idx_p).float().mean().item()
    err = (val_k - val_p).abs()
    tol = SCORE_ATOL + SCORE_RTOL * val_p.abs()
    worst = (err / tol).max().item()
    d_k, _ = scan.scan_l2sq_topk(q, x, s, v, 10)
    d_p, _ = _plain_topk(scan, q, x, s, v, 10)
    top_rel = ((d_k - d_p).abs() / d_p.abs()).max().item()
    log(f"kernel check {name}: slots agree {agree:.6f}, "
        f"max |score diff| {err.max().item():.3e} "
        f"({worst:.3f} of tol), top-10 max rel diff {top_rel:.3e}")
    if agree < SLOT_AGREE_MIN:
        raise AssertionError(f"{name}: only {agree:.6f} of slots agree")
    if worst > 1.0:
        raise AssertionError(f"{name}: candidate scores disagree beyond "
                             f"rtol {SCORE_RTOL} + atol {SCORE_ATOL}")
    if top_rel > TOPK_RTOL:
        raise AssertionError(f"{name}: top-10 distances disagree beyond "
                             f"rtol {TOPK_RTOL}")
    return err.max().item()


def _plain_topk(scan, q, x, s, valid, k):
    """scan_l2sq_topk's epilogue over the plain candidates."""
    neg_mask = torch.zeros(valid.shape, device=valid.device).masked_fill_(
        ~valid, scan.NEG_INF)
    val, idx = scan.scan_candidates_plain(q, x, s, neg_mask, BUCKETS)
    neg, pos = torch.topk(val, k, dim=1)
    rows = torch.gather(idx, 1, pos)
    q_sq = (q.float() ** 2).sum(dim=1, keepdim=True)
    return q_sq - neg, rows


def _library_topk(q, x, s, k):
    """One PyTorch call computing the exact top-k of the same scores."""
    return torch.topk(2.0 * (q.to(x.dtype) @ x.T).float() - s, k, dim=1)


# --------------------------------------------------------------- phase 2


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def phase_engine(tt, scan) -> dict:
    from tpuvdb_torch.core.types import SearchRequest, VectorData
    from tpuvdb_torch.kernels.distance import l2sq_topk
    from tpuvdb_torch.utils.tracing import StageTimer

    rng = np.random.default_rng(0)
    cfg = tt.DBConfig(vector_dim=512)
    assert cfg.search_mode == "approx" and cfg.storage_dtype == "float32"
    eng = tt.VectorDBEngine(cfg)
    data = _unit_rows(rng, ENGINE_ROWS, cfg.vector_dim)
    keys = [f"doc{i}" for i in range(ENGINE_ROWS)]
    queries = _unit_rows(rng, max(ENGINE_BATCHES), cfg.vector_dim)

    t0 = time.perf_counter()
    res = eng.put_rows(keys, data)
    assert res.success, res.message
    eng.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    idx = eng._index
    log(f"engine ingest: {ENGINE_ROWS} rows in {ingest_s:.3f} s "
        f"(device corpus {tuple(idx.vectors.shape)} {idx.vectors.dtype})")

    out = {"ingest_s": ingest_s, "rows": ENGINE_ROWS,
           "device_rows": idx.layout.total_rows}
    for b in ENGINE_BATCHES:
        q = queries[:b]
        eng.search_batch(q, 10)  # warm
        eng.timers = StageTimer()
        times = []
        for _ in range(SEARCH_REPS):
            t = time.perf_counter()
            eng.search_batch(q, 10)
            times.append(time.perf_counter() - t)
        p50, p90 = (float(np.percentile(times, p)) * 1e3 for p in (50, 90))
        qps = b * len(times) / sum(times)
        stages = {name: st["p50_ms"]
                  for name, st in eng.timers.snapshot().items()}
        out[f"b{b}"] = {"p50_ms": p50, "p90_ms": p90, "n": len(times),
                        "qps": qps, "stage_p50_ms": stages}
        log(f"engine search b{b} k=10: p50 {p50:.3f} ms, p90 {p90:.3f} ms "
            f"(n={len(times)}), {qps:.1f} QPS over the window, "
            f"stage p50s {stages}")
    out["b256_device"] = _device_share(eng, queries)

    # recall@10 against an exact scan of the same device corpus
    d_a, k_a = eng.search_batch(queries, 10)
    q_t = torch.from_numpy(queries).cuda()
    _, rows = l2sq_topk(q_t, idx.vectors, idx.sqnorms, idx.valid, 10,
                        mode="exact")
    rows = rows.cpu().numpy()
    hit = 0
    for i in range(len(queries)):
        truth = {eng.docstore.key_at(*idx.layout.shard_slot_of(int(r)))
                 for r in rows[i] if r >= 0}
        hit += len(truth & set(k_a[i]))
    recall = hit / (10 * len(queries))
    out["recall_at_10"] = recall
    log(f"engine recall@10 (approx vs exact, {len(queries)} queries): "
        f"{recall:.4f}")
    if recall < RECALL_MIN:
        raise AssertionError(f"recall@10 {recall} < {RECALL_MIN}")

    # through the request API
    r = eng.search(SearchRequest(query_vector=queries[0].tolist(), top_k=10))
    assert r.success and len(r.search_result.hits()) == 10, r.message
    assert r.search_result.hits()[0].key == k_a[0][0]

    # writes are visible before and after flush()
    probe = _unit_rows(rng, 1, cfg.vector_dim)
    eng.put(VectorData(key="doc5", vector=probe[0].tolist()))
    victim = k_a[1][0]
    assert eng.delete(victim).success
    for when in ("before flush", "after flush"):
        _, kp = eng.search_batch(probe, 10)
        assert kp[0][0] == "doc5", (when, kp[0][:3])
        _, kv = eng.search_batch(queries[1:2], 10)
        assert victim not in kv[0], (when, victim)
        got = eng.get("doc5")
        assert np.allclose(got.vector_data.vector, probe[0]), when
        assert not eng.get(victim).success, when
        eng.flush()
    assert eng.count() == ENGINE_ROWS - 1
    log("engine overwrite/delete/get visible before and after flush: ok")
    eng.close()
    return out


def _device_share(eng, queries) -> dict:
    """Device busy time over wall time for b256 searches, from a
    torch.profiler trace (kernel self times summed); "not measured" if the
    profiler sees no device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    reps = 10
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            eng.search_batch(queries, 10)
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            by_name[ev.key] = us / 1e3 / reps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    res = {"wall_ms_per_search": wall_ms / reps}
    if busy <= 0:
        res["device_busy"] = "not measured"
    else:
        res.update(device_busy_ms_per_search=busy,
                   device_idle_share=1.0 - busy * reps / wall_ms,
                   top_device_ms=dict(top))
    log(f"engine b256 under torch.profiler: {json.dumps(res)}")
    return res


# --------------------------------------------------------------- phase 3


def phase_durability(tt) -> None:
    rng = np.random.default_rng(7)
    cfg = tt.DBConfig(vector_dim=512, checkpoint_every_puts=10 ** 9)
    data = _unit_rows(rng, DURABLE_ROWS + 1000, cfg.vector_dim)
    queries = _unit_rows(rng, 32, cfg.vector_dim)
    keys = [f"d{i}" for i in range(len(data))]
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    try:
        eng = tt.VectorDBEngine(cfg, data_dir=work)
        assert eng.put_rows(keys[:DURABLE_ROWS], data[:DURABLE_ROWS]).success
        assert eng.save_checkpoint() is not None
        assert eng.put_rows(keys[DURABLE_ROWS:], data[DURABLE_ROWS:]).success
        for i in range(0, 500, 5):
            assert eng.delete(keys[i]).success
        want = eng.search_batch(queries, 10)
        n = eng.count()
        eng.wal.close()  # crash: no checkpoint of the tail
        for how in ("WAL tail replay", "close() checkpoint"):
            eng = tt.VectorDBEngine(cfg, data_dir=work)
            got = eng.search_batch(queries, 10)
            assert eng.count() == n, (how, eng.count(), n)
            assert got[1] == want[1], how
            assert np.array_equal(got[0], want[0]), how
            log(f"durability after {how}: {n} docs, identical results")
            eng.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------- phase 4


def clustered_corpus(n: int, dim: int, seed: int = 0, n_clusters: int = 1024,
                     spread: float = 0.4):
    """(corpus (n, dim) f32, queries (1024, dim) f32): a seeded copy of
    tpuvdb/bench/datasets.py synthetic_corpus(clustered=True)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3
    assign = rng.integers(0, n_clusters, n)
    corpus = centers[assign] + spread * rng.standard_normal(
        (n, dim)).astype(np.float32)
    qi = rng.choice(n, 1024, replace=n < 1024)
    queries = corpus[qi] + 0.05 * rng.standard_normal(
        (1024, dim)).astype(np.float32)
    return corpus, queries


def _plan_work(ivf_probe, plan, n_chunks: int, d: int, item: int) -> dict:
    """Rows and bytes this plan's probe needs: per tile its distinct
    chunks (the operations), over all tiles their union (each chunk read
    once); outputs written once."""
    if plan.compact:
        lists = ivf_probe.packed_chunks(plan.cells, plan.off128, plan.w128,
                                        n_chunks)
    else:
        lists = plan.cells.long()
    lists = torch.sort(lists, dim=1).values
    per_tile = ((lists[:, 1:] != lists[:, :-1]).sum(dim=1) + 1)
    tile_rows = int(per_tile.sum()) * 128
    union_rows = int(torch.unique(lists).numel()) * 128
    qp = plan.queries.shape[0]
    nbytes = (union_rows * (d * item + 8) + qp * d * 4
              + qp * 128 * plan.n_segments * 8 + plan.cells.numel() * 4)
    ops = 2.0 * plan.query_tile * tile_rows * d
    return {"tile_rows": tile_rows, "union_rows": union_rows,
            "bytes": nbytes, "ops": ops}


def _hold_probe(ivf_probe, name, plan, g, sq, mask) -> float:
    """Holds one form's kernel against its plain twin on one plan; raises
    on disagreement, returns the largest candidate score difference."""
    val_k, idx_k = ivf_probe.plan_candidates(plan, g, sq, mask)
    val_p, idx_p = ivf_probe.plan_candidates(plan, g, sq, mask, plain=True)
    torch.cuda.synchronize()
    agree = (idx_k == idx_p).float().mean().item()
    x_max = sq.max().sqrt()
    q_norm = plan.queries.norm(dim=1, keepdim=True)
    tol = IVF_SCORE_TOL * (2.0 * q_norm * x_max + x_max * x_max)
    live = val_p > ivf_probe.NEG_INF
    err = torch.where(live, (val_k - val_p).abs(), torch.zeros_like(val_p))
    worst = (err / tol).max().item()
    q_sq = (plan.queries ** 2).sum(dim=1, keepdim=True)
    top_k = q_sq - torch.topk(val_k, 10, dim=1).values
    top_p = q_sq - torch.topk(val_p, 10, dim=1).values
    top_worst = ((top_k - top_p).abs() / tol).max().item()
    log(f"ivf kernel check {name}: slots agree {agree:.6f}, "
        f"max |score diff| {err.max().item():.3e} ({worst:.3f} of tol), "
        f"top-10 distances {top_worst:.3f} of tol")
    if agree < SLOT_AGREE_MIN:
        raise AssertionError(f"{name}: only {agree:.6f} of slots agree")
    if worst > 1.0 or top_worst > 1.0:
        raise AssertionError(f"{name}: scores disagree beyond tolerance")
    return err.max().item()


def phase_ivf_kernel(ivf_probe) -> dict:
    """Both IVF probe kernels vs their plain twins at full size."""
    from tpuvdb_torch.index.ivf import IVFIndex

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    centers = torch.randn((IVF_NLIST, IVF_D), generator=gen, device=dev) * 3
    assign = torch.randint(0, IVF_NLIST, (IVF_N,), generator=gen, device=dev)
    corpus = centers[assign] + 0.4 * torch.randn((IVF_N, IVF_D),
                                                 generator=gen, device=dev)
    qi = torch.randint(0, IVF_N, (IVF_COMPACT_Q,), generator=gen, device=dev)
    queries = corpus[qi] + 0.05 * torch.randn(
        (IVF_COMPACT_Q, IVF_D), generator=gen, device=dev)
    t0 = time.perf_counter()
    idx = IVFIndex.build(corpus.cpu().numpy(), np.ones(IVF_N, bool),
                         nlist=IVF_NLIST, nprobe=IVF_NPROBE, kmeans_iters=6,
                         train_sample=131072)
    del corpus
    dead = np.random.default_rng(3).choice(IVF_N, IVF_N // 100,
                                           replace=False)
    idx.invalidate_rows(dead)
    torch.cuda.synchronize()
    log(f"ivf kernel index: {IVF_N} x {IVF_D} in {time.perf_counter() - t0:.1f}"
        f" s, nlist {idx.nlist}, cell_pad {idx.cell_pad}, grouped "
        f"{tuple(idx.grouped.shape)}, spill rows {idx.stats().spill_rows}, "
        f"{len(dead)} dead rows")
    mask = torch.zeros(idx.grouped_valid.shape, device=dev).masked_fill_(
        ~idx.grouped_valid, ivf_probe.NEG_INF)
    n_chunks = idx.grouped.shape[0] // 128
    cells = {torch.float32: idx.grouped,
             torch.bfloat16: idx.grouped.to(torch.bfloat16)}
    w128 = idx.cell_pad // 128
    nprobe_big = ivf_probe.EXPANDED_MAX // (IVF_COMPACT_Q * w128) + 1
    cases = [(q, IVF_NPROBE, fc) for q in IVF_QS for fc in (False, True)]
    cases.append((IVF_COMPACT_Q, nprobe_big, False))
    rows, err = [], {False: 0.0, True: 0.0}
    for dt, g in cells.items():
        for nq, nprobe, force in cases:
            if nq == IVF_COMPACT_Q and dt != torch.float32:
                continue
            plan = ivf_probe.probe_plan(queries[:nq], idx.centroids,
                                        idx.cell_offsets, idx.cell_pad, 10,
                                        nprobe, force_compact=force)
            form = "compact" if plan.compact else "expanded"
            name = (f"{form} {str(dt).split('.')[-1]} Q={nq} "
                    f"nprobe={nprobe}")
            e = _hold_probe(ivf_probe, name, plan, g, idx.grouped_sq, mask)
            err[plan.compact] = max(err[plan.compact], e)
            reps = 20 if nq <= 8 else 5
            ms = cuda_ms(lambda: ivf_probe.plan_candidates(
                plan, g, idx.grouped_sq, mask), reps)
            plain_ms = cuda_ms(lambda: ivf_probe.plan_candidates(
                plan, g, idx.grouped_sq, mask, plain=True), 2, 1)
            work = _plan_work(ivf_probe, plan, n_chunks, IVF_D,
                              g.element_size())
            bound, by = _bound(work, dt)
            row = {"form": form, "dtype": str(dt).split(".")[-1], "Q": nq,
                   "nprobe": nprobe, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by, **work}
            rows.append(row)
            log("ivf kernel timing " + json.dumps(row))
    del cells
    torch.cuda.empty_cache()

    def pick(form, nq):
        return next(r for r in rows if r["form"] == form
                    and r["dtype"] == "float32" and r["Q"] == nq)

    return {"rows": rows, "expanded": pick("expanded", 256),
            "compact": pick("compact", IVF_COMPACT_Q),
            "err_expanded": err[False], "err_compact": err[True],
            "nprobe_big": nprobe_big}


# --------------------------------------------------------------- phase 5


def _ivf_config(tt, **kw):
    return tt.DBConfig(vector_dim=IVF_D, index_type="ivf",
                       ivf_nlist=IVF_NLIST, ivf_nprobe=IVF_NPROBE,
                       ivf_kmeans_iters=6, ivf_train_sample=131072,
                       wal_enabled=False, **kw)


def _recall(got_keys, truth_rows, keys) -> float:
    hit = sum(len({keys[r] for r in t} & set(g))
              for g, t in zip(got_keys, truth_rows))
    return hit / (10 * len(truth_rows))


def phase_ivf_engine(tt):
    from tpuvdb_torch.kernels.distance import l2sq_topk
    from tpuvdb_torch.utils.tracing import StageTimer

    cfg = _ivf_config(tt)
    assert cfg.shard_count == 4 and cfg.storage_dtype == "float32"
    data, queries = clustered_corpus(IVF_ENGINE_ROWS, IVF_D, seed=0)
    keys = [f"r{i}" for i in range(IVF_ENGINE_ROWS)]
    eng = tt.VectorDBEngine(cfg)
    t0 = time.perf_counter()
    assert eng.put_rows(keys, data).success
    eng.flush()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ivf = eng._ivf
    st = ivf.stats()
    log(f"ivf engine build: {IVF_ENGINE_ROWS} rows in {build_s:.3f} s "
        f"(put_rows + flush: k-means, assignment, bisection, packing, "
        f"upload); nlist {st.nlist}, cell_pad {st.cell_pad}, grouped rows "
        f"{st.grouped_rows}, spill rows {st.spill_rows}, fill {st.fill:.4f}")
    out = {"build_s": build_s, "rows": IVF_ENGINE_ROWS,
           "stats": dataclasses.asdict(st)}

    for b in IVF_BATCHES:
        q = queries[:b]
        eng.search_batch(q, 10)  # warm
        eng.timers = StageTimer()
        times = []
        for _ in range(SEARCH_REPS):
            t = time.perf_counter()
            eng.search_batch(q, 10)
            times.append(time.perf_counter() - t)
        p50, p90 = (float(np.percentile(times, p)) * 1e3 for p in (50, 90))
        qps = b * len(times) / sum(times)
        stages = {name: v["p50_ms"]
                  for name, v in eng.timers.snapshot().items()}
        out[f"b{b}"] = {"p50_ms": p50, "p90_ms": p90, "n": len(times),
                        "qps": qps, "stage_p50_ms": stages}
        log(f"ivf engine search b{b} k=10: p50 {p50:.3f} ms, p90 "
            f"{p90:.3f} ms (n={len(times)}), {qps:.1f} QPS over the window, "
            f"stage p50s {stages}")
    out["b256_device"] = _device_share(eng, queries[:256])

    # recall@10 against an exact scan of the same rows
    x = torch.from_numpy(data).cuda()
    ones = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    _, truth = l2sq_topk(torch.from_numpy(queries).cuda(), x,
                         (x * x).sum(dim=1), ones, 10, mode="exact")
    truth = truth.cpu().numpy()
    del x
    torch.cuda.empty_cache()
    _, got = eng.search_batch(queries[:256], 10)
    out["recall_at_10"] = _recall(got, truth[:256], keys)
    log(f"ivf engine recall@10 (b256 vs exact): {out['recall_at_10']:.4f}")
    if out["recall_at_10"] < RECALL_MIN:
        raise AssertionError(f"ivf recall@10 {out['recall_at_10']} < "
                             f"{RECALL_MIN}")
    return eng, data, queries, truth, keys, out


def phase_ivf_index_compact(eng, queries, truth, keys, ivf_probe) -> dict:
    """One IVFIndex.search at b1,024 whose probe set passes 2**20 entries:
    the compact form, on the engine's own index."""
    ivf = eng._ivf
    w128 = ivf.cell_pad // 128
    nprobe = ivf_probe.EXPANDED_MAX // (len(queries) * w128) + 1
    if nprobe > ivf.nlist:
        raise AssertionError(f"nprobe {nprobe} > nlist {ivf.nlist}: no "
                             "probe set of this batch passes 2**20")
    layout = eng._ivf_layout
    _, rows = ivf.search(queries, 10, nprobe=nprobe)
    got = [[eng.docstore.key_at(*layout.shard_slot_of(int(r)))
            for r in row if r >= 0] for row in rows]
    recall = _recall(got, truth, keys)
    log(f"ivf index search b{len(queries)} nprobe {nprobe} "
        f"({len(queries) * nprobe * w128} probe entries > 2**20: compact "
        f"form): recall@10 {recall:.4f}")
    return {"nprobe": nprobe, "recall_at_10": recall}


def phase_ivf_writes(eng, data, queries) -> None:
    """Overwrite, delete and get, before and after flush, then a delta
    overflow that drains into the index by append."""
    from tpuvdb_torch.core.types import VectorData

    rng = np.random.default_rng(5)
    probe = data[7] + 0.3 * rng.standard_normal(IVF_D).astype(np.float32)
    assert eng.put(VectorData(key="r5", vector=probe.tolist())).success
    _, k1 = eng.search_batch(queries[1:2], 10)
    victim = k1[0][0]
    assert eng.delete(victim).success
    for when in ("before flush", "after flush"):
        _, kp = eng.search_batch(probe[None], 10)
        assert kp[0][0] == "r5", (when, kp[0][:3])
        _, kv = eng.search_batch(queries[1:2], 10)
        assert victim not in kv[0], (when, victim)
        assert np.allclose(eng.get("r5").vector_data.vector, probe), when
        assert not eng.get(victim).success, when
        eng.flush()
    ivf = eng._ivf
    n_new = eng.config.ivf_delta_max + 16
    fresh = data[:n_new] + 0.2 * rng.standard_normal(
        (n_new, IVF_D)).astype(np.float32)
    appends0 = eng.stats.get("ivf_appends", 0)
    assert eng.put_rows([f"n{i}" for i in range(n_new)], fresh).success
    eng.flush()                       # > ivf_delta_max: drains by append
    _, kn = eng.search_batch(fresh[123:124], 10)
    assert eng._ivf is ivf, "the overflow rebuilt instead of appending"
    appended = eng.stats.get("ivf_appends", 0) - appends0
    assert appended >= n_new and eng.info()["ivf_delta"] == 0, appended
    assert kn[0][0] == "n123", kn[0][:3]
    assert eng.count() == IVF_ENGINE_ROWS - 1 + n_new
    log(f"ivf engine overwrite/delete/get visible before and after flush; "
        f"delta overflow appended {appended} rows in place: ok")


def phase_ivf_restart(tt) -> dict:
    """A 50,000-row data_dir restart: the warm centroids are reused (no
    k-means) and the keys come back identical."""
    import tpuvdb_torch.index.ivf as ivf_mod

    cfg = _ivf_config(tt, checkpoint_every_puts=10 ** 9)
    data, queries = clustered_corpus(IVF_RESTART_ROWS, IVF_D, seed=9)
    keys = [f"w{i}" for i in range(IVF_RESTART_ROWS)]
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    real = ivf_mod.kmeans
    try:
        eng = tt.VectorDBEngine(cfg, data_dir=work)
        assert eng.put_rows(keys, data).success
        eng.flush()
        cents = eng._ivf.centroids_np().copy()
        want = eng.search_batch(queries[:32], 10)
        eng.close()

        def no_training(*a, **k):
            raise AssertionError("k-means ran on a warm restart")

        ivf_mod.kmeans = no_training
        t0 = time.perf_counter()
        eng = tt.VectorDBEngine(cfg, data_dir=work)
        got = eng.search_batch(queries[:32], 10)
        restart_s = time.perf_counter() - t0
        assert np.array_equal(eng._ivf.centroids_np(), cents)
        assert got[1] == want[1], "keys differ after the warm restart"
        assert np.array_equal(got[0], want[0])
        log(f"ivf restart: {IVF_RESTART_ROWS} rows, warm centroids reused "
            f"(no k-means), reopen + first search {restart_s:.3f} s, "
            f"identical results")
        eng.close()
        return {"rows": IVF_RESTART_ROWS, "restart_s": restart_s}
    finally:
        ivf_mod.kmeans = real
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tpuvdb_torch as tt
    from tpuvdb_torch.kernels import ivf_probe, scan

    wall0 = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    libs = (scan.LIBRARY, ivf_probe.LIBRARY)
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))
    log(f"kernels built in {time.perf_counter() - wall0:.1f} s")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"nvcc {os.path.basename(lib.source)}: {line.strip()}")

    kern = phase_kernel(scan)
    scan.LAUNCHES = 0
    eng = phase_engine(tt, scan)
    launches = scan.LAUNCHES
    log("engine " + json.dumps(eng))
    if launches <= 0:
        raise AssertionError("the engine's search never launched the "
                             "scan kernel")
    phase_durability(tt)

    ivf_kern = phase_ivf_kernel(ivf_probe)
    ivf_probe.LAUNCHES_EXPANDED = ivf_probe.LAUNCHES_COMPACT = 0
    ivf_eng, data, queries, truth, keys, ivf_out = phase_ivf_engine(tt)
    launches_expanded = ivf_probe.LAUNCHES_EXPANDED
    if launches_expanded <= 0:
        raise AssertionError("the IVF engine's search never launched the "
                             "expanded probe kernel")
    ivf_probe.LAUNCHES_COMPACT = 0
    ivf_out["index_compact"] = phase_ivf_index_compact(
        ivf_eng, queries, truth, keys, ivf_probe)
    launches_compact = ivf_probe.LAUNCHES_COMPACT
    if launches_compact <= 0:
        raise AssertionError("the b1,024 index search never launched the "
                             "compact probe kernel")
    phase_ivf_writes(ivf_eng, data, queries)
    ivf_eng.close()
    del ivf_eng, data
    torch.cuda.empty_cache()
    ivf_out["restart"] = phase_ivf_restart(tt)
    log("ivf engine " + json.dumps(ivf_out))
    log(f"launches: scan {launches} (flat engine phase), ivf expanded "
        f"{launches_expanded} (ivf engine phase), ivf compact "
        f"{launches_compact} (b1,024 index search)")
    log(f"total wall {time.perf_counter() - wall0:.1f} s")

    m = kern["main"]
    no_library = None  # no single PyTorch call computes the IVF probe
    e, c = ivf_kern["expanded"], ivf_kern["compact"]
    log(json.dumps({"kernels": [{
        "name": "scan_candidates",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/scan.cu",
        "replaces": "tpuvdb/kernels/pallas_scan.py:41",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": m["ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
    }, {
        "name": "ivf_candidates",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/ivf_probe.cu",
        "replaces": "tpuvdb/kernels/pallas_ivf.py:172",
        "launches": launches_expanded,
        "max_abs_err": ivf_kern["err_expanded"],
        "ms": e["ms"], "plain_ms": e["plain_ms"],
        "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
        "library_ms": no_library,
    }, {
        "name": "ivf_candidates_packed",
        "route": "cuda",
        "source": "tpuvdb_torch/csrc/ivf_probe.cu",
        "replaces": "tpuvdb/kernels/pallas_ivf.py:79",
        "launches": launches_compact,
        "max_abs_err": ivf_kern["err_compact"],
        "ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": no_library,
    }]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
