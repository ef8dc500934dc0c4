"""Smoke run of the PyTorch/CUDA port (tpuvdb_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It runs every phase, in this order; any failure exits non-zero, and nothing
is caught and carried on:

  kernel      Builds csrc/scan.cu with nvcc (sm_90a) and holds the scan
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

The last two lines of standard output are the card's name and power limit
(as nvidia-smi reports them) and the JSON result line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

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
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * nq * n * d / PEAK_FLOPS[dtype] * 1e3
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


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tpuvdb_torch as tt
    from tpuvdb_torch.kernels import scan

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    scan.build()
    log(f"scan kernel built in {time.perf_counter() - t0:.1f} s")
    for line in scan.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("nvcc: " + line.strip())

    kern = phase_kernel(scan)
    scan.LAUNCHES = 0
    eng = phase_engine(tt, scan)
    launches = scan.LAUNCHES
    log("engine " + json.dumps(eng))
    if launches <= 0:
        raise AssertionError("the engine's search never launched the "
                             "scan kernel")
    phase_durability(tt)

    m = kern["main"]
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
