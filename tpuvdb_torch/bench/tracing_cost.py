"""What the engine's spans and stages (utils/tracing.py) cost.

  python -m tpuvdb_torch.bench.tracing_cost [--device cuda] [--iters N]

Times, net of an empty loop's iteration: a gated span with no profiler
running (the timer's and the module's), a stage, and each of them while
torch.profiler records (CPU activity, and CUDA activity where a card is
present, as the benchmark's traced runs record), beside the two profiler
ranges a block can open. Then one profiled window of searches on a small flat and a
small IVF engine on `--device` counts the spans and stages a call opens,
and prices them at the unprofiled costs: what every call pays with tracing
off. With `--window-seconds S`, closed-loop b`--batch` calls on one
`--index` engine of `--rows` x 512 rows (IVF as the benchmark's: 1,024
cells, 64 probed), each wrapped in a `record_function` as the
benchmark's traced window wraps them, take turns for S seconds a turn
under six settings: no profiler; CPU + CUDA profiling with the spans
forced to the no-op; with the spans; with their ranges but no keeping of
totals; with the keeping but no ranges; and no profiler with the spans
kept but no ranges, which reads the spans of an unprofiled call at the
keeping's cost (`window_costs`). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch

from tpuvdb_torch.utils import tracing
from tpuvdb_torch.utils.tracing import StageTimer

ROWS, DIM, CALLS = 16_384, 64, 200


def _profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _per_op_us(body, iters: int) -> float:
    """Microseconds an iteration of `body(iters)` takes beyond an empty
    loop's: the best of three runs of each, so a run the host interrupts
    counts for neither."""
    def empty(n):
        for _ in range(n):
            pass

    def best(fn):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(iters)
            runs.append(time.perf_counter() - t0)
        return min(runs)

    return (best(body) - best(empty)) / iters * 1e6


def block_costs(iters: int) -> dict:
    timer = StageTimer()

    def timer_span(n):
        for _ in range(n):
            with timer.span("x"):
                pass

    def module_span(n):
        for _ in range(n):
            with tracing.span("x"):
                pass

    def stage(n):
        for _ in range(n):
            with timer.stage("x"):
                pass

    def rf_fast(n):
        for _ in range(n):
            with tracing._range("x"):
                pass

    def rf(n):
        for _ in range(n):
            with torch.profiler.record_function("x"):
                pass

    out = {}
    with timer.stage("outer"):  # the module's span joins this timer
        out["span_off_us"] = _per_op_us(timer_span, iters)
        out["module_span_off_us"] = _per_op_us(module_span, iters)
        out["stage_off_us"] = _per_op_us(stage, iters)
        on = max(1, iters // 10)
        with _profile():
            out["span_on_us"] = _per_op_us(timer_span, on)
            out["module_span_on_us"] = _per_op_us(module_span, on)
            out["stage_on_us"] = _per_op_us(stage, on)
            out["range_fast_us"] = _per_op_us(rf_fast, on)
            out["record_function_us"] = _per_op_us(rf, on)
    out["range"] = getattr(tracing._range, "__name__", str(tracing._range))
    return out


def blocks_per_call(index_type: str, device: str, batch: int,
                    rows: int = ROWS, calls: int = CALLS) -> dict:
    """Spans and stages one search call opens, from a profiled window."""
    from tpuvdb_torch import DBConfig, VectorDBEngine

    eng = VectorDBEngine(DBConfig(
        vector_dim=DIM, shard_count=4, index_type=index_type,
        ivf_nlist=64, ivf_nprobe=8, wal_enabled=False,
        checkpoint_every_puts=10 ** 12, compact_every_puts=10 ** 12,
        search_coalesce=True), device=device)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((rows, DIM)).astype(np.float32)
    if not eng.put_rows([f"r{i}" for i in range(rows)], data).success:
        raise RuntimeError("bulk load failed")
    eng.flush()
    q = rng.standard_normal((batch, DIM)).astype(np.float32)
    for _ in range(5):
        eng.search_batch(q, 10)
    with _profile():
        for _ in range(calls):
            eng.search_batch(q, 10)
    spans = eng.info()["spans"]
    stages = set(eng.info()["latency"])
    eng.close()
    per = {n: v["count"] / spans["calls"] for n, v in spans["names"].items()}
    return {"spans": sum(c for n, c in per.items() if n not in stages),
            "stages": sum(c for n, c in per.items() if n in stages),
            "by_name": per}


class _NoRange:
    """A range that records nothing."""

    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _no_keeping(self, b, dt):
    pass


# setting: (profiled, the patches of utils/tracing it runs under)
SETTINGS = {
    "untraced": (False, []),
    "profiled, spans off": (True, [(tracing, "_profiling", lambda: False)]),
    "profiled, spans on": (True, []),
    "profiled, ranges alone": (True, [(StageTimer, "_add_traced",
                                       _no_keeping)]),
    "profiled, keeping alone": (True, [(tracing, "_range", _NoRange)]),
    "unprofiled, spans kept": (False, [(tracing, "_profiling", lambda: True),
                                       (tracing, "_range", _NoRange)]),
}


def _turn(eng, queries, seconds: float, profiled: bool, patches) -> dict:
    """Closed-loop calls for `seconds`: their host-clock times and the
    always-on stages' totals over them."""
    ctx = contextlib.ExitStack()
    for target, attr, value in patches:
        ctx.enter_context(mock.patch.object(target, attr, value))
    if profiled:
        ctx.enter_context(_profile())
    before = eng.timers.snapshot()
    session = eng.timers._traced  # a session begun in the turn replaces it
    lat = []
    with ctx:
        i, n = 0, len(queries)
        end = time.perf_counter() + seconds
        while True:
            t0 = time.perf_counter()
            if t0 >= end:
                break
            if profiled:
                with torch.profiler.record_function("perfbench.call"):
                    eng.search_batch(queries[i % n], 10)
            else:
                eng.search_batch(queries[i % n], 10)
            lat.append(time.perf_counter() - t0)
            i += 1
        after = eng.timers.snapshot()
    stages = {name: (after[name]["total_ms"]
                     - before.get(name, {}).get("total_ms", 0.0),
                     after[name]["count"]
                     - before.get(name, {}).get("count", 0))
              for name in ("search.device", "search.assemble")}
    # read with the patches undone: the read ends the session
    spans = eng.info()["spans"]
    return {"lat": lat, "stages": stages,
            "spans": None if eng.timers._traced is session else spans}


def window_costs(device: str, rows: int, batch: int, seconds: float,
                 rounds: int = 2, index_type: str = "flat") -> dict:
    """Each setting of SETTINGS in turn, `rounds` times forth and back on
    one engine: ms a call (mean, p50, p95) and the always-on stages' mean
    ms a call, pooled over a setting's turns; with spans on, the spans'
    ms a call and the tail's of the last turn where spans were kept."""
    from tpuvdb_torch import DBConfig, VectorDBEngine

    dim = 512
    eng = VectorDBEngine(DBConfig(
        vector_dim=dim, shard_count=4, index_type=index_type,
        search_mode="approx", recall_target=0.95, ivf_nlist=1024,
        ivf_nprobe=64, ivf_kmeans_iters=6, ivf_train_sample=131072,
        wal_enabled=False,
        checkpoint_every_puts=10 ** 12, compact_every_puts=10 ** 12,
        search_coalesce=True), device=device)
    g = torch.Generator(device=device).manual_seed(0)
    data = torch.randn(rows, dim, generator=g, device=device)
    data /= data.norm(dim=1, keepdim=True)
    if not eng.put_rows([f"r{i}" for i in range(rows)],
                        data.cpu().numpy()).success:
        raise RuntimeError("bulk load failed")
    del data
    eng.flush()
    rng = np.random.default_rng(1)
    queries = rng.standard_normal((256, batch, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=2, keepdims=True)
    eng.warm_search(10, batch, max_stack=batch)
    for q in queries[:32]:
        eng.search_batch(q, 10)
    gc.collect()
    gc.freeze()
    names = list(SETTINGS)
    order = (names + names[::-1]) * rounds
    pooled = {n: {"lat": [], "turns": [], "stages": {}, "spans": None}
              for n in names}
    for name in order:
        got = _turn(eng, queries, seconds, *SETTINGS[name])
        p = pooled[name]
        p["lat"] += got["lat"]
        p["turns"].append(statistics.fmean(got["lat"]) * 1e3)
        for st, (tot, cnt) in got["stages"].items():
            t0, c0 = p["stages"].get(st, (0.0, 0))
            p["stages"][st] = (t0 + tot, c0 + cnt)
        if got["spans"] is not None:
            p["spans"] = got["spans"]
    eng.close()
    gc.unfreeze()
    out = {}
    for name, p in pooled.items():
        lat = sorted(p["lat"])
        row = {"calls": len(lat),
               "mean_ms": statistics.fmean(lat) * 1e3,
               "p50_ms": lat[len(lat) // 2] * 1e3,
               "p95_ms": lat[int(len(lat) * 0.95)] * 1e3,
               "turn_means_ms": p["turns"]}
        for st, (tot, cnt) in p["stages"].items():
            row[st + "_ms"] = tot / max(cnt, 1)
        if p["spans"] is not None:
            sp = p["spans"]
            row["spans_ms_a_call"] = {
                n: v["total_ms"] / sp["calls"]
                for n, v in sp["names"].items()}
            row["tail_ms"] = sp["tail"]["mean_ms"]
        out[name] = row
    base = out["untraced"]["mean_ms"]
    for row in out.values():
        row["over_untraced_ms"] = row["mean_ms"] - base
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--window-seconds", type=float, default=0.0)
    ap.add_argument("--index", choices=("flat", "ivf"), default="flat")
    args = ap.parse_args(argv)
    out = {"torch": torch.__version__, "device": args.device}
    out.update(block_costs(args.iters))
    span_off = max(out["span_off_us"], out["module_span_off_us"])
    for index_type in ("flat", "ivf"):
        n = blocks_per_call(index_type, args.device, args.batch)
        n["off_us_a_call"] = (n["spans"] * span_off
                              + n["stages"] * out["stage_off_us"])
        out[index_type] = n
    if args.window_seconds > 0:
        out["window"] = window_costs(args.device, args.rows, args.batch,
                                     args.window_seconds,
                                     index_type=args.index)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
