"""One run of one cell: set-up, the measured window, the readings, the
check against the reference, and the result line.

Order, so that each number measures what it says:
  1. the corpus and the queries from the seed (perfbench/corpus.py,
     perfbench/traffic.py), the engine built and bulk-loaded, its shape
     warmed (perfbench/program.py): set-up, up to the first call;
  2. the window: closed-loop calls for `seconds`, under torch.profiler
     with --trace 1; a seeded sample of the answers is kept;
  3. the device's peak memory, the engine's counters and spans, and the
     cell's metric readers, while the engine still lives;
  4. the engine closed and freed, then the plain reference on the sampled
     queries (perfbench/check.py);
  5. the result line, the compared numbers last.

A mix with a writer (perfbench/writes.py) adds, in this order: the write
plan from the seed and the warm writes in set-up; the writer beside the
searchers in the window; after step 3, the crash stop, the engine freed,
the timed reopen from its data_dir (`recover_s`) and the read-back of every
written key and of a sample of untouched base keys; in step 4 the answers
held against the rows live at each call's start (`check.live_numbers`).
A mix without a writer runs none of it.
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from perfbench import check, program, writes
from perfbench.corpus import make_corpus, seed_streams
from perfbench.peaks import ELEMENT_BYTES
from perfbench.registry import Registry
from perfbench.trace import TraceSummary, summarize
from perfbench.traffic import Traffic, Window, drive


@dataclass
class Run:
    """What a metric reader may read (perfbench/metrics/*.py)."""
    registry: Registry
    cell: dict
    config: dict
    traffic: Traffic
    window: Window
    setup_s: float
    peak_bytes: int
    info: dict
    stage_counts_before: dict
    trace: Optional[TraceSummary]
    ivf_state: Optional[dict]
    power_limit: str
    log: Callable[[str], None]
    # a write-mixed cell's: the engine's counters and stages when the
    # window opened (program.window_mark), and the plan
    window_mark: Optional[dict] = None
    plan: Optional[writes.WritePlan] = None

    @property
    def dim(self) -> int:
        return int(self.config["corpus"]["dim"])

    @property
    def live_rows(self) -> int:
        return int(self.info["docs"])

    @property
    def storage_dtype(self) -> str:
        return self.config["dbconfig"].get("storage_dtype", "float32")

    @property
    def element_bytes(self) -> int:
        return ELEMENT_BYTES[self.storage_dtype]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi(fields: str) -> str:
    """The card's `fields` as nvidia-smi reads them (csv, no header)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _finite(x: float):
    return x if math.isfinite(x) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", registry: Optional[Registry] = None,
             t_start: Optional[float] = None, log=_log) -> dict:
    """The result line of one run, as a dict. `t_start` is the process's
    start on the perf_counter clock (the call's own start when None)."""
    t_start = time.perf_counter() if t_start is None else t_start
    reg = registry or Registry()
    cell = reg.workload(workload)
    config = reg.config(cell["config"])
    params = reg.traffic(cell["traffic"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    s_query, s_order, s_sample = seed_streams(seed)

    marks = [("start", t_start), ("imports", time.perf_counter())]
    if cuda:
        torch.empty(1, device=dev)
        marks.append(("CUDA context", time.perf_counter()))
    rows, centres = make_corpus(config["corpus"], dev)
    traffic = Traffic(params, centres, bool(config["corpus"]["unit_norm"]),
                      s_query, s_order)
    plan = None
    if traffic.writers:
        if not config.get("durability"):
            raise ValueError(f"{workload}: a mix with a writer needs a "
                             "configuration with durability on")
        s_ops, s_vecs, s_base = seed_streams(seed, 6)[3:]
        plan = writes.WritePlan(params, rows.shape[0], centres,
                                float(config["corpus"]["spread"]),
                                bool(config["corpus"]["unit_norm"]), seconds,
                                s_ops, s_vecs)
    del centres
    marks.append(("inputs", time.perf_counter()))
    engine = program.build(config, rows, dev)
    marks.append(("load and index", time.perf_counter()))
    program.warm(engine, traffic)
    marks.append(("warm-up", time.perf_counter()))
    if plan is not None:
        wlog = writes.WriteLog(plan.n)
        writes.warm(engine, plan, wlog, traffic)
        program.serve(engine)
        marks.append(("warm writes", time.perf_counter()))
        log(f"data_dir on {writes.fs_type(engine.data_dir)}; "
            f"{plan.warm} warm writes, {wlog.failed()} failed, "
            f"{len(wlog.ckpt_after)} checkpoint(s); device peak "
            f"{torch.cuda.max_memory_allocated(dev) if cuda else 0} bytes")
    log("set-up: " + ", ".join(
        f"{name} {t - prev:.3f} s"
        for (_, prev), (name, t) in zip(marks, marks[1:])))
    before = program.stage_counts(engine)
    mark = program.window_mark(engine) if plan is not None else None
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    sample = check.Sample(traffic.sample_calls(), s_sample)

    prof = None
    span = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        span = torch.profiler.record_function
    if plan is None:
        window = drive(engine.search_batch, traffic, seconds, sample, span)
    else:
        window = writes.drive_mixed(engine, traffic, plan, wlog, seconds,
                                    sample, span)
    if cuda:
        torch.cuda.synchronize(dev)
        log("card after the window: "
            + nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    log(f"calls by fifth of the window: {window.calls_by_slice()}")
    summary = None
    if prof is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        summary = summarize(prof)
        log(f"trace read in {time.perf_counter() - t0:.3f} s")
        del prof
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    run = Run(registry=reg, cell=cell, config=config, traffic=traffic,
              window=window, setup_s=window.t_start - t_start,
              peak_bytes=peak, info=program.info(engine),
              stage_counts_before=before,
              trace=summary, ivf_state=program.ivf_state(engine),
              power_limit=(nvidia_smi("name,power.limit") if cuda
                           else "cpu"), log=log, window_mark=mark, plan=plan)
    if plan is not None:
        data_dir = engine.data_dir
        program.crash(engine)
        del engine  # the reopen frees what is left of it first
        after = _reopen_and_read_back(run, data_dir, rows, s_base, dev,
                                      log)
    metrics = {}
    for m in reg.metrics_for(workload, trace):
        value = reg.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if run.info.get("ivf"):
        log(f"ivf index: {run.info['ivf']}")
    log(f"card: {run.power_limit}; calls {len(window.batches)}, "
        f"window {window.elapsed_s:.6f} s, set-up {run.setup_s:.6f} s")

    if plan is None:
        engine.close()
        del engine
        gc.unfreeze()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    else:
        return _result_with_writes(run, rows, sample, after, metrics, dev,
                                   log)

    kept = sample.kept
    queries = (np.concatenate([traffic.queries(b) for b, _, _ in kept])
               if kept else np.zeros((0, run.dim), np.float32))
    dists = [d for _, ds, _ in kept for d in np.asarray(ds)]
    keys = [k for _, _, ks in kept for k in ks]
    ids, dist, malformed = check.answers_to_arrays(dists, keys, traffic.k,
                                                   program.row_of)
    t0 = time.perf_counter()
    values = check.numbers(queries, ids, dist, malformed, rows, traffic.k,
                           reg.reference(config["reference"]), device=dev)
    log(f"reference on {len(keys)} answers in "
        f"{time.perf_counter() - t0:.3f} s")
    correct, table = check.judge(
        values, check.limits(config),
        extra={"failed_calls": (float(window.failed_calls), 0.0),
               "unchecked": (0.0 if keys else 1.0, 0.0)})

    return _result(run, dev, metrics, correct, table,
                   attempted=len(window.batches) * traffic.batch,
                   failed=window.failed_calls * traffic.batch)


def _result(run: Run, dev, metrics: dict, correct: bool, table: dict,
            attempted: int, failed: int) -> dict:
    cuda = dev.type == "cuda"
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": int(run.cell["chips"]),
        "memory_peak_bytes": run.peak_bytes,
    }
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    summary = run.trace
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary.top_device_ops()],
            "idle_gaps": [[n, s] for n, s in summary.top_idle()],
        }
    result["checks"] = {n: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for n, v in table.items()}
    return result


def _reopen_and_read_back(run: Run, data_dir: str, rows: np.ndarray,
                          seed: int, dev, log) -> dict:
    """A write-mixed cell after step 3 and the crash stop: the stopped
    engine freed, the timed reopen from its data_dir, then every written
    key and a seeded sample of untouched base keys read back; the
    data_dir removed."""
    window, plan, traffic = run.window, run.plan, run.traffic

    def free():
        gc.unfreeze()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    probe = traffic.queries(traffic.batch_index(0))
    reopened = writes.recover(run.config, data_dir, dev, probe, traffic.k,
                              free, log)
    vers = writes.versions(plan, window.log, int(run.config["corpus"]["rows"]))
    t0 = time.perf_counter()
    lost = writes.lost_writes(reopened, plan, vers)
    base_lost = writes.base_rows_lost(reopened, rows, vers, seed)
    replayed = int(reopened.stats["wal_replayed"])
    tail = writes.tail_after_checkpoint(window.log)
    log(f"read back {len(vers.current)} written keys and 4,096 untouched "
        f"base keys in {time.perf_counter() - t0:.3f} s: {lost} and "
        f"{base_lost} lost; wal_replayed {replayed} of a tail of {tail} "
        "acknowledged writes")
    program.crash(reopened)
    del reopened
    free()
    writes.remove(data_dir)
    log(f"the process wrote {writes.bytes_written() / 2 ** 30:.3f} GiB to "
        "storage (/proc/self/io write_bytes)")
    return {"versions": vers, "lost": lost, "base_lost": base_lost,
            "replayed": replayed, "tail": tail}


def _result_with_writes(run: Run, rows: np.ndarray, sample, after: dict,
                        metrics: dict, dev, log) -> dict:
    """Step 4 and the result line of a write-mixed cell, whose engines are
    gone: the answers against the rows live at their calls' starts."""
    window, plan, traffic, k = (run.window, run.plan, run.traffic,
                                run.traffic.k)
    writes.log_window(run, log)
    kept = sample.kept
    queries = (np.concatenate([q for (_, _, q), _, _ in kept])
               if kept else np.zeros((0, run.dim), np.float32))
    at = np.concatenate([np.full(len(ks), t0) for (t0, _, _), _, ks in kept]
                        ) if kept else np.zeros(0)
    ret = np.concatenate([np.full(len(ks), t1) for (_, t1, _), _, ks in kept]
                         ) if kept else np.zeros(0)
    dists = [d for _, ds, _ in kept for d in np.asarray(ds)]
    keys = [kk for _, _, ks in kept for kk in ks]
    vers = after["versions"]
    t0 = time.perf_counter()
    values = check.live_numbers(queries, at, ret, dists, keys, k, vers,
                                [rows, plan.vectors],
                                run.registry.reference(
                                    run.config["reference"]), device=dev)
    log(f"reference on {len(keys)} answers in "
        f"{time.perf_counter() - t0:.3f} s")
    lim = check.limits(run.config)
    lim["stale_answers"] = 0.0
    unseen = check.unseen_writes(
        window.self_checks, plan.key,
        lambda t: float(np.dot(plan.vector(t), plan.vector(t))),
        lim["dist_gap"])
    log(f"self-queries: {len(window.self_checks)} checked, {unseen} unseen")
    failed_writes = window.log.failed()
    correct, table = check.judge(
        values, lim,
        extra={"failed_calls": (float(window.failed_calls), 0.0),
               "failed_writes": (float(failed_writes), 0.0),
               "unseen_writes": (float(unseen), 0.0),
               "lost_writes": (float(after["lost"]), 0.0),
               "base_rows_lost": (float(after["base_lost"]), 0.0),
               "wal_tail_missed": (float(abs(after["tail"]
                                             - after["replayed"])), 0.0),
               "unchecked": (0.0 if keys and window.self_checks else 1.0,
                             0.0)})
    n_writes = window.log.sent - plan.warm
    return _result(run, dev, metrics, correct, table,
                   attempted=len(window.batches) * traffic.batch + n_writes,
                   failed=(window.failed_calls * traffic.batch
                           + window.log.failed(plan.warm)))
