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

from perfbench import check, program
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
    del centres
    marks.append(("inputs", time.perf_counter()))
    engine = program.build(config, rows, dev)
    marks.append(("load and index", time.perf_counter()))
    program.warm(engine, traffic)
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{name} {t - prev:.3f} s"
        for (_, prev), (name, t) in zip(marks, marks[1:])))
    before = program.stage_counts(engine)
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
    window = drive(engine.search_batch, traffic, seconds, sample, span)
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
              peak_bytes=peak, info=engine.info(), stage_counts_before=before,
              trace=summary, ivf_state=program.ivf_state(engine),
              power_limit=(nvidia_smi("name,power.limit") if cuda
                           else "cpu"), log=log)
    metrics = {}
    for m in reg.metrics_for(workload, trace):
        value = reg.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if run.info.get("ivf"):
        log(f"ivf index: {run.info['ivf']}")
    log(f"card: {run.power_limit}; calls {len(window.batches)}, "
        f"window {window.elapsed_s:.6f} s, set-up {run.setup_s:.6f} s")

    engine.close()
    del engine
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

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

    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": int(cell["chips"]),
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": bool(correct),
        "attempted": len(window.batches) * traffic.batch,
        "failed": window.failed_calls * traffic.batch,
        "metrics": metrics,
        "device": device_info,
    }
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
