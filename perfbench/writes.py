"""The write side of a write-mixed cell: the seeded plan of single-row
writes, the log of every write, the window that drives a writer thread
beside the searcher, the crash stop and the reopen after it, and the
versions a reference row stands for.

A mix with `writers` (perfbench/traffic.py lists its keys) takes this path;
a mix without takes `traffic.drive` and nothing here runs.

The writer is an open loop: write i of the window is due at the window's
start + i / write_rate, whatever the engine does, and its latency runs
from that due time to its acknowledgement, so a writer that falls behind
shows it. The plan draws which writes, on which keys, with which vectors
from the run's seed; every seed makes the same number of each kind in
every block of the mix (10 writes for shares of tenths) and the same
schedule.
"""

from __future__ import annotations

import itertools
import math
import os
import shutil
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable, Dict, List, Optional

import numpy as np

from perfbench import program
from perfbench.corpus import make_queries
from perfbench.traffic import Traffic, Window

OPS = ("insert", "overwrite", "delete")
INSERT, OVERWRITE, DELETE = range(3)


def fresh_key(j: int) -> str:
    return f"w{j}"


def mix_block(shares: Dict[str, float]) -> np.ndarray:
    """The op codes of the smallest block that holds the mix's shares
    exactly (at most 1,000 writes)."""
    fr = [Fraction(float(shares.get(op, 0.0))).limit_denominator(1000)
          for op in OPS]
    if sum(fr) != 1 or min(fr) < 0:
        raise ValueError(f"write_mix {shares}: shares of {OPS} summing to 1")
    n = math.lcm(*(f.denominator for f in fr))
    return np.repeat(np.arange(len(OPS)), [int(f * n) for f in fr])


class WritePlan:
    """Write i: its op, its key and, for a put, its vector. Inserts take
    fresh keys w0, w1, ...; overwrites and deletes take base keys, each at
    most once, in a seeded order."""

    def __init__(self, params: dict, base_rows: int, centres, spread: float,
                 unit: bool, seconds: float, op_seed: int, vec_seed: int):
        self.rate = float(params["write_rate"])
        self.warm = int(params["warm_writes"])
        self.n = self.warm + int(math.ceil(self.rate * seconds)) + 1
        block = mix_block(params["write_mix"])
        rng = np.random.default_rng(op_seed)
        reps = -(-self.n // block.size)
        order = np.argsort(rng.random((reps, block.size)), axis=1)
        self.ops = block[order].reshape(-1)[:self.n].astype(np.int8)
        ins = self.ops == INSERT
        self.target = np.empty(self.n, np.int64)
        self.target[ins] = np.arange(int(ins.sum()))
        touch = int((~ins).sum())
        if touch > base_rows:
            raise ValueError(f"{touch} overwrites and deletes for "
                             f"{base_rows} base rows")
        self.target[~ins] = rng.permutation(base_rows)[:touch]
        puts = self.ops != DELETE
        self.vec_of = np.full(self.n, -1, np.int64)
        self.vec_of[puts] = np.arange(int(puts.sum()))
        self.vectors = make_queries(centres, int(puts.sum()), spread, unit,
                                    vec_seed)

    def key(self, i: int) -> str:
        if self.ops[i] == INSERT:
            return fresh_key(int(self.target[i]))
        return program.key_of(int(self.target[i]))

    def vector(self, i: int) -> np.ndarray:
        return self.vectors[self.vec_of[i]]

    def apply(self, engine, i: int) -> bool:
        if self.ops[i] == DELETE:
            return program.delete(engine, self.key(i))
        return program.put(engine, self.key(i), self.vector(i))


class WriteLog:
    """Every write sent: due, send and acknowledgement times (host
    perf_counter s; a warm-up write is due when it is sent) and success,
    by plan index; written by the one writer thread in plan order."""

    def __init__(self, n: int):
        self.due = np.full(n, np.nan)
        self.send = np.full(n, np.nan)
        self.ack = np.full(n, np.nan)
        self.ok = np.zeros(n, bool)
        self.sent = 0
        self.fresh_acked: List[int] = []  # acknowledged inserts, in order
        self.live_delta = 0  # acknowledged inserts less deletes
        self.ckpt_after: List[int] = []  # writes whose put checkpointed
        self.first_error: Optional[str] = None

    def record(self, plan: WritePlan, i: int, due: float, send: float,
               ack: float, ok: bool) -> None:
        self.due[i], self.send[i], self.ack[i], self.ok[i] = (due, send, ack,
                                                              ok)
        self.sent = i + 1
        if ok and plan.ops[i] == INSERT:
            self.live_delta += 1
            self.fresh_acked.append(i)
        elif ok and plan.ops[i] == DELETE:
            self.live_delta -= 1

    def failed(self, lo: int = 0) -> int:
        return int((~self.ok[lo:self.sent]).sum())


def _send(engine, plan: WritePlan, log: WriteLog, i: int, due: float,
          checkpoints: List[int]) -> None:
    send = time.perf_counter()
    try:
        ok = plan.apply(engine, i)
    except Exception:  # a write that raises: counted as failed, shown
        ok = False
        if log.first_error is None:
            log.first_error = traceback.format_exc()
    ack = time.perf_counter()
    log.record(plan, i, send if due is None else due, send, ack, ok)
    n = engine.stats["checkpoints"]
    if n != checkpoints[0]:
        checkpoints[0] = n
        log.ckpt_after.append(i)


def warm(engine, plan: WritePlan, log: WriteLog, traffic: Traffic,
         every: int = 50) -> None:
    """Set-up: the plan's warm writes back to back, with a search call of
    real queries after every `every` of them, before the node's background
    flush starts (program.serve). The staged writes grow, so the warm
    searches take every path the window's may: the scan kernel, the exact
    path of a fetch wider than the scan's (k plus the staged deletes), and
    the flush a search forces past flush_batch."""
    checkpoints = [engine.stats["checkpoints"]]
    for i in range(plan.warm):
        _send(engine, plan, log, i, None, checkpoints)
        if i % every == every - 1:
            engine.search_batch(
                traffic.queries(traffic.batch_index(i // every)), traffic.k)


@dataclass
class MixedWindow(Window):
    """A Window whose searches ran beside the writer: the self-query
    slots' readings, the log and
    the writer's lag behind its schedule at its last write (s)."""
    self_checks: List[tuple] = field(default_factory=list)
    log: Optional[WriteLog] = None
    first_write: int = 0
    lag_s: float = 0.0
    unsent: int = 0


def self_slots(traffic: Traffic, call: int) -> int:
    """The self-queries of call `call`: self_query_share of the queries,
    spread evenly over the calls from the first (4 in each call of 32 at
    0.125; one in calls 0, 8, 16, ... of 1)."""
    per = float(traffic.params.get("self_query_share", 0.0)) * traffic.batch
    return int(math.ceil((call + 1) * per - 1e-9)
               - math.ceil(call * per - 1e-9))


def drive_mixed(engine, traffic: Traffic, plan: WritePlan, log: WriteLog,
                seconds: float, sample, span: Optional[Callable] = None
                ) -> MixedWindow:
    """The window: the mix's closed-loop searchers and its open-loop
    writer for `seconds`. A searcher replaces the last self_slots of each
    batch by the vectors of the newest fresh rows acknowledged before it
    sends the call, and keeps, for each such slot, the row, the first
    hit's key and distance and the row's own served distance. Each sampled
    call is kept with its start, its return and its queries. The writer
    sends no write due after the deadline and stops sending 5 s past it;
    the window ends when both have stopped."""
    win = MixedWindow(log=log, first_write=plan.warm)
    lock = threading.Lock()
    errors: List[str] = []
    calls = itertools.count()

    def writer():
        checkpoints = [engine.stats["checkpoints"]]
        for i in range(plan.warm, plan.n):
            due = win.t_start + (i - plan.warm) / plan.rate
            if due >= deadline:
                return
            now = time.perf_counter()
            if now >= deadline + 5.0:
                win.unsent = int(math.ceil((deadline - due) * plan.rate))
                return
            if due > now:
                time.sleep(due - now)
            _send(engine, plan, log, i, due, checkpoints)
            win.lag_s = log.send[i] - due

    def client():
        while True:
            i = next(calls)
            b = traffic.batch_index(i)
            q = traffic.queries(b)
            n_self = self_slots(traffic, i)
            with lock:
                targets = log.fresh_acked[-n_self:] if n_self else []
            if len(targets) < n_self:
                targets = []
            if targets:
                q = q.copy()
                q[-n_self:] = plan.vectors[plan.vec_of[targets]]
            res = None
            t0 = time.perf_counter()
            try:
                if span is None:
                    res = engine.search_batch(q, traffic.k)
                else:
                    with span("perfbench.call"):
                        res = engine.search_batch(q, traffic.k)
            except Exception:  # an answer that never comes: counted, shown
                with lock:
                    if not errors:
                        errors.append(traceback.format_exc())
            t1 = time.perf_counter()
            with lock:
                win.batches.append(b)
                win.latencies.append(t1 - t0)
                win.ends.append(t1)
                win.t_end = max(win.t_end, t1)
                if res is None:
                    win.failed_calls += 1
                else:
                    sample.offer((t0, t1, q), res[0], res[1])
                    for slot, t in enumerate(targets):
                        row = traffic.batch - n_self + slot
                        keys, dists = res[1][row], res[0][row]
                        want = plan.key(t)
                        own = (float(dists[keys.index(want)]) if want in keys
                               else math.inf)
                        win.self_checks.append(
                            (t, keys[0] if keys else None,
                             float(dists[0]) if len(dists) else math.inf,
                             own))
            if t1 >= deadline:
                return

    win.t_start = time.perf_counter()
    deadline = win.t_start + seconds
    w = threading.Thread(target=writer, daemon=True, name="perfbench-writer")
    w.start()
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(traffic.clients - 1)]
    for t in threads:
        t.start()
    client()
    for t in threads:
        t.join()
    w.join()
    if errors:
        print(f"first failed call:\n{errors[0]}", file=sys.stderr)
    if log.first_error:
        print(f"first failed write:\n{log.first_error}", file=sys.stderr)
    return win


@dataclass
class Versions:
    """The reference's rows: the base rows, then one per put of the plan.
    A row is born at its put's send and acknowledgement and dies at the
    acknowledgement of the write that overwrote or deleted it (inf while
    it lives); only acknowledged writes count. `current` is each written
    key's row after the last write (None: deleted)."""
    n_base: int
    born_send: np.ndarray
    born_ack: np.ndarray
    died_ack: np.ndarray
    of_key: Dict[str, List[int]]
    current: Dict[str, Optional[int]]

    def rows_of(self, key) -> List[int]:
        got = self.of_key.get(key)
        if got is not None:
            return got
        r = program.row_of(key)
        return [r] if 0 <= r < self.n_base else []


def versions(plan: WritePlan, log: WriteLog, n_base: int) -> Versions:
    n = n_base + plan.vectors.shape[0]
    born_send = np.full(n, math.inf)
    born_ack = np.full(n, math.inf)
    born_send[:n_base] = born_ack[:n_base] = -math.inf
    died_ack = np.full(n, math.inf)
    of_key: Dict[str, List[int]] = {}
    current: Dict[str, Optional[int]] = {}
    for i in np.flatnonzero(log.ok[:log.sent]).tolist():
        key = plan.key(i)
        if key not in of_key:
            base = program.row_of(key) if plan.ops[i] != INSERT else -1
            of_key[key] = [base] if base >= 0 else []
            current[key] = base if base >= 0 else None
        prev = current[key]
        if prev is not None:
            died_ack[prev] = log.ack[i]
        if plan.ops[i] == DELETE:
            current[key] = None
            continue
        row = n_base + int(plan.vec_of[i])
        born_send[row], born_ack[row] = log.send[i], log.ack[i]
        of_key[key].append(row)
        current[key] = row
    return Versions(n_base, born_send, born_ack, died_ack, of_key, current)


def log_window(run, log: Callable[[str], None]) -> None:
    """Logs what the window of a write-mixed run did, none of which is a
    metric of BENCHMARK.json (PERF.md says why): the writes' latency from
    due and from send, the writer's lag, the searches' p95, the
    checkpoints beside what the puts predict, the background and search
    flushes, the slow path's and the retries' shares (a scatter that
    overlapped a scan) and the shards' slots."""
    win, plan, info = run.window, run.plan, run.info
    wlog, lo = win.log, win.first_write
    due = (wlog.ack[lo:wlog.sent] - wlog.due[lo:wlog.sent]) * 1e3
    own = (wlog.ack[lo:wlog.sent] - wlog.send[lo:wlog.sent]) * 1e3
    pct = np.percentile
    if due.size:
        log(f"writes {due.size}: from due p50 {pct(due, 50):.4f} p95 "
            f"{pct(due, 95):.4f} max {due.max():.4f} ms; from send p50 "
            f"{pct(own, 50):.4f} p95 {pct(own, 95):.4f} ms; lag "
            f"{win.lag_s:.6f} s at the last, {win.unsent} unsent")
    log(f"searches {len(win.batches)}: p95 "
        f"{pct(np.asarray(win.latencies) * 1e3, 95):.4f} ms")
    mark, stats, stages = run.window_mark, info["stats"], info["latency"]

    def grew(name):
        return stats[name] - mark["stats"][name]

    def stage_ms(name):
        return (stages.get(name, {}).get("total_ms", 0.0)
                - mark["stages"].get(name, (0, 0.0))[1])

    puts = int((wlog.ok[lo:wlog.sent]
                & (plan.ops[lo:wlog.sent] != DELETE)).sum())
    every = run.config["dbconfig"]["checkpoint_every_puts"]
    background_s = stage_ms("flush.background") / 1e3
    log(f"window: checkpoints {grew('checkpoints')} ({puts} puts / {every} "
        f"= {puts / every:.2f}); flush.background {background_s:.6f} s, "
        f"flushes {grew('flushes')}; search.flush "
        f"{stage_ms('search.flush'):.3f} ms; slow path "
        f"{grew('search_slow_path')} and retries {grew('search_retries')} of "
        f"{grew('searches')} searches; shards' "
        "slots used "
        f"{[s['used'] for s in info['shards']]} of "
        f"{[s['phys_cap'] for s in info['shards']]}")


def tail_after_checkpoint(log: WriteLog) -> int:
    """Acknowledged writes after the last put that checkpointed: the WAL
    records a reopen has to replay."""
    last = log.ckpt_after[-1] if log.ckpt_after else -1
    return int(log.ok[last + 1:log.sent].sum())


def fs_type(path: str) -> str:
    """The file system type of the mount that holds `path`, and the mount
    point (the longest of /proc/mounts that is a prefix of it)."""
    real = os.path.join(os.path.realpath(path), "")
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                _, mnt, fs = line.split()[:3]
                inside = real.startswith(os.path.join(mnt, ""))
                if inside and len(mnt) > len(best):
                    best, kind = mnt, fs
    except OSError:
        pass
    return f"{kind} at {best or '?'}"


def bytes_written() -> int:
    """The bytes this process has caused to be written to storage
    (/proc/self/io write_bytes); 0 where the kernel does not say."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return 0


def recover(config: dict, data_dir: str, device, probe: np.ndarray, k: int,
            free: Callable[[], None], log: Callable[[str], None]):
    """The crashed engine freed by `free` (what a dead process gives
    back), then the configuration's engine reopened from `data_dir` and
    one search of `probe` answered, timed from the reopen and logged."""
    free()
    t0 = time.perf_counter()
    engine = program.reopen(config, data_dir, device)
    t1 = time.perf_counter()
    engine.search_batch(probe, k)
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    build = engine.timers.snapshot().get("index.build", {})
    log(f"recovered in {seconds:.6f} s: reopen {t1 - t0:.3f} s (wal_replayed "
        f"{engine.stats['wal_replayed']}), first search "
        f"{seconds - (t1 - t0):.3f} s (index.build "
        f"{build.get('total_ms', 0.0) / 1e3:.3f} s); {engine.count()} docs")
    return engine


def lost_writes(engine, plan: WritePlan, vers: Versions) -> int:
    """Written keys whose read-back after the reopen is not their last
    acknowledged write: a put's vector bit for bit, a delete not found."""
    lost = 0
    for key, row in vers.current.items():
        got = program.read_back(engine, key)
        if row is None:
            lost += got is not None
        else:
            want = plan.vectors[row - vers.n_base]
            lost += got is None or not np.array_equal(
                got.view(np.uint32), want.view(np.uint32))
    return lost


def base_rows_lost(engine, rows: np.ndarray, vers: Versions, seed: int,
                   n: int = 4096) -> int:
    """A seeded sample of `n` base keys that no write touched, read back
    after the reopen: those not answering their corpus row bit for bit."""
    rng = np.random.default_rng(seed)
    lost = 0
    picked = 0
    for r in rng.permutation(rows.shape[0]).tolist():
        key = program.key_of(r)
        if key in vers.of_key:
            continue
        got = program.read_back(engine, key)
        lost += got is None or not np.array_equal(
            got.view(np.uint32), rows[r].view(np.uint32))
        picked += 1
        if picked == n:
            break
    return lost


def remove(data_dir: str) -> None:
    shutil.rmtree(data_dir, ignore_errors=True)
