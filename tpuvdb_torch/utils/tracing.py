"""Per-stage latency tracing, spans on the profiler's timeline, and the
device profiler hook.

`StageTimer` started as a copy of tpuvdb.utils.tracing.StageTimer. It
times two kinds of named blocks:

  stage(name)  always on: the newest `window` samples (percentiles) and a
               running total and count over every sample (`snapshot()`).
  span(name)   the fine blocks of the hot path: with no profiler running
               it returns one shared no-op (one check of the profiler's
               flag); while torch.profiler runs it is timed like a stage.

While a profiler runs, every stage and span also opens a profiler range of
its own name (`_RecordFunctionFast`, which puts no user annotation on the
device's timeline; `record_function` where torch lacks it), so the
program's blocks sit on the kineto timeline, the device trace's own clock,
and an idle gap of the card inside one is the block's to own. Traced
blocks keep per-name totals (count, total, self time: the block less the
traced blocks nested in it on the same thread) and, for each root span
(one request), its duration and its blocks' durations by name, the newest
`CALLS_KEPT` of them, for the calls beyond the p95 (`spans()`). A read of
`spans()` with no profiler running ends the session: it reads the same
until the next traced block, which starts a session afresh.

Nesting lives in a thread-local stack of open blocks, so code below the
engine (the indexes, the kernels' wrappers) opens its blocks through the
module-level `stage()` and `span()`, which join the timer of the block
open on the calling thread and do nothing where none is.

`device_trace` captures a torch.profiler trace (CPU + CUDA activity).
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import threading
import time
from typing import Dict, Optional

import torch

CALLS_KEPT = 1 << 17  # root spans kept for the tail, per profiled session
TAIL_SHARE = 0.05     # the calls beyond the p95

_profiling = torch._C._autograd._profiler_enabled
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)
_clock = time.perf_counter


class _Local(threading.local):
    top = None  # the innermost open _Block of this thread


_tls = _Local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Block:
    """One open stage or span; a frame of the thread's stack."""
    __slots__ = ("timer", "name", "stage", "root", "parent", "rf", "t0",
                 "child", "calls")

    def __init__(self, timer: "StageTimer", name: str, stage: bool,
                 root: bool = False):
        self.timer = timer
        self.name = name
        self.stage = stage
        self.root = root

    def __enter__(self):
        parent = self.parent = _tls.top
        _tls.top = self
        self.child = 0.0
        if _profiling():
            self._trace(parent)
        else:
            self.rf = self.calls = None
        self.t0 = _clock()
        return self

    def _trace(self, parent) -> None:
        timer = self.timer
        if timer._ended:
            timer._begin_session()
        calls = parent.calls if parent is not None else None
        if self.root:
            # a root inside an open root is one of its blocks
            self.root = calls is None
            self.calls = {} if calls is None else calls
        else:
            self.calls = calls
        self.rf = _range(self.name)
        self.rf.__enter__()

    def __exit__(self, *exc):
        rf = self.rf
        if rf is not None:
            rf.__exit__(None, None, None)
        # read after the range closes, as it was read after it opened: the
        # two reads lag the range's own timestamps alike
        dt = _clock() - self.t0
        parent = self.parent
        _tls.top = parent
        if parent is not None:
            parent.child += dt
        if self.stage:
            self.timer._add_stage(self.name, dt)
        if rf is not None:
            self.timer._add_traced(self, dt)
        return False


class StageTimer:
    """Latency stats per named stage and, while a profiler runs, per span
    (see the module docstring)."""

    def __init__(self, window: int = 1024):
        self.window = window
        self._lock = threading.Lock()
        # per stage: [the newest `window` samples, count, total]
        self._stages: Dict[str, list] = {}
        # the profiled session: traced totals by name [count, total, self]
        self._ended = True  # the next traced block starts a session
        self._traced: Dict[str, list] = {}
        self._roots = 0
        self._calls: collections.deque = collections.deque(maxlen=CALLS_KEPT)

    def stage(self, name: str) -> _Block:
        """Always timed; a profiler range too while a profiler runs."""
        return _Block(self, name, True)

    def span(self, name: str, root: bool = False):
        """Timed only while a profiler runs; the shared no-op otherwise.
        A root span is one request: its blocks are kept by call."""
        if not _profiling():
            return _NOOP
        return _Block(self, name, False, root)

    def _add_stage(self, name: str, dt: float) -> None:
        with self._lock:
            st = self._stages.get(name)
            if st is None:
                st = self._stages[name] = [
                    collections.deque(maxlen=self.window), 0, 0.0]
            st[0].append(dt)
            st[1] += 1
            st[2] += dt

    def _add_traced(self, b: _Block, dt: float) -> None:
        with self._lock:
            t = self._traced.get(b.name)
            if t is None:
                t = self._traced[b.name] = [0, 0.0, 0.0]
            t[0] += 1
            t[1] += dt
            t[2] += dt - b.child
            if b.calls is not None:
                b.calls[b.name] = b.calls.get(b.name, 0.0) + dt
            if b.root:
                self._roots += 1
                self._calls.append((dt, b.calls))

    def _begin_session(self) -> None:
        with self._lock:
            if not self._ended:
                return
            self._ended = False
            self._traced = {}
            self._roots = 0
            self._calls.clear()

    @staticmethod
    def _tail_of(calls) -> Optional[dict]:
        """Mean ms a call of each block (the root's own name its whole
        duration) over the calls beyond the p95, the ceil(5%) slowest
        roots (`mean_ms`), and over every kept call (`all_mean_ms`); a call
        without a block counts 0 for it."""
        n = len(calls)
        if not n:
            return None
        m = math.ceil(TAIL_SHARE * n)
        slow = sorted(calls, key=lambda c: c[0], reverse=True)[:m]

        def means(group, k):
            sums: Dict[str, float] = {}
            for _, blocks in group:
                for name, v in blocks.items():
                    sums[name] = sums.get(name, 0.0) + v
            return {name: v * 1e3 / k for name, v in sums.items()}

        return {"calls": m, "of": n, "mean_ms": means(slow, m),
                "all_mean_ms": means(calls, n)}

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per stage: count and total over every sample; p50, p95 and the
        mean over the newest `window`."""
        out = {}
        with self._lock:
            for name, (buf, count, total) in self._stages.items():
                s = sorted(buf)
                n = len(s)
                out[name] = {
                    "count": count,
                    "total_ms": round(total * 1e3, 3),
                    "p50_ms": round(s[n // 2] * 1e3, 3),
                    "p95_ms": round(s[min(n - 1, int(n * 0.95))] * 1e3, 3),
                    "mean_ms": round(sum(s) / n * 1e3, 3),
                }
        return out

    def spans(self) -> Optional[dict]:
        """The session's blocks, or None where none was traced: per name
        count, total_ms and self_ms (`names`); `calls`, the roots; `tail`,
        as `_tail_of` gives it (None without roots). Read with no profiler
        running, it ends the session."""
        with self._lock:
            if not _profiling():
                self._ended = True
            if not self._traced:
                return None
            names = {name: {"count": c, "total_ms": tot * 1e3,
                            "self_ms": own * 1e3}
                     for name, (c, tot, own) in self._traced.items()}
            return {"names": names, "calls": self._roots,
                    "tail": self._tail_of(self._calls)}


def stage(name: str):
    """A stage of the timer whose block is open on this thread; nothing
    where none is."""
    top = _tls.top
    if top is None:
        return _NOOP
    return _Block(top.timer, name, True)


def span(name: str):
    """A span of the timer whose block is open on this thread, while a
    profiler runs; the shared no-op otherwise."""
    if not _profiling():
        return _NOOP
    top = _tls.top
    if top is None:
        return _NOOP
    return _Block(top.timer, name, False)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block into
    `log_dir/trace.json` (Chrome trace format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
