"""Per-stage latency tracing + device profiler hook.

`StageTimer` is a copy of tpuvdb.utils.tracing.StageTimer; `device_trace`
captures a torch.profiler trace (CPU + CUDA activity) instead of a
jax.profiler one.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict


class StageTimer:
    """Rolling latency stats per named stage (lock-free enough for serving)."""

    def __init__(self, window: int = 1024):
        self.window = window
        self._lock = threading.Lock()
        self._samples: Dict[str, list] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                buf = self._samples.setdefault(name, [])
                buf.append(dt)
                if len(buf) > self.window:
                    del buf[: len(buf) - self.window]
                self._counts[name] = self._counts.get(name, 0) + 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            for name, buf in self._samples.items():
                if not buf:
                    continue
                s = sorted(buf)
                n = len(s)
                out[name] = {
                    "count": self._counts.get(name, n),
                    "p50_ms": round(s[n // 2] * 1e3, 3),
                    "p95_ms": round(s[min(n - 1, int(n * 0.95))] * 1e3, 3),
                    "p99_ms": round(s[min(n - 1, int(n * 0.99))] * 1e3, 3),
                    "mean_ms": round(sum(s) / n * 1e3, 3),
                }
        return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block into
    `log_dir/trace.json` (Chrome trace format)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
