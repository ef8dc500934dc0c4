"""Reads the torch.profiler trace of a window (CPU and CUDA activity).

The traced window runs from the start of the first `perfbench.call` range
to the end of the last. Within it:

* `busy_s`: the union of the intervals in which a device operation ran
  (kernels, copies, fills);
* device time by operation name, kernels under their function's name
  (`scan_kernel`, not its template arguments), and launches by name;
* the idle gaps: the window less the busy union, each charged to the
  innermost host operation that was running at its midpoint (an aten op,
  a CUDA runtime call), to the Python between two ops of a call
  ("python after <the op that ended last>", or "python in a call" before
  its first), or to HOST_OUTSIDE where the host was outside every call.

The `perfbench.call` ranges also leave annotations on the device's
timeline; those are no device work and are left out.

Raw kineto events are read, not `key_averages()`, which a window of many
thousand calls makes slow.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

CALL_RANGE = "perfbench.call"
HOST_OUTSIDE = "host, outside any traced op"
_WALK = 256  # host ops looked back over for one around a gap


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)
    device_n: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def seconds(self, names: Iterable[str]) -> float:
        return sum(self.device_s.get(n, 0.0) for n in names)

    def launches(self, name: str) -> int:
        return self.device_n.get(name, 0)

    def top_device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.device_s.items(), key=lambda kv: -kv[1])[:n]

    def top_idle(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]


def short_name(name: str) -> str:
    """A kernel's function name from its signature: 'void (anonymous
    namespace)::foo<float, 128>(args)' -> 'foo'; other names as they
    are."""
    bare = name.replace("(anonymous namespace)::", "")
    m = re.match(r"^(?:void\s+)?([\w:]+)\s*[<(]", bare)
    if not m:
        return name
    return m.group(1).split("::")[-1]


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return ev.name() == CALL_RANGE or (flag is not None and flag())


def _events(prof):
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no kineto results")
    return results.events()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _gap_label(mid: int, host, starts, calls, call_starts) -> str:
    """What the host was doing at `mid` (see the module docstring)."""
    before = None  # the host op that ended last before mid
    j = bisect.bisect_right(starts, mid) - 1
    for _ in range(_WALK):
        if j < 0:
            break
        if host[j][1] >= mid:
            return host[j][2]
        if before is None or host[j][1] > before[1]:
            before = host[j]
        j -= 1
    c = bisect.bisect_right(call_starts, mid) - 1
    if c < 0 or calls[c][1] < mid:
        return HOST_OUTSIDE
    if before is not None and before[1] >= calls[c][0]:
        return f"python after {before[2]}"
    return "python in a call"


def summarize(prof) -> TraceSummary:
    device, host, calls = [], [], []
    for ev in _events(prof):
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            if not _annotation(ev):
                device.append((s, e, name))
        elif name == CALL_RANGE:
            calls.append((s, e))
        else:
            host.append((s, e, name))
    if not calls:
        raise RuntimeError(f"no {CALL_RANGE} range in the trace")
    calls.sort()
    w0, w1 = calls[0][0], max(e for _, e in calls)
    out = TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=0.0)
    spans = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        spans.append((s, e))
        key = short_name(name)
        out.device_s[key] = out.device_s.get(key, 0.0) + (e - s) * 1e-9
        out.device_n[key] = out.device_n.get(key, 0) + 1
    busy = _union(spans)
    out.busy_s = sum(e - s for s, e in busy) * 1e-9
    host.sort(key=lambda h: (h[0], -h[1]))  # an outer range first
    starts = [h[0] for h in host]
    call_starts = [c[0] for c in calls]
    edge = w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            label = _gap_label((edge + s) // 2, host, starts, calls,
                               call_starts)
            out.idle_by_host[label] = (out.idle_by_host.get(label, 0.0)
                                       + (s - edge) * 1e-9)
        edge = max(edge, e)
    return out
