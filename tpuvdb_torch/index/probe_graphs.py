"""CUDA graphs of the IVF probe, one per recurring probe shape.

From the query buffer to its (dist, grouped id) results, an IVF search
issues some fifty small device ops and one library launch (the coarse
pick, the plan, the mask, the group table, the probe kernels and the
epilogue), and none of them reads a value back to the host. Each costs
tens of microseconds of host time and a few of the card's, so the card
waits on the host. A CUDA graph replays the same kernels on the same
buffers in one launch: the answers are the eager path's, bit for bit.

A graph pays only where its key, the padded batch and the search's k, nprobe
and form (IVFIndex.search), recurs: a serving stream of a few batch sizes,
such as a closed-loop client's fixed batch or a coalescer's common stacks.
`GraphCache` is the policy, free of any device so that the CPU tests can
drive it with stand-ins for capture and replay:

  * a key's first call runs eagerly ("cold"), its second captures the
    key's graph and replays it, and later calls replay;
  * an index captures at most MAX_GRAPHS graphs in its life and evicts
    none: once they are taken, a key without a graph runs eagerly ("full"),
    so a stream of ever new shapes pays for MAX_GRAPHS captures at most,
    and their memory pools stay bounded;
  * a call that finds its key's graph in use by another thread runs
    eagerly ("busy") and does not wait;
  * a key whose capture raised runs eagerly for good ("uncapturable"; the
    attempt takes one of the MAX_GRAPHS), and the call that tried answers
    eagerly: a capture never raises to the caller;
  * calls the index never graphs are counted by why ("filtered", "pq",
    "cpu"), so the counts add up to the index's searches.

`capture_graph` is the CUDA half: one warm pass on a side stream, as
torch.cuda.graphs asks (lazily made state such as cuBLAS workspaces then
exists on that stream), then the capture there, in the "thread_local"
mode so that other threads' eager searches and writes stay legal meanwhile.
The probe's launch counters count a captured launch at each replay
(kernels/ivf_probe.launches_into / count_launches).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Hashable

import torch

from tpuvdb_torch.kernels import ivf_probe
from tpuvdb_torch.utils.logging import get_logger

MAX_GRAPHS = 8      # captures an index makes in its life
_REMEMBERED = 64    # keys remembered as seen once
REASONS = ("cold", "full", "busy", "uncapturable", "filtered", "pq", "cpu")
STATS = ("replays", "captures") + tuple(f"eager_{r}" for r in REASONS)

logger = get_logger("tpuvdb_torch.index.probe_graphs")


class _Graph:
    """One key's graph: `replay` is None until its capture ends; `lock` is
    held from the capture or the copy into the graph's input buffer
    through the host copy of its outputs."""

    __slots__ = ("lock", "replay")

    def __init__(self):
        self.lock = threading.Lock()
        self.replay = None


class GraphCache:
    """The graphs of one index by key, and its counts (see the module)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._graphs: Dict[Hashable, _Graph] = {}
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._dead = set()
        self._counts: collections.Counter = collections.Counter()

    def stats(self) -> Dict[str, int]:
        """The counts by STATS: replays, captures and eager_<reason> for
        each of REASONS."""
        with self._lock:
            return {name: self._counts[name.replace("eager_", "")]
                    for name in STATS}

    def bypass(self, reason: str) -> None:
        """Count a call the index answers without asking for a graph."""
        with self._lock:
            self._counts[reason] += 1

    def run(self, key: Hashable, eager: Callable, capture: Callable, *args):
        """Answer one call of `key`: eager(*args) without a graph, or
        replay(*args) with the key's graph, where capture(*args) records
        the graph and returns its `replay`."""
        graph, fresh = self._claim(key)
        if graph is None:
            return eager(*args)
        try:
            if fresh:
                try:
                    graph.replay = capture(*args)
                except Exception:   # noqa: BLE001 - a search must answer
                    logger.warning("probe graph capture failed for %r; "
                                   "this shape stays eager", key,
                                   exc_info=True)
                    with self._lock:
                        del self._graphs[key]
                        self._dead.add(key)
                        self._counts["uncapturable"] += 1
                    return eager(*args)
            with self._lock:
                self._counts["replays"] += 1
                self._counts["captures"] += fresh
            return graph.replay(*args)
        finally:
            graph.lock.release()

    def _claim(self, key):
        """(graph, fresh): the key's graph with its lock held, fresh when
        this call is to capture it; (None, False) for an eager call, which
        is counted here."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None:
                if graph.lock.acquire(blocking=False):
                    return graph, False
                self._counts["busy"] += 1
                return None, False
            if key in self._dead:
                self._counts["uncapturable"] += 1
                return None, False
            if len(self._graphs) + len(self._dead) >= MAX_GRAPHS:
                self._counts["full"] += 1
                return None, False
            if key not in self._seen:
                self._counts["cold"] += 1
                self._seen[key] = True
                if len(self._seen) > _REMEMBERED:
                    self._seen.popitem(last=False)
                return None, False
            del self._seen[key]
            graph = _Graph()
            graph.lock.acquire()
            self._graphs[key] = graph
            return graph, True


def capture_graph(fn: Callable, device: torch.device):
    """Record fn(), device work that reads nothing back to the host, as a
    CUDA graph. Returns (graph, what fn returned while captured: the
    buffers each replay writes, launches): `launches` are the probe
    launches the capture recorded, which each replay counts."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    launches = collections.Counter()
    with torch.cuda.stream(side):
        fn()
        with ivf_probe.launches_into(launches):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                try:
                    graph.capture_end()
                except RuntimeError:
                    _end_pool(graph, device)
                    raise
    current.wait_stream(side)
    return graph, out, launches


def _end_pool(graph, device) -> None:
    """After a capture that failed to end: stop sending this thread's
    allocations to the graph's memory pool, where the failed end may have
    left them going (the pool's few blocks stay reserved)."""
    index = torch.device(device).index
    try:
        torch._C._cuda_endAllocateToPool(
            torch.cuda.current_device() if index is None else index,
            graph.pool())
    except RuntimeError:
        pass    # the end had stopped it
