"""The one traffic generator: a mix is a JSON file of parameters under
perfbench/traffic/, read here, and driven by `drive`.

Parameters of a mix:
  loop           "closed": each client sends its next call when the last
                 one has returned
  clients        client threads, each a closed loop on the one engine
  batch          queries a call; k: neighbours asked of each query
  pool_queries   queries drawn from the seed (a multiple of batch is used);
                 calls walk a seeded order of the pool's batches, again
                 from its start once it is spent
  query_spread   noise around the corpus's centres (perfbench/corpus.py)
  warm_calls     calls of real queries in set-up, after the warm-up of the
                 engine's own shape
  check_queries  answers compared with the reference: a seeded uniform
                 sample of ceil(check_queries / batch) calls of the window

A mix may add a writer beside the clients (perfbench/writes.py drives it;
a mix without these keys takes `drive` below and nothing more):
  writers           open-loop writer threads: 1
  write_rate        writes a second summed over the writers, on a fixed
                    schedule: write i of the window is due at the window's
                    start + i / write_rate, and its latency runs from then
                    to its acknowledgement
  write_mix         shares of "insert" (a fresh key), "overwrite" (a live
                    base key, a new vector) and "delete" (a live base key);
                    every block of the mix's smallest size holds them
                    exactly, in a seeded order
  self_query_share  the share of each call's queries replaced by the
                    vectors of the newest fresh rows acknowledged before the
                    call is sent
  warm_writes       writes sent back to back in set-up, before the window
After the window the engine is stopped as a crash would stop it and opened
again from its data_dir (perfbench/program.py).
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from perfbench.check import Sample
from perfbench.corpus import make_queries


class Traffic:
    def __init__(self, params: dict, centres, unit: bool, query_seed: int,
                 order_seed: int):
        if params["loop"] != "closed":
            raise ValueError(f"loop {params['loop']!r}: the generator "
                             "drives closed loops")
        self.params = params
        self.writers = int(params.get("writers", 0))
        if self.writers not in (0, 1):
            raise ValueError(f"writers {self.writers}: the generator drives "
                             "at most one writer")
        self.clients = int(params["clients"])
        self.batch = int(params["batch"])
        self.k = int(params["k"])
        self.n_batches = max(1, int(params["pool_queries"]) // self.batch)
        self.pool = make_queries(centres, self.n_batches * self.batch,
                                 float(params["query_spread"]), unit,
                                 query_seed)
        self.order = np.random.default_rng(order_seed).permutation(
            self.n_batches)

    def batch_index(self, call: int) -> int:
        return int(self.order[call % self.n_batches])

    def queries(self, b: int) -> np.ndarray:
        return self.pool[b * self.batch:(b + 1) * self.batch]

    def sample_calls(self) -> int:
        return -(-int(self.params["check_queries"]) // self.batch)


@dataclass
class Window:
    """What the window's calls did, in call order: each call's pool batch,
    host-clock latency (s) and end (perf_counter s); calls that raised;
    the window's span on the host clock."""
    batches: List[int] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)
    ends: List[float] = field(default_factory=list)
    failed_calls: int = 0
    t_start: float = 0.0
    t_end: float = 0.0

    @property
    def elapsed_s(self) -> float:
        return self.t_end - self.t_start

    def calls_by_slice(self, n: int = 5) -> List[int]:
        """Calls that ended in each of n equal slices of the window."""
        width = self.elapsed_s / n
        out = [0] * n
        for t in self.ends:
            out[min(n - 1, int((t - self.t_start) / width))] += 1
        return out


def drive(search: Callable, traffic: Traffic, seconds: float,
          sample: Sample, span: Optional[Callable] = None) -> Window:
    """Run the mix's clients against `search(queries, k)` for `seconds`.
    Each call is timed from its start to the return of its results; a
    client starts no call after the deadline, and the window ends when the
    last call returns. `span(name)`, where given, wraps each call (a
    profiler range)."""
    win = Window()
    calls = itertools.count()
    lock = threading.Lock()
    errors: List[str] = []

    def client():
        while True:
            i = next(calls)
            b = traffic.batch_index(i)
            q = traffic.queries(b)
            res = None
            t0 = time.perf_counter()
            try:
                if span is None:
                    res = search(q, traffic.k)
                else:
                    with span("perfbench.call"):
                        res = search(q, traffic.k)
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
                    sample.offer(b, res[0], res[1])
            if t1 >= deadline:
                return

    win.t_start = time.perf_counter()
    deadline = win.t_start + seconds
    if traffic.clients == 1:
        client()
    else:
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(traffic.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        print(f"first failed call:\n{errors[0]}", file=sys.stderr)
    return win
