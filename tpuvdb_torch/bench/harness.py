"""Device-timing harness: the port of tpuvdb.bench.harness.

`chained_timer` keeps the reference's signature and meaning: seconds per
call of fn(*args), the best of `reps` windows of `iters` back-to-back
calls after one warm call. When args[0] is a CUDA tensor each window is
timed by CUDA events around the calls; otherwise by the host clock. (The
reference chains the calls in an on-device loop to see past a remote
relay; a launch queue on the card needs no such loop.) Neither clock goes
backwards, so a window that is not positive raises where the reference
clamps it to 1e-9 s.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def chained_timer(
    fn: Callable,
    args: Sequence,
    iters: int = 20,
    reps: int = 3,
) -> float:
    """Seconds per invocation of fn(*args), best of `reps`."""
    lead = args[0] if args else None
    on_card = isinstance(lead, torch.Tensor) and lead.is_cuda
    fn(*args)
    best = float("inf")
    for _ in range(reps):
        if on_card:
            with torch.cuda.device(lead.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            t = (time.perf_counter() - t0) / iters
        if not t > 0:
            raise RuntimeError(f"chained_timer: a window of {iters} calls "
                               f"took {t} s a call")
        best = min(best, t)
    return best
