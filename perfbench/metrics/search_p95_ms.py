"""The 95th percentile of the latency of every call of the window (host
clock, from the call's start to the return of its results, which
`search_batch` has synchronised), in ms. Linear interpolation between
order statistics (numpy's default)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.window.latencies) * 1e3, 95))
