"""The index's host work on the search path, in ms a call of the traced
window: the spans `index.upload` (the query upload), `index.plan` (IVF's
coarse pick and probe lists), `index.launch` (the rest of the launch path
up to the first copy back) and `index.row_map` (the results as numpy, the
cells' ids mapped to rows, the host delta merge), in index/exact.py,
index/ivf.py, kernels/ivf_probe.py and engine/engine.py."""

from perfbench.spans import per_call_ms

SPANS = ["index.upload", "index.plan", "index.launch", "index.row_map"]


def read(run):
    return per_call_ms(run, SPANS)
