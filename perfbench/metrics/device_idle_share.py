"""The share of the traced window in which no device operation ran
(torch.profiler; perfbench/trace.py), as a fraction."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
