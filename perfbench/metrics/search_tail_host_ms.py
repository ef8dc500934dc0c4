"""Over the traced window's calls beyond the p95 of `search.call`, the mean
of each call less its `index.wait`: the host's part of a tail call, in ms.
The tail's mean of every span is logged beside every call's.

It reads a traced call, which the profiler and the spans slow: the tail it
reads is the traced window's, not the untraced `search_p95_ms`'s, and the
host's part of it is inflated most (the profiler records every launch and
copy the host makes). `python -m tpuvdb_torch.bench.tracing_cost
--window-seconds S` times the spans of unprofiled calls beside it."""

from perfbench.spans import tail


def read(run):
    t = tail(run)
    if t is None or "search.call" not in t["mean_ms"]:
        return None
    slow, every = t["mean_ms"], t["all_mean_ms"]
    run.log(f"the {t['calls']} calls beyond the p95 of {t['of']}, ms a call "
            "(tail / every call): " + ", ".join(
                f"{n} {slow[n]:.4f} / {every.get(n, 0.0):.4f}"
                for n in sorted(slow, key=lambda n: -slow[n])))
    return slow["search.call"] - slow.get("index.wait", 0.0)
