"""Reads the engine's spans of the traced window (`info()["spans"]`) and
the totals of its set-up stages (`info()["latency"]`).

The program opens its spans only while a profiler runs, and the harness
profiles the window alone, so a span's totals are the window's; a run with
--trace 0 has no `spans` entry. The stages are timed in every run, so
their `total_ms` (the set-up stages' totals) needs no profiled window; the
harness reads them in traced runs alone, as it reads every per-layer
metric. A program older than the spans has neither `spans`
nor `total_ms`: every reader here returns None there.
"""

from typing import Iterable, Optional


def _spans(run) -> Optional[dict]:
    spans = run.info.get("spans")
    if not spans or not spans.get("calls"):
        return None
    return spans


def per_call_ms(run, names: Iterable[str]) -> Optional[float]:
    """The spans' summed totals over the window's calls (`search.call`
    roots), in ms a call; None where none of them was recorded."""
    spans = _spans(run)
    if spans is None:
        return None
    got = [spans["names"][n]["total_ms"] for n in names
           if n in spans["names"]]
    if not got:
        return None
    return sum(got) / spans["calls"]


def tail(run) -> Optional[dict]:
    """The calls beyond the p95 (`calls`, `of`) and the mean ms a call of
    each span over them (`mean_ms`) and over every call (`all_mean_ms`)."""
    spans = _spans(run)
    return None if spans is None else spans.get("tail")


def stage_s(run, name: str, children: Iterable[str] = ()) -> Optional[float]:
    """A stage's total over every sample, in s; its children's totals are
    logged beside it."""
    latency = run.info.get("latency", {})
    snap = latency.get(name)
    if snap is None or "total_ms" not in snap:
        return None
    parts = [f"{c} {latency[c]['total_ms'] / 1e3:.3f} s"
             for c in children if "total_ms" in latency.get(c, {})]
    run.log(f"{name} {snap['total_ms'] / 1e3:.3f} s in {snap['count']} "
            f"call(s)" + (": " + ", ".join(parts) if parts else ""))
    return snap["total_ms"] / 1e3
