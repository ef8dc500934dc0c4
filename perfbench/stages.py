"""Reads the engine's StageTimer spans (`info()["latency"]`)."""

WINDOW = 1024  # samples a StageTimer keeps (utils/tracing.py)


def window_mean_ms(run, stage: str):
    """The stage's mean over its kept samples, when all of them are the
    window's: the window added at least WINDOW of them."""
    snap = run.info.get("latency", {}).get(stage)
    if snap is None:
        return None
    added = snap["count"] - run.stage_counts_before.get(stage, 0)
    if added < WINDOW:
        return None
    return float(snap["mean_ms"])
