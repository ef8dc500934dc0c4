"""The engine's `search.assemble` stage (engine/engine.py, a StageTimer
span): key resolution and compaction of the hits. Mean of the window's last
1,024 calls as for search_device_stage_ms, in ms."""

from perfbench.stages import window_mean_ms


def read(run):
    return window_mean_ms(run, "search.assemble")
