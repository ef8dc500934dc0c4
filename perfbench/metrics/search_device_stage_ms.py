"""The engine's `search.device` stage (engine/engine.py, a StageTimer
span): the index search's host work, its launches and the card's time up to
the copy back. The timer keeps the last 1,024 samples, so this is the mean
of the window's last 1,024 calls; None where the window made fewer (the
mean would hold warm-up calls), in ms."""

from perfbench.stages import window_mean_ms


def read(run):
    return window_mean_ms(run, "search.device")
