"""The index's `index.wait` span: the `.cpu()` of both results, so the
host's wait for the card plus the copy back, in ms a call of the traced
window."""

from perfbench.spans import per_call_ms


def read(run):
    return per_call_ms(run, ["index.wait"])
