"""The IVF probe kernels' share of their roofline, in percent: the card's
bound for the work perfbench/roofline/ivf_probe.py counts over the traced
kernels' time. None where no probe kernel ran."""

from perfbench.peaks import roofline_share


def read(run):
    return roofline_share(run, "ivf_probe")
