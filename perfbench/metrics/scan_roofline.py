"""The flat scan kernels' share of their roofline, in percent: the card's
bound for the work perfbench/roofline/scan.py counts over the traced
kernels' time. None where no scan kernel ran."""

from perfbench.peaks import roofline_share


def read(run):
    return roofline_share(run, "scan")
