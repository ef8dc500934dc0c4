"""Queries answered in the window over the window's seconds (host clock):
every call's queries, from the first call's start to the last return."""


def read(run):
    answered = len(run.window.batches) - run.window.failed_calls
    return answered * run.traffic.batch / run.window.elapsed_s
