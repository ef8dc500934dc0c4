"""A durable node's opening from its data_dir in set-up
(perfbench/program.py `info`): the loader's checkpoint restored, the doc
store loaded and the WAL's tail replayed, host clock, in s; None for a
node that set-up did not open from a data_dir."""


def read(run):
    return run.info.get("setup_open_s")
