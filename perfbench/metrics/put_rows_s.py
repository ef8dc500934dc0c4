"""The engine's `put_rows` stage (engine/engine.py): the bulk load's
ingest, its MD5 routing (`put_rows.route`) and its mirror and doc store
writes (`put_rows.write`), summed over every call of the run's set-up, in
s."""

from perfbench.spans import stage_s


def read(run):
    return stage_s(run, "put_rows", ["put_rows.route", "put_rows.write"])
