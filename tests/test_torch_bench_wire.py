"""The port's wire bench (tpuvdb_torch/bench/wire.py) against the
reference's scripts/bench_wire.py, run unedited (loaded from its path, its
`main()` called with sys.argv patched), on the CPU at 2,000 x 64: the same
JSON keys, the same `rows`, `dim` and `payload_mb`, each export counting
every row on both wires (the export pages recorded through a patch that
calls through), and the same `sync_all_peak_records` (both coordinators
stream one shard at a time over the same 4-shard routing). Timings are
not compared. The JAX package's native library is switched off, so no
test waits on its build.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import pytest

import tpuvdb.native as jax_native
from tpuvdb_torch.bench import wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--rows", "2000", "--dim", "64"]


def _recording(export_all, into: list):
    def record(client, limit=2000):
        n = export_all(client, limit)
        into.append((client.binary, limit, n))
        return n

    return record


@pytest.fixture(scope="module")
def runs():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_wire", os.path.join(ROOT, "scripts", "bench_wire.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want_exports, got_exports = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_native, "rescore_available", lambda: False)
        mp.setattr(ref, "export_all", _recording(ref.export_all,
                                                 want_exports))
        mp.setattr(wire, "export_all", _recording(wire.export_all,
                                                  got_exports))
        mp.setattr(sys, "argv", ["bench_wire.py", *ARGV])
        want, got = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(want), \
                contextlib.redirect_stderr(io.StringIO()):
            ref.main()
        with contextlib.redirect_stdout(got), \
                contextlib.redirect_stderr(io.StringIO()):
            returned = wire.main(ARGV, device="cpu")
    return {"want": json.loads(want.getvalue().splitlines()[-1]),
            "got": json.loads(got.getvalue().splitlines()[-1]),
            "returned": returned, "want_exports": want_exports,
            "got_exports": got_exports}


def test_line_has_the_reference_keys(runs):
    want, got = runs["want"], runs["got"]
    assert set(got) == set(want)
    assert got == runs["returned"]
    for key in ("metric", "rows", "dim", "payload_mb"):
        assert got[key] == want[key], key
    assert got["rows"] == 2000 and got["payload_mb"] == 0.5


@pytest.mark.parametrize("side", ["want_exports", "got_exports"])
def test_each_wire_exports_every_row(runs, side):
    # a warm-up of pages of 500, then the timed export of 2,000, per wire
    assert runs[side] == [(False, 500, 2000), (False, 2000, 2000),
                          (True, 500, 2000), (True, 2000, 2000)]


def test_sync_all_holds_the_same_peak(runs):
    want, got = runs["want"], runs["got"]
    assert got["sync_all_peak_records"] == want["sync_all_peak_records"]
    assert 0 < got["sync_all_peak_records"] < 2 * 2000
    assert got["sync_all_2node_s"] > 0 and got["export_binary_s"] > 0
