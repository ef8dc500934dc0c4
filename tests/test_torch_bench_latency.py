"""The port's latency benchmark (tpuvdb_torch/bench/latency.py) against the
reference's bench_latency.py, run unedited (loaded from its path, `main()`
under a patched sys.argv), on the CPU.

Shape: `--rows 4096 --dim 32 --reps 5`, in three modes: `--mode exact`,
`--mode approx --index ivf` and `--mode int8`, each run once by both in a
module fixture. The JAX package's native library is switched off, so no
test waits on its build.

Compared, with these tolerances:
* each mode's stdout JSON lines (the reference also prints a table there,
  which is skipped): three in both, with the same key sets and the
  `batch` of `metric` (b1, b8, b64), mode and index equal; every latency
  positive;
* both DBService classes are wrapped to record the last b8 reply of
  `rpc_search_batch`; in exact mode its keys are equal query by query,
  outside exact f32 ties (a key may trade places with one of equal score,
  to within 1e-6 relative), and the scores within 1e-5 relative.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

import tpuvdb.api.service as jax_service
import tpuvdb.native as jax_native
from tpuvdb_torch.api import service as port_service
from tpuvdb_torch.bench import latency

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--rows", "4096", "--dim", "32", "--reps", "5"]
MODES = [("exact", "flat"), ("approx", "ivf"), ("int8", "flat")]
LINE_KEYS = {"metric", "unit", "value", "per_query_p50_ms", "p99_ms", "mode",
             "index", "dispatch_floor_ms", "p50_minus_dispatch_ms",
             "per_query_p50_minus_dispatch_ms", "rows"}


def _recording(cls):
    """A subclass of the service `cls` whose rpc_search_batch records its
    last reply to a batch of 8 queries in `last_b8`."""

    class Recording(cls):
        last_b8 = None

        def rpc_search_batch(self, p):
            reply = super().rpc_search_batch(p)
            if len(p["query_vectors"]) == 8:
                type(self).last_b8 = reply
            return reply

    return Recording


def _json_lines(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        fn(*args, **kw)
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def runs():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_latency", os.path.join(ROOT, "bench_latency.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jax_cls = _recording(jax_service.DBService)
    port_cls = _recording(port_service.DBService)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_native, "rescore_available", lambda: False)
        mp.setattr(jax_service, "DBService", jax_cls)
        mp.setattr(port_service, "DBService", port_cls)
        for mode, index in MODES:
            argv = [*ARGS, "--mode", mode, "--index", index]
            mp.setattr(sys, "argv", ["bench_latency.py", *argv])
            want = _json_lines(ref.main)
            got = _json_lines(latency.main, argv, device="cpu")
            out[mode] = (want, jax_cls.last_b8, got, port_cls.last_b8)
    return out


@pytest.mark.parametrize("mode", [m for m, _ in MODES])
def test_lines_have_the_reference_keys(runs, mode):
    want, _, got, _ = runs[mode]
    assert len(want) == len(got) == 3
    for w, g, b in zip(want, got, (1, 8, 64)):
        assert set(w) == LINE_KEYS
        assert set(g) == set(w)
        assert g["metric"] == w["metric"] == f"search_latency_b{b}"
        assert (g["mode"], g["index"], g["rows"]) == \
            (w["mode"], w["index"], w["rows"])
        assert g["value"] > 0 and g["p99_ms"] >= g["value"]
        assert g["dispatch_floor_ms"] > 0


def _tied(scores, i, rtol=1e-6):
    s = scores[i]
    return any(abs(scores[j] - s) <= rtol * max(1.0, abs(s))
               for j in (i - 1, i + 1) if 0 <= j < len(scores))


def test_exact_b8_keys_equal(runs):
    _, want, _, got = runs["exact"]
    assert want["success"] and got["success"]
    assert len(want["results"]) == len(got["results"]) == 8
    for w, g in zip(want["results"], got["results"]):
        assert len(g["keys"]) == len(w["keys"]) == 10
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-5)
        for i, (wk, gk) in enumerate(zip(w["keys"], g["keys"])):
            assert wk == gk or _tied(w["scores"], i), (i, w, g)
