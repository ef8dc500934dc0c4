"""The port's serving A/B (tpuvdb_torch/bench/serving_ab.py) against the
reference's scripts/bench_serving_ab.py, run unedited (loaded from its
path, its `main()` called with sys.argv patched), on the CPU at 8,192 x 32
rows, batches 8 and 16, 2 threads (cut from 1,000,000 x 128, b32 / b512
and 8 threads for the time budget): the same `ab` tags in the same order,
the same `groups` shape (None when direct, a dict of group sizes when
coalesced), positive rates, and the same per-run sizes, and within each
batch the coalesced engine's first answer equals the direct engine's
(keys equal outside exact f32 ties, distances within 1e-5 relative).
Timings are not compared.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

import tpuvdb.native as jax_native
from tpuvdb_torch.bench import serving_ab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--rows", "8192", "--dim", "32", "--batches", "8,16",
        "--threads", "2"]
TAGS = ["b8_direct", "b8_coalesce", "b16_direct", "b16_coalesce"]


@pytest.fixture(scope="module")
def runs():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_serving_ab",
        os.path.join(ROOT, "scripts", "bench_serving_ab.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_native, "rescore_available", lambda: False)
        mp.setattr(sys, "argv", ["bench_serving_ab.py", *ARGV])
        want, got = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(want), \
                contextlib.redirect_stderr(io.StringIO()):
            ref.main()
        with contextlib.redirect_stdout(got), \
                contextlib.redirect_stderr(io.StringIO()):
            line, answers = serving_ab.main(ARGV, device="cpu")
    return {"want": json.loads(want.getvalue().splitlines()[-1]),
            "got": json.loads(got.getvalue().splitlines()[-1]),
            "line": line, "answers": answers}


def test_line_has_the_reference_keys(runs):
    want, got = runs["want"], runs["got"]
    assert set(got) == set(want)
    assert got == json.loads(json.dumps(runs["line"]))
    for key in ("metric", "rows", "dim", "threads"):
        assert got[key] == want[key], key
    assert list(got["ab"]) == list(want["ab"]) == TAGS
    for tag in TAGS:
        assert set(got["ab"][tag]) == set(want["ab"][tag]), tag
        assert got["ab"][tag]["qps_single"] > 0
        assert got["ab"][tag]["qps_pipelined"] > 0


@pytest.mark.parametrize("tag", TAGS)
def test_groups_have_the_references_shape(runs, tag):
    want = runs["want"]["ab"][tag]["groups"]
    got = runs["got"]["ab"][tag]["groups"]
    if tag.endswith("direct"):
        assert got is None and want is None
    else:
        assert isinstance(got, dict) and isinstance(want, dict)
        assert got and all(int(size) >= 1 and n > 0
                           for size, n in got.items())


@pytest.mark.parametrize("batch", [8, 16])
def test_coalesced_answer_equals_direct(runs, batch):
    d_dir, k_dir = runs["answers"][f"b{batch}_direct"]
    d_co, k_co = runs["answers"][f"b{batch}_coalesce"]
    d_dir, d_co = np.asarray(d_dir), np.asarray(d_co)
    assert d_dir.shape == d_co.shape == (batch, 10)
    np.testing.assert_allclose(d_co, d_dir, rtol=1e-5)
    for i in range(batch):
        for j in range(10):
            if k_co[i][j] != k_dir[i][j]:
                # an exact tie: the two rows' distances are equal
                assert d_co[i, j] == d_dir[i, j], (i, j)
