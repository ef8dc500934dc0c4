"""The port's diagnostics (tpuvdb_torch/bench/diag_{pq_recall,ivf_b1}.py)
against the reference's scripts/diag_{pq_recall,ivf_b1}.py, run unedited
(loaded from their paths, `main()` called with sys.argv patched), and
both packages' PQ training on a sample of the capacity_pq corpus, all on
the CPU. The JAX package's native library is switched off.

* diag_pq_recall, on the data dir each package's capacity_pq left at
  65,536 x 32 (8 code bytes, nlist 64; the first ingest block is the
  whole corpus, so both diagnostics draw the bench's own queries; rows cut
  from 8M x 768 for the time budget), swept at nprobe 4 and 16 x
  overfetch 10 and 100 (of the reference's 16, 64 x 10, 40, 100: nprobe
  64 costs the reference seconds a search through XLA on the CPU): the
  same grid keys, each recall within 0.05 of the reference's (the two
  k-means trainers differ in the last bits); and the port's recall at the
  setting its capacity_pq served equals what capacity_pq printed there.
  The capacity_pq runs are cut as in test_torch_bench_capacity.py (the
  reference answers a repeated search from a memo, the port's loops run
  once), with --skip-restart; each diagnostic's search at a setting is a
  warm-up and a timed repeat, and the reference's repeat comes from the
  memo too.
* diag_ivf_b1 on one corpus that the port's capacity_ivf cached at
  16,384 x 32 (nlist 64): each package builds its own index from it (int8
  cells, seed 0); the port's recall@10 is within 0.02 of the reference's
  exact-coarse ("base") variant, which runs its int8 Pallas probe in
  interpret mode (its other variants are made to fail, which it records
  as errors, and its timing loop is stubbed: interpret mode through the
  timing loops would not fit the time budget). The port's line has the
  reference's keys, its other variants "n/a" with the reason.
* PQ training on 16,384 rows of the capacity_pq corpus at 768-d, 96
  sub-quantizers, 8-bit (262,144 rows take ~7 min on the CPU: each
  package's train_pq runs ~105 s at 65,536), on the residuals against the
  rows' own generating centres (3.0 x unit normals apart, 0.4 noise: the
  cells the bench's 4,096-cell k-means recovers): each package's
  codebooks' mean distortion (the squared reconstruction error a row,
  encoded by the port) and `pq_err` (calibrate_pq_err) within 5% of each
  other, the bound the PQ training parity allows (test_torch_pq.py).
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import weakref

import numpy as np
import pytest

import tpuvdb.kernels.pallas_ivf as jax_pallas_ivf
import tpuvdb.kernels.pq as jax_pq
import tpuvdb.native as jax_native
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch.bench import (capacity_ivf, capacity_pq, diag_ivf_b1,
                                diag_pq_recall, harness)
from tpuvdb_torch.kernels import pq as port_pq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PQ_SHAPE = ["--rows", "65536", "--dim", "32", "--subq", "8", "--nlist", "64"]
GRID = ["--nprobes", "4,16", "--overfetches", "10,100"]
GRID_KEYS = ["np4_ov10", "np4_ov100", "np16_ov10", "np16_ov100"]
IVF_SHAPE = ["--rows", "16384", "--dim", "32", "--nlist", "64"]
SAMPLE_ROWS = 16_384


def _load(relpath: str):
    name = "ref_" + os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args, **kw) -> tuple:
    """(the last JSON line of fn's stdout, its stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn(*args, **kw)
    lines = [x for x in out.getvalue().splitlines() if x.startswith("{")]
    return json.loads(lines[-1]), err.getvalue()


def _reference(mp, relpath: str, argv: list, patch=None) -> tuple:
    mod = _load(relpath)
    if patch is not None:
        patch(mod)
    mp.setattr(sys, "argv", [os.path.basename(relpath), *argv])
    return _run(mod.main)


def _memo_searches(mp):
    """The JAX engine answers a repeat of a search it already answered
    (same queries, k, overfetch, nprobe and rescore_overfetch) from a
    memo: the reference's loops search one batch many times, at seconds a
    search through XLA on the CPU."""
    memo = weakref.WeakKeyDictionary()
    search = JaxEngine.search_batch

    def search_batch(self, queries, k, overfetch=False):
        key = (np.asarray(queries, np.float32).tobytes(), k, overfetch,
               self._ivf.nprobe if self._ivf is not None else None,
               self.config.rescore_overfetch)
        answers = memo.setdefault(self, {})
        if key not in answers:
            answers[key] = search(self, queries, k, overfetch)
        return answers[key]

    mp.setattr(JaxEngine, "search_batch", search_batch)


def _native_off(mp):
    mp.setattr(jax_native, "available", lambda: False)
    mp.setattr(jax_native, "rescore_available", lambda: False)


def _quick_port_loops(mp):
    timer = harness.chained_timer
    mp.setattr(harness, "chained_timer",
               lambda fn, args, iters=20, reps=3: timer(fn, args, 1, 1))
    mp.setattr(capacity_pq, "ITERS", 1)
    mp.setattr(capacity_pq, "PIPELINED", 2)


# ------------------------------------------------------------ diag_pq_recall


@pytest.fixture(scope="module")
def pq_grids(tmp_path_factory):
    want_dir = str(tmp_path_factory.mktemp("ref_pq"))
    got_dir = str(tmp_path_factory.mktemp("port_pq"))
    with pytest.MonkeyPatch.context() as mp:
        _native_off(mp)
        _memo_searches(mp)
        _quick_port_loops(mp)
        _reference(mp, "scripts/bench_capacity_pq.py",
                   [*PQ_SHAPE, "--data-dir", want_dir, "--skip-restart"])
        want, _ = _reference(mp, "scripts/diag_pq_recall.py",
                             [*PQ_SHAPE, *GRID, "--data-dir", want_dir])
        served, _ = _run(capacity_pq.main, [*PQ_SHAPE, "--data-dir", got_dir,
                                            "--skip-restart"], device="cpu")
        got, got_err = _run(diag_pq_recall.main,
                            [*PQ_SHAPE, *GRID, "--data-dir", got_dir],
                            device="cpu")
    return {"want": want, "got": got, "served": served, "got_err": got_err}


def test_pq_grid_has_the_reference_keys(pq_grids):
    want, got = pq_grids["want"], pq_grids["got"]
    assert got["metric"] == want["metric"] == "pq8m_recall_vs_nprobe"
    assert list(got["results"]) == list(want["results"]) == GRID_KEYS
    for key, cell in got["results"].items():
        assert set(cell) == set(want["results"][key]) | {"window"}
        assert cell["window"] == 10 * max(int(key.split("_ov")[1]), 64)
    assert "packed restores 1" in pq_grids["got_err"]


@pytest.mark.parametrize("key", GRID_KEYS)
def test_pq_grid_recall_is_the_references(pq_grids, key):
    want = pq_grids["want"]["results"][key]["recall_at_10"]
    got = pq_grids["got"]["results"][key]["recall_at_10"]
    assert abs(got - want) <= 0.05, (got, want)


def test_pq_grid_at_the_served_setting_is_capacity_pqs(pq_grids):
    served = pq_grids["served"]
    cell = pq_grids["got"]["results"][f"np{served['nprobe']}_ov10"]
    assert cell["recall_at_10"] == served["recall_at_10"]


def test_pq_queries_are_the_bench_queries():
    # the reference diagnostic's draw, at the full 65,536-row block
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((4096, 32)).astype(np.float32) * 3.0
    cid = rng.integers(0, 4096, 65536)
    noise = rng.standard_normal((65536, 32), dtype=np.float32)
    want = (noise * 0.4 + cents[cid])[:32]
    np.testing.assert_array_equal(diag_pq_recall.bench_queries(65536, 32),
                                  want)


# --------------------------------------------------------------- diag_ivf_b1


class _Skipped(Exception):
    pass


def _interpret_base_only(mp):
    probe = jax_pallas_ivf.pallas_ivf_search

    def base_only(*a, **kw):
        if kw.get("cps_override") or kw.get("coarse_approx"):
            raise _Skipped
        return probe(*a, interpret=True, **kw)

    mp.setattr(jax_pallas_ivf, "pallas_ivf_search", base_only)


def _stub_timing(mod):
    mod.chained = lambda fn, *arrays, iters=10, reps=3: 1e-3


@pytest.fixture(scope="module")
def ivf_lines(tmp_path_factory):
    got_cache = tmp_path_factory.mktemp("port_cache")
    want_cache = tmp_path_factory.mktemp("ref_cache")
    name = "capivf_16384_32_0.12_10.npz"
    with pytest.MonkeyPatch.context() as mp:
        _quick_port_loops(mp)
        mp.setenv("TPUVDB_BENCH_CACHE", str(got_cache))
        cap, _ = _run(capacity_ivf.main, IVF_SHAPE, device="cpu")
        got, _ = _run(diag_ivf_b1.main, IVF_SHAPE, device="cpu")
        os.symlink(got_cache / name, want_cache / name)
        mp.setenv("TPUVDB_BENCH_CACHE", str(want_cache))
        _interpret_base_only(mp)
        want, want_err = _reference(mp, "scripts/diag_ivf_b1.py", IVF_SHAPE,
                                    patch=_stub_timing)
    return {"got": got, "want": want, "want_err": want_err, "capacity": cap}


def test_ivf_b1_line_has_the_reference_keys(ivf_lines):
    got, want = ivf_lines["got"], ivf_lines["want"]
    assert set(got) == set(want)
    for key in ("rows", "dim", "nprobe"):
        assert got[key] == want[key], key
    assert got["nlist"] == ivf_lines["capacity"]["nlist"]
    for variant in ("cps16", "cps32", "approx", "approx_cps32"):
        assert want[variant] == {"error": "_Skipped"}
        assert got[variant].startswith("n/a: ")
    for b in (1, 128):
        assert got[f"coarse_exact_b{b}_us"] > 0
        assert got[f"coarse_approx_b{b}_us"].startswith("n/a: ")


def test_ivf_b1_recall_is_the_references(ivf_lines):
    got = ivf_lines["got"]["base"]["recall_at_10"]
    want = ivf_lines["want"]["base"]["recall_at_10"]
    assert abs(got - want) <= 0.02, (got, want)


def test_ivf_b1_split(ivf_lines):
    base = ivf_lines["got"]["base"]
    assert base["form"] == "expanded"
    assert all(base[f"b{b}_ms"] > 0 for b in (1, 8, 128))
    split = base["split_b1_us"]
    assert set(split) == {"coarse", "plan", "kernel", "final_topk", "probe",
                          "rest"}
    assert all(split[s] > 0 for s in ("coarse", "plan", "kernel",
                                      "final_topk", "probe"))


def test_ivf_b1_needs_the_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPUVDB_BENCH_CACHE", str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        diag_ivf_b1.main(IVF_SHAPE, device="cpu")
    assert exc.value.code == 1
    assert re.search(r"missing cached corpus .*capivf_16384_32_0\.12_10\.npz",
                     capsys.readouterr().err)


# ------------------------------------------------------- PQ training parity


def test_pq_training_on_the_capacity_corpus_agrees():
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((4096, 768)).astype(np.float32) * 3.0
    cid = rng.integers(0, 4096, SAMPLE_ROWS)
    noise = rng.standard_normal((SAMPLE_ROWS, 768), dtype=np.float32)
    residuals = (noise * 0.4 + cents[cid]) - cents[cid]
    got = port_pq.train_pq(residuals, 96, seed=0, device="cpu")
    want = np.asarray(jax_pq.train_pq(residuals, 96, seed=0))
    assert got.shape == want.shape == (96, 256, 8)

    def distortion(cb):
        codes, _ = port_pq.encode_pq(residuals, cb, device="cpu")
        return float(np.mean(np.sum(
            (residuals - port_pq.decode_pq(codes, cb)) ** 2, axis=1)))

    d_got, d_want = distortion(got), distortion(want)
    assert abs(d_got - d_want) <= 0.05 * d_want, (d_got, d_want)
    e_got = port_pq.calibrate_pq_err(residuals, got)
    e_want = jax_pq.calibrate_pq_err(residuals, want)
    assert abs(e_got - e_want) <= 0.05 * e_want, (e_got, e_want)
