"""The port's capacity benchmarks (tpuvdb_torch/bench/capacity*.py) against
the reference's scripts (scripts/bench_capacity*.py), run unedited: each
is loaded from its path and its `main()` called with sys.argv patched,
once per module (module fixtures), beside the port's `main(argv,
device="cpu")`. The JAX package's native library is switched off, so no
test waits on its build.

Shapes and tolerances:
* capacity_engine, `--rows 65536 --dim 32 --batch 32`: the last lines'
  key sets equal; both recall_at_10 >= 0.9 and within 0.05 of each other;
  both restarts count every row (each script raises otherwise); the
  port's --data-dir reopened by the port's engine counts 65,536 rows.
* capacity_pq, `--rows 32768 --dim 32 --subq 8 --nlist 64 --batch 32
  --out F` (rows halved from 65,536 for the time budget; the reference's
  IVF-PQ build and searches run through XLA on the CPU): the key sets equal, the served recalls within 0.05, the
  `rss_stages` tags (both MEM_STAGES cleared before each run) the same in
  the same order, the --out files' stage "complete", and the port's
  `build split:` line names the IVF build's five tags. The reference's
  kernel timing fails on the CPU and says so (its pallas_pq_search has no
  interpret switch). Its serving loop searches one batch 85 times a batch
  size, at seconds a search through XLA on the CPU: here a repeat of a
  search the same engine already answered (same queries, k and nprobe)
  returns that answer again; nothing compared here is a timing. The
  port's loops are cut to one search each (one window of one call in
  chained_timer, 1 single-thread and 2 pipelined searches).
* capacity_ivf, `--rows 16384 --dim 32 --nlist 64`: the corpus handed to
  `IVFIndex.build` equal bit for bit in both (recorded by a patch that
  calls through); each nprobe's sweep recall within 0.05 (the CPU routes
  differ by design, so rows are not compared). The reference stops at a
  sentinel raised by its `pallas_ivf_search` once the sweep is done
  (interpret mode through the timing loops would not fit the budget);
  the port runs its timing with chained_timer cut to one call.
* The IVF build's bisection of oversized cells, at shapes where it splits
  cells, both packages' IVFIndex.build on one set of k-means centroids
  (the port's k-means; each package's own differ in the last bits of f32
  sums, PQ training likewise, so the tests share them): int8 cells over
  capacity_ivf's corpus at 32,768 x 128 (spread 0.12, nlist 256, grown by
  bisection to 436): the cell count, cell_pad, centroids, cell offsets,
  row ids, int8 codes, scales and norms equal bit for bit, and the port's
  search returns, for each of 16 queries at nprobe 8 and 32, the rows the
  reference's int8 Pallas probe returns in interpret mode (as sets; what
  its search runs on a TPU). IVF-PQ (8 code bytes) over capacity_pq's
  corpus at 16,384 x 64 (nlist 256, grown to 316) on one set of
  codebooks: the cells and the codes, re-encoded in bisected cells, equal
  bit for bit, the residual norms within rtol 1e-5 (f32 sums taken in
  another order). Rows and dim are cut from 8M x 768 for the time budget.
* capacity, which hard codes 8,000,000 x 768: the first 500,000 x 768
  chunk the reference hands `quantize_rows_np` (recorded, then a sentinel
  stops it; about 1.5 GB, with 3 GB of f64 draws while it is drawn, and
  8-15 s of draws in each package) equals the port's first chunk bit for
  bit, and the port's `quantize_rows_np` gives the reference's codes and
  scales bit for bit on its first 65,536 rows (quantization is row by row;
  the whole chunk would add 6-12 s to the time budget). The port's `run(rows=65_536, dim=32, device="cpu")` reaches
  recall >= 0.95 on both rescored paths.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuvdb.index.ivf as jax_ivf
import tpuvdb.kernels.pallas_ivf as jax_pallas_ivf
import tpuvdb.kernels.quant as jax_quant
import tpuvdb.native as jax_native
import tpuvdb.utils.hostmem as jax_hostmem
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch import VectorDBEngine
from tpuvdb_torch.bench import (capacity, capacity_engine, capacity_ivf,
                                capacity_pq, harness)
from tpuvdb_torch.index import ivf as port_ivf
from tpuvdb_torch.kernels import kmeans as port_kmeans
from tpuvdb_torch.kernels import pq as port_pq
from tpuvdb_torch.kernels import quant
from tpuvdb_torch.utils import hostmem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_TAGS = ["build: start", "build: trained (cents+codebooks)",
              "build: assigned+encoded", "build: split done",
              "build: packed"]


def load_script(relpath: str):
    """The reference script at `relpath`, imported from its file."""
    name = "ref_" + os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *args, **kw):
    """(stdout, stderr) of fn(*args, **kw)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn(*args, **kw)
    return out.getvalue(), err.getvalue()


def json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def reference_main(mp, relpath: str, argv: list):
    """The reference script's main() under argv: (stdout, stderr)."""
    mod = load_script(relpath)
    mp.setattr(sys, "argv", [os.path.basename(relpath), *argv])
    return captured(mod.main)


def jax_native_off(mp):
    mp.setattr(jax_native, "available", lambda: False)
    mp.setattr(jax_native, "rescore_available", lambda: False)


def quick_port_timers(mp):
    """One window of one call in chained_timer."""
    timer = harness.chained_timer
    mp.setattr(harness, "chained_timer",
               lambda fn, args, iters=20, reps=3: timer(fn, args, 1, 1))


def answer_repeats_from_memo(mp, cls):
    """cls.search_batch answers a repeat of a search the same engine
    already answered (same queries, k, overfetch and IVF nprobe) with the
    first answer."""
    memo = weakref.WeakKeyDictionary()
    search = cls.search_batch

    def search_batch(self, queries, k, overfetch=False):
        nprobe = self._ivf.nprobe if self._ivf is not None else None
        key = (np.asarray(queries, np.float32).tobytes(), k, overfetch,
               nprobe)
        answers = memo.setdefault(self, {})
        if key not in answers:
            answers[key] = search(self, queries, k, overfetch)
        return answers[key]

    mp.setattr(cls, "search_batch", search_batch)


# ------------------------------------------------------------ capacity_engine

ENGINE_ARGV = ["--rows", "65536", "--dim", "32", "--batch", "32"]


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("capacity_engine"))
    with pytest.MonkeyPatch.context() as mp:
        jax_native_off(mp)
        want, _ = reference_main(mp, "scripts/bench_capacity_engine.py",
                                 ENGINE_ARGV)
        got, _ = captured(capacity_engine.main,
                          [*ENGINE_ARGV, "--data-dir", data_dir],
                          device="cpu")
    return json_lines(want)[-1], json_lines(got)[-1], data_dir


def test_engine_line_has_the_reference_keys(engine_runs):
    want, got, _ = engine_runs
    assert set(got) == set(want)
    assert got["metric"] == want["metric"]
    assert got["rows"] == want["rows"] == 65536
    assert got["dim"] == want["dim"] == 32


def test_engine_recall_and_restart(engine_runs):
    want, got, _ = engine_runs
    assert want["recall_at_10"] >= 0.9 and got["recall_at_10"] >= 0.9
    assert abs(want["recall_at_10"] - got["recall_at_10"]) <= 0.05
    # each script raises unless its restart counts every row
    assert want["restart_s"] is not None and got["restart_s"] is not None
    assert got["engine_qps_single"] > 0 and got["engine_qps_pipelined"] > 0


def test_engine_data_dir_reopens_with_every_row(engine_runs):
    _, _, data_dir = engine_runs
    eng = VectorDBEngine(capacity_engine.config(65536, 32),
                         data_dir=data_dir, device="cpu")
    try:
        assert eng.count() == 65536
        assert eng.get("k65535").success
    finally:
        eng.close()


# ---------------------------------------------------------------- capacity_pq

PQ_ARGV = ["--rows", "32768", "--dim", "32", "--subq", "8", "--nlist", "64",
           "--batch", "32"]


@pytest.fixture(scope="module")
def pq_runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("capacity_pq")
    want_file, got_file = out_dir / "reference.json", out_dir / "port.json"
    with pytest.MonkeyPatch.context() as mp:
        jax_native_off(mp)
        answer_repeats_from_memo(mp, JaxEngine)
        jax_hostmem.MEM_STAGES.clear()
        want, want_err = reference_main(
            mp, "scripts/bench_capacity_pq.py",
            [*PQ_ARGV, "--out", str(want_file)])
        quick_port_timers(mp)
        mp.setattr(capacity_pq, "ITERS", 1)
        mp.setattr(capacity_pq, "PIPELINED", 2)
        hostmem.MEM_STAGES.clear()
        got, got_err = captured(capacity_pq.main,
                                [*PQ_ARGV, "--out", str(got_file)],
                                device="cpu")
    return {"want": json_lines(want)[-1], "got": json_lines(got)[-1],
            "want_err": want_err, "got_err": got_err,
            "want_file": json.loads(want_file.read_text()),
            "got_file": json.loads(got_file.read_text())}


def test_pq_line_has_the_reference_keys(pq_runs):
    want, got = pq_runs["want"], pq_runs["got"]
    assert set(got) == set(want)
    assert got["metric"] == want["metric"] == "engine_capacity_pq_0m32"
    assert got["stage"] == want["stage"] == "complete"
    assert set(got["restart_split"]) == set(want["restart_split"])
    assert got["restart_split"]["packed_restores"] == 1
    assert set(got["serving_by_batch"]) == {"32", "256"}
    assert min(min(v) for v in got["serving_by_batch"].values()) > 0


def test_pq_served_recall(pq_runs):
    want, got = pq_runs["want"], pq_runs["got"]
    assert abs(got["recall_at_10"] - want["recall_at_10"]) <= 0.05
    for nprobe in set(got["recall_sweep"]) & set(want["recall_sweep"]):
        assert abs(got["recall_sweep"][nprobe]
                   - want["recall_sweep"][nprobe]) <= 0.05


def test_pq_kernel_timing(pq_runs):
    assert "kernel-path timing failed" in pq_runs["want_err"]
    assert pq_runs["want"]["kernel_probe"] == {}
    got = pq_runs["got"]["kernel_probe"]
    assert set(got) == {"b32", "b256"}
    assert all(v["ms_per_batch"] > 0 for v in got.values())


def test_pq_rss_stage_tags(pq_runs):
    want = [tag for tag, _ in pq_runs["want"]["rss_stages"]]
    got = [tag for tag, _ in pq_runs["got"]["rss_stages"]]
    assert got == want
    assert want[:2] == ["bench: ingest done", "build: start"]


def test_pq_out_files_are_complete(pq_runs):
    for side in ("want", "got"):
        assert pq_runs[side + "_file"] == pq_runs[side]
        assert pq_runs[side + "_file"]["stage"] == "complete"


def test_pq_build_split_names_the_build_tags(pq_runs):
    lines = [line for line in pq_runs["got_err"].splitlines()
             if line.startswith("build split: ")]
    assert len(lines) == 1
    split = json.loads(lines[0][len("build split: "):])
    assert [t for t in split if t.startswith("build: ")] == BUILD_TAGS
    assert all(s >= 0 for s in split.values())


# --------------------------------------------------------------- capacity_ivf

IVF_ARGV = ["--rows", "16384", "--dim", "32", "--nlist", "64"]
_SWEEP_LINE = re.compile(r"^nprobe (\d+): recall@10 ([0-9.]+)$", re.M)


class _SweepDone(Exception):
    pass


def _record_builds(mp, cls, into: list):
    build = cls.build  # bound to cls

    def record(_cls, vectors, *a, **kw):
        into.append(np.array(vectors))
        return build(vectors, *a, **kw)

    mp.setattr(cls, "build", classmethod(record))


@pytest.fixture(scope="module")
def ivf_runs():
    want_corpus, got_corpus = [], []

    def stop(*a, **kw):
        raise _SweepDone

    with pytest.MonkeyPatch.context() as mp:
        _record_builds(mp, jax_ivf.IVFIndex, want_corpus)
        mp.setattr(jax_pallas_ivf, "pallas_ivf_search", stop)
        ref = load_script("scripts/bench_capacity_ivf.py")
        mp.setattr(sys, "argv", ["bench_capacity_ivf.py", *IVF_ARGV])
        want_err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(want_err), \
                pytest.raises(_SweepDone):
            ref.main()
        _record_builds(mp, port_ivf.IVFIndex, got_corpus)
        quick_port_timers(mp)
        got, got_err = captured(capacity_ivf.main, IVF_ARGV, device="cpu")
    return {"want_corpus": want_corpus, "got_corpus": got_corpus,
            "want_sweep": dict(_SWEEP_LINE.findall(want_err.getvalue())),
            "got_sweep": dict(_SWEEP_LINE.findall(got_err)),
            "got": json_lines(got)[-1]}


def test_ivf_corpus_is_the_references(ivf_runs):
    (want,), (got,) = ivf_runs["want_corpus"], ivf_runs["got_corpus"]
    assert want.shape == got.shape == (16384, 32)
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_ivf_sweep_recall(ivf_runs):
    want, got = ivf_runs["want_sweep"], ivf_runs["got_sweep"]
    assert list(got) == list(want) == [str(n) for n in capacity_ivf.NPROBES]
    for nprobe in want:
        assert abs(float(got[nprobe]) - float(want[nprobe])) <= 0.05


def test_ivf_line_has_the_reference_keys(ivf_runs):
    line = ivf_runs["got"]
    assert set(line) == {"nprobe", "recall_at_10", "nlist", "cell_pad",
                         "rows", "dim", "hbm_gib", "b1", "b8", "b128"}
    assert line["recall_at_10"] >= capacity_ivf.RECALL_TARGET
    assert line["recall_at_10"] == float(ivf_runs["got_sweep"][
        str(line["nprobe"])])
    for b in ("b1", "b8", "b128"):
        assert set(line[b]) == {"ms_per_batch", "us_per_query", "qps"}
        assert line[b]["ms_per_batch"] > 0


# ------------------------------------- the IVF build's bisection, both packages

BISECT_INT8 = (32_768, 128, 256)   # rows, dim, nlist: 256 cells -> 436
BISECT_PQ = (16_384, 64, 256, 8)   # rows, dim, nlist, code bytes: -> 316
BISECT_QUERIES = 16                # the reference's probe in interpret mode
BISECT_NPROBES = (8, 32)


def _as_np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same_cells(got, want, nlist: int, exact: tuple) -> None:
    assert got.nlist == want.nlist > nlist  # the build bisected cells
    assert got.cell_pad == want.cell_pad
    for name in exact:
        np.testing.assert_array_equal(_as_np(getattr(got, name)),
                                      _as_np(getattr(want, name)),
                                      err_msg=name)


def _reference_probe_rows(index, queries, nprobe: int) -> np.ndarray:
    """The reference's int8 Pallas probe (what its search runs on a TPU),
    in interpret mode, mapped to physical rows as its search maps them."""
    _, gid = jax_pallas_ivf.pallas_ivf_search(
        jnp.asarray(queries), index.centroids, index.grouped,
        index.grouped_sq, index.grouped_valid, cell_pad=index.cell_pad,
        k=10, nprobe=nprobe, query_tile=8, spill=index.spill,
        spill_sq=index.spill_sq, spill_valid=index.spill_valid,
        cell_scales=index.cell_scales, spill_scales=index.spill_scales,
        cell_offsets=index.cell_offsets, interpret=True)
    gid = np.asarray(gid)
    rows = np.full(gid.shape, -1, np.int64)
    n_grouped = index.grouped.shape[0]
    cell, spill = (gid >= 0) & (gid < n_grouped), gid >= n_grouped
    rows[cell] = np.asarray(index.row_ids)[gid[cell]]
    rows[spill] = np.asarray(index.spill_row_ids)[gid[spill] - n_grouped]
    return rows


def test_ivf_bisected_build_and_probe_are_the_references():
    n, dim, nlist = BISECT_INT8
    queries, chunks = capacity.clustered_unit_draws(n, dim, 0.12)
    vectors = np.concatenate([x for _, x in chunks])
    valid = np.ones(n, bool)
    centroids, _ = port_kmeans.kmeans(vectors, valid, nlist=nlist, seed=0,
                                      device="cpu")
    want = jax_ivf.IVFIndex.build(vectors, valid, nlist=nlist, nprobe=32,
                                  dtype=jnp.int8, seed=0,
                                  centroids=centroids)
    got = port_ivf.IVFIndex.build(vectors, valid, nlist=nlist, nprobe=32,
                                  dtype=torch.int8, seed=0,
                                  centroids=centroids, device="cpu")
    _assert_same_cells(got, want, nlist, (
        "centroids", "cell_offsets", "row_ids", "spill_row_ids", "grouped",
        "cell_scales", "grouped_sq"))
    q = queries[:BISECT_QUERIES]
    for nprobe in BISECT_NPROBES:
        _, rows = got.search(q, 10, nprobe=nprobe)
        want_rows = _reference_probe_rows(want, q, nprobe)
        for i, (a, b) in enumerate(zip(rows, want_rows)):
            assert set(a[a >= 0]) == set(b[b >= 0]), (nprobe, i)


def test_pq_bisected_build_is_the_references():
    n, dim, nlist, subq = BISECT_PQ
    # capacity_pq's corpus: 4,096 centres x 3.0, 0.4 noise around them
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((4096, dim)).astype(np.float32) * 3.0
    vectors = cents[rng.integers(0, 4096, n)] + 0.4 * rng.standard_normal(
        (n, dim), dtype=np.float32)
    valid = np.ones(n, bool)
    centroids, assign = port_kmeans.kmeans(vectors, valid, nlist=nlist,
                                           iters=8, seed=0, device="cpu")
    codebooks = port_pq.train_pq(vectors - centroids[assign], m_subq=subq,
                                 seed=0, device="cpu")
    kw = dict(nlist=nlist, nprobe=16, seed=0, centroids=centroids,
              pq_subq=subq, pq_codebooks=codebooks)
    want = jax_ivf.IVFIndex.build(vectors, valid, **kw)
    got = port_ivf.IVFIndex.build(vectors, valid, device="cpu", **kw)
    # the codes of the rows in bisected cells are encoded again against
    # their final centroids: equal bit for bit
    _assert_same_cells(got, want, nlist, (
        "centroids", "cell_offsets", "row_ids", "spill_row_ids", "grouped"))
    np.testing.assert_allclose(_as_np(got.grouped_sq),
                               _as_np(want.grouped_sq), rtol=1e-5)


# ------------------------------------------------------------------- capacity


QUANT_ROWS = 65_536


class _Drawn(Exception):
    pass


def test_capacity_first_chunk_is_the_references(monkeypatch):
    drawn = []
    reference_quantize = jax_quant.quantize_rows_np

    def record(x):
        drawn.append(x)
        raise _Drawn

    monkeypatch.setattr(jax_quant, "quantize_rows_np", record)
    with pytest.raises(_Drawn):
        reference_main(monkeypatch, "scripts/bench_capacity.py", [])
    want = drawn.pop()
    assert want.shape == (capacity.CHUNK, capacity.DIM)
    _, chunks = capacity.clustered_unit_draws(capacity.N, capacity.DIM,
                                              capacity.SPREAD)
    lo, got = next(chunks)
    assert lo == 0 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    del got
    # quantization is row by row: its check takes the first QUANT_ROWS
    rows = want[:QUANT_ROWS]
    codes, scales = quant.quantize_rows_np(rows)
    want_codes, want_scales = reference_quantize(rows)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(scales, want_scales)


def test_capacity_run_small(monkeypatch):
    quick_port_timers(monkeypatch)
    out = capacity.run(rows=65_536, dim=32, device="cpu",
                       log=lambda *a: None)
    assert set(out) == {"int8_b128", "int8_b256", "int8_resc_b128",
                        "int8_resc_b256"}
    for path in out.values():
        assert set(path) == {"qps", "recall", "ms", "GiBps"}
        assert path["qps"] > 0
    assert out["int8_resc_b128"]["recall"] >= 0.95
    assert out["int8_resc_b256"]["recall"] >= 0.95
