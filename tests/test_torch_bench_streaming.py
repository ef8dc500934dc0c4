"""The port's streaming benchmark (tpuvdb_torch/bench/streaming.py) at a
small size, and its data_dir opened by both packages.

`run(n_total=2048, dim=32, batch=256, device="cpu", data_dir=tmp)` puts
2,048 seeded rows and 512 warm-up rows with the WAL on (the native writer
and doc store, mmap mirrors), searches meanwhile, closes the WAL and
reopens. Then the JAX package's VectorDBEngine (its python doc store and
mmap mirrors, its native library off so no test waits on its build) and
the port's reopen the same directory: each counts 2,560 keys, and ten
sampled keys return the vectors the benchmark put, exactly (the rows are
f32 both ways). The record has the reference's keys
(tpuvdb/bench/streaming.py:91-100), a positive rate and recovery time.
"""

import numpy as np
import pytest

import tpuvdb.native as jax_native
from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.bench import streaming

N_TOTAL, DIM, BATCH = 2_048, 32, 256
REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "ingest_total",
                  "dim", "concurrent_search_p50_ms", "recovery_s"}


def _cfg(cls, **kw):
    # the benchmark's configuration (tpuvdb/bench/streaming.py:41-44)
    return cls(vector_dim=DIM, shard_count=4, shard_capacity=1 << 17,
               block_size=8192, checkpoint_every_puts=20_000,
               compact_every_puts=10 ** 9, mirror_init_cap=1 << 14, **kw)


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("streaming"))
    out = streaming.run(n_total=N_TOTAL, dim=DIM, batch=BATCH, device="cpu",
                        data_dir=path)
    return path, out


def test_record_has_the_reference_keys(bench_dir):
    _, out = bench_dir
    assert set(out) == REFERENCE_KEYS
    assert out["metric"] == "durable_ingest_vectors_per_sec"
    assert out["ingest_total"] == N_TOTAL and out["dim"] == DIM
    assert out["value"] > 0 and out["recovery_s"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / (1e6 / 3600))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_both_packages_reopen_every_key(bench_dir, package, monkeypatch):
    path, _ = bench_dir
    if package == "jax":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "rescore_available", lambda: False)
        eng = JaxEngine(_cfg(JaxConfig, docstore_backend="python",
                             mirror_backend="mmap"), data_dir=path)
    else:
        eng = VectorDBEngine(_cfg(DBConfig), data_dir=path, device="cpu")
    try:
        assert eng.count() == N_TOTAL + streaming.WARM_ROWS
        vecs = np.random.default_rng(0).standard_normal(
            (N_TOTAL, DIM)).astype(np.float32)
        picks = np.random.default_rng(1).choice(N_TOTAL, 10, replace=False)
        for i in picks:
            r = eng.get(f"k{i}")
            assert r.success, r.message
            np.testing.assert_array_equal(
                np.asarray(r.vector_data.vector, np.float32), vecs[i])
        r = eng.get("warm7")
        np.testing.assert_array_equal(
            np.asarray(r.vector_data.vector, np.float32), vecs[7])
    finally:
        if package == "jax":
            eng.wal.close()
        else:
            eng.close()
