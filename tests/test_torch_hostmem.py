"""The port's host helpers (tpuvdb_torch/utils/{vector_utils,hostmem}.py)
against the JAX package's copies, and the IVF build's memory tags.

* vector_utils: equal arrays (exactly) on good inputs, the same
  ValueError message on bad ones.
* hostmem: MEM_STAGES keeps the newest 4,096 samples (the reference's list
  is unbounded; a divergence by design), memlog logs under
  "tpuvdb_torch.memlog" when TPUVDB_MEMLOG is set, anon_gb and trim_heap
  answer as the reference's do. keep_malloc_warm is not called: it sets
  the process's malloc policy for good.
* An IVF engine build on the CPU (2,048 x 16 rows, nlist 16) appends the
  same tags in the same order to the port's MEM_STAGES as the same build
  of the JAX engine appends to tpuvdb.utils.hostmem.MEM_STAGES, both
  cleared first: the five build phases, then the engine's trimmed
  rebuild.
"""

import logging

import numpy as np
import pytest

from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb.utils import hostmem as jax_hostmem
from tpuvdb.utils import vector_utils as jax_vu
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch import utils as port_utils
from tpuvdb_torch.utils import hostmem
from tpuvdb_torch.utils import vector_utils as vu

BUILD_TAGS = ["build: start", "build: trained (cents+codebooks)",
              "build: assigned+encoded", "build: split done",
              "build: packed", "engine: ivf rebuild done (trimmed)"]


@pytest.mark.parametrize("shape", [(16,), (1, 16), (5, 16)])
def test_as_f32_matrix_equal_to_reference(rng, shape):
    x = rng.standard_normal(shape)  # float64 in, float32 out
    got, want = vu.as_f32_matrix(x, 16), jax_vu.as_f32_matrix(x, 16)
    assert got.dtype == want.dtype == np.float32
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    lst = x.tolist()
    np.testing.assert_array_equal(vu.as_f32_matrix(lst, 16),
                                  jax_vu.as_f32_matrix(lst, 16))


@pytest.mark.parametrize("shape", [(15,), (3, 17), (2, 3, 16)])
def test_as_f32_matrix_raises_as_reference(rng, shape):
    x = rng.standard_normal(shape)
    with pytest.raises(ValueError) as got:
        vu.as_f32_matrix(x, 16)
    with pytest.raises(ValueError) as want:
        jax_vu.as_f32_matrix(x, 16)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axis", [-1, 0])
def test_l2_normalize_equal_to_reference(rng, axis):
    x = rng.standard_normal((6, 8)).astype(np.float32)
    x[2] = 0.0  # a zero row divides by eps, not by zero
    np.testing.assert_array_equal(vu.l2_normalize(x, axis=axis),
                                  jax_vu.l2_normalize(x, axis=axis))


def test_utils_exports_the_references_names():
    import tpuvdb.utils as jax_utils

    assert sorted(port_utils.__all__) == sorted(jax_utils.__all__)
    assert port_utils.as_f32_matrix is vu.as_f32_matrix
    assert port_utils.l2_normalize is vu.l2_normalize


def test_mem_stages_keeps_the_newest_samples(monkeypatch):
    monkeypatch.setattr(hostmem, "MEM_STAGES",
                        type(hostmem.MEM_STAGES)(maxlen=4096))
    # a sample is the tag and anon_gb() (a read of smaps_rollup, ms each)
    sizes = iter(range(10 ** 6))
    monkeypatch.setattr(hostmem, "anon_gb", lambda: float(next(sizes)))
    assert hostmem.MEM_STAGES.maxlen == 4096
    for i in range(4096 + 10):
        hostmem.memlog(f"t{i}")
    tags = [t for t, _ in hostmem.MEM_STAGES]
    assert len(tags) == 4096
    assert tags[0] == "t10" and tags[-1] == "t4105"
    assert [gb for _, gb in hostmem.MEM_STAGES] == list(
        map(float, range(10, 4106)))


def test_memlog_logs_only_when_asked(monkeypatch, caplog):
    monkeypatch.delenv("TPUVDB_MEMLOG", raising=False)
    with caplog.at_level(logging.WARNING, logger="tpuvdb_torch.memlog"):
        hostmem.memlog("quiet")
        assert not caplog.records
        monkeypatch.setenv("TPUVDB_MEMLOG", "1")
        hostmem.memlog("phase x")
    assert [r.name for r in caplog.records] == ["tpuvdb_torch.memlog"]
    assert "phase x" in caplog.records[0].getMessage()
    assert hostmem.MEM_STAGES[-1][0] == "phase x"


def test_anon_gb_and_trim_heap_answer_as_reference():
    assert (hostmem.anon_gb() > 0) == (jax_hostmem.anon_gb() > 0)
    assert hostmem.trim_heap() == jax_hostmem.trim_heap()


def test_ivf_build_tags_equal_to_reference(rng, monkeypatch):
    data = rng.standard_normal((2048, 16)).astype(np.float32)
    keys = [f"k{i}" for i in range(len(data))]
    kw = dict(vector_dim=16, shard_count=2, shard_capacity=4096,
              mirror_init_cap=1024, index_type="ivf", ivf_nlist=16,
              ivf_nprobe=4, ivf_kmeans_iters=3, wal_enabled=False,
              checkpoint_every_puts=10 ** 9, compact_every_puts=10 ** 9)
    monkeypatch.setattr(jax_hostmem, "MEM_STAGES", [])
    monkeypatch.setattr(hostmem, "MEM_STAGES",
                        type(hostmem.MEM_STAGES)(maxlen=4096))
    jax_eng = JaxEngine(JaxConfig(**kw))
    assert jax_eng.put_rows(keys, data).success
    jax_eng.flush()
    eng = VectorDBEngine(DBConfig(**kw), device="cpu")
    assert eng.put_rows(keys, data).success
    eng.flush()
    eng.close()
    want = [t for t, _ in jax_hostmem.MEM_STAGES]
    got = [t for t, _ in hostmem.MEM_STAGES]
    assert want == BUILD_TAGS
    assert got == want
