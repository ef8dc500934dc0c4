"""tpuvdb_torch.VectorDBEngine with storage_dtype="int8" (on the CPU).

* The scenarios of tests/test_ivf_int8.py and tests/test_quant.py (without
  the mesh) on the port's engine: flat and IVF int8 find `k42` first, at
  every rescore_mode and with f32 and int8 mirrors; tight cluster shells
  reach recall@10 >= 0.97 with rescore_overfetch=256 and do worse with 0;
  rescore_mode="device" fuses the re-rank into the flat index and falls
  back to the exact host re-rank on IVF; staged deletes do not eat the
  caller's width under a rescore.
* On the same data the port's flat int8 engine returns the JAX engine's
  keys (the int8 scan is exact top-k over exact int32 dots in both, and the
  host re-rank is the same numpy code), through puts, deletes, an
  overwrite, a flush and a compaction.
* mirror_dtype="int8": the int8 cells and the flat index hold the mirrors'
  codes, scales and norms bit for bit.
* Filtered searches on the device path of a quantized flat index and of
  int8 IVF cells.
* A JAX int8 data_dir (flat and IVF, f32 and int8 mirrors) restarts in the
  port, and the other way round.
* The epochs: a rescored search re-checks only the slot generation, so an
  IVF append during the re-rank does not retry it and a compaction does.
"""

import numpy as np
import pytest
import torch

from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb.core.types import VectorData as JaxData
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.core.types import SearchRequest, VectorData

DIM = 16


def _cfg(cls=DBConfig, **kw):
    base = dict(vector_dim=DIM, shard_count=2, shard_capacity=4096,
                block_size=128, storage_dtype="int8", mirror_backend="ram",
                ivf_nlist=8, ivf_nprobe=8, ivf_kmeans_iters=4,
                checkpoint_every_puts=10 ** 9, compact_every_puts=10 ** 9)
    base.update(kw)
    return cls(**base)


def _engine(data_dir=None, **kw):
    return VectorDBEngine(_cfg(**kw), data_dir=data_dir, device="cpu")


def _fill(eng, rng, n, data_cls=VectorData, dim=DIM):
    vecs = {f"k{i}": rng.standard_normal(dim).astype(np.float32)
            for i in range(n)}
    assert eng.put_batch([data_cls(key=k, vector=v)
                          for k, v in vecs.items()]).success
    return vecs


def _top(eng, q, k):
    r = eng.search(SearchRequest(query_vector=q, top_k=k))
    assert r.success
    return r.search_result


@pytest.mark.parametrize("mirror_dtype", ["float32", "int8"])
@pytest.mark.parametrize("rescore_mode", ["exact", "device", "none"])
@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_int8_engine_finds_its_rows(rng, index_type, rescore_mode,
                                    mirror_dtype):
    eng = _engine(index_type=index_type, rescore_mode=rescore_mode,
                  mirror_dtype=mirror_dtype)
    vecs = _fill(eng, rng, 300)
    res = _top(eng, vecs["k42"], 3)
    assert res.keys[0] == "k42" and len(res.keys) == 3
    index = eng._ivf if index_type == "ivf" else eng._index
    assert index.quantized
    info = eng.info()
    assert info["storage_dtype"] == "int8" and info["quantized"]
    assert info["device_bytes"] == index.nbytes() > 0
    # get returns the mirror's row: exact for f32 mirrors
    got = np.asarray(eng.get("k42").vector_data.vector, np.float32)
    np.testing.assert_allclose(got, vecs["k42"],
                               atol=0 if mirror_dtype == "float32" else 0.05)
    # delete before and after a flush, then an overwrite and a compaction
    assert eng.delete("k42").success
    assert "k42" not in _top(eng, vecs["k42"], 3).keys
    eng.flush()
    assert "k42" not in _top(eng, vecs["k42"], 3).keys
    assert eng.put(VectorData(key="k7", vector=vecs["k9"] + 0.01)).success
    assert _top(eng, vecs["k9"], 2).keys in (["k9", "k7"], ["k7", "k9"])
    eng.compact()
    assert _top(eng, vecs["k100"], 1).keys == ["k100"]
    assert eng.count() == 299


def _tight_shells(rng, per=512, d=32):
    centers = rng.standard_normal((8, d)) * 5
    data = np.concatenate([
        centers[i] + 0.15 * rng.standard_normal((per, d))
        for i in range(8)]).astype(np.float32)
    return data[rng.permutation(len(data))]


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_int8_rescore_tight_shells(rng, index_type):
    """Tight cluster shells, where raw int8 scores cannot rank the
    neighbours within a cluster: the overfetch + exact re-rank must hold
    recall@10 >= 0.97, and the same data must do worse without it."""
    data = _tight_shells(rng)
    q = data[:48]
    d2 = ((q[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    truth = [set(f"k{j}" for j in np.argsort(d2[i])[:10]) for i in range(48)]
    recall = {}
    for overfetch in (256, 0):
        eng = _engine(vector_dim=32, shard_capacity=16384,
                      index_type=index_type, rescore_overfetch=overfetch)
        assert eng.put_rows([f"k{i}" for i in range(len(data))],
                            data).success
        eng.flush()
        _, keys = eng.search_batch(q, k=10)
        recall[overfetch] = np.mean([
            len(set(keys[i][:10]) & truth[i]) / 10 for i in range(48)])
    assert recall[256] >= 0.97, recall
    assert recall[0] < recall[256], recall


def test_int8_engine_device_rescore_mode(rng):
    eng = _engine(rescore_mode="device", rescore_overfetch=16)
    vecs = _fill(eng, rng, 200)
    eng.flush()
    assert eng._index is not None and eng._index.rescore_fetch == 32
    res = _top(eng, vecs["k7"], 3)
    assert res.keys[0] == "k7"
    # the self-distance after the dequantized re-rank is near zero, not
    # int8-noisy
    assert res.scores[0] < 0.05
    assert "search.rescore" not in eng.timers.snapshot()  # no host re-rank
    eng.delete("k7")
    assert "k7" not in _top(eng, vecs["k7"], 3).keys


def test_int8_device_rescore_falls_back_to_host_on_ivf(rng):
    """rescore_mode='device' on IVF must fall back to the exact host
    re-rank, not serve raw int8 scores."""
    eng = _engine(index_type="ivf", ivf_nlist=4, ivf_nprobe=4,
                  ivf_kmeans_iters=3, rescore_mode="device",
                  rescore_overfetch=8)
    vecs = _fill(eng, rng, 300)
    eng.flush()
    res = _top(eng, vecs["k42"], 3)
    assert res.keys[0] == "k42"
    # the host re-rank ran: the self-distance is that of the f32 mirrors
    assert res.scores[0] < 1e-5
    assert "search.rescore" in eng.timers.snapshot()
    # without the re-rank the int8 score is served as it is
    raw = _engine(index_type="ivf", ivf_nlist=4, ivf_nprobe=4,
                  ivf_kmeans_iters=3, rescore_mode="none")
    raw.put_rows(list(vecs), np.stack(list(vecs.values())))
    assert abs(_top(raw, vecs["k42"], 3).scores[0]) > 1e-5


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_int8_staged_deletes_do_not_eat_width_under_rescore(rng, index_type):
    eng = _engine(index_type=index_type, flush_batch=1024)
    vecs = _fill(eng, rng, 400)
    q = vecs["k42"]
    near = [f"n{i}" for i in range(10)]
    assert eng.put_batch([
        VectorData(key=nk, vector=q + 0.01 * rng.standard_normal(DIM)
                   .astype(np.float32)) for nk in near]).success
    eng.flush()
    for nk in near[:7]:       # staged, not flushed: still on the device
        assert eng.delete(nk).success
    dists, keys = eng.search_batch(q[None], 10)
    assert None not in keys[0] and len(keys[0]) == 10
    assert keys[0][0] == "k42" and set(near[7:]) <= set(keys[0][:4])
    assert not set(near[:7]) & set(keys[0])
    assert (np.diff(dists[0]) >= 0).all()


@pytest.mark.parametrize("rescore_mode", ["exact", "device", "none"])
def test_flat_int8_engine_returns_the_jax_engines_keys(rng, rescore_mode):
    kw = dict(rescore_mode=rescore_mode, search_mode="exact")
    jeng = JaxEngine(_cfg(JaxConfig, **kw))
    port = _engine(**kw)
    data = rng.standard_normal((600, DIM)).astype(np.float32)
    keys = [f"k{i}" for i in range(600)]
    queries = np.concatenate([
        data[:4] + 0.05 * rng.standard_normal((4, DIM)).astype(np.float32),
        rng.standard_normal((12, DIM)).astype(np.float32)])

    def check():
        jd, jk = jeng.search_batch(queries, 10)
        td, tk = port.search_batch(queries, 10)
        assert tk == jk
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)

    for eng in (jeng, port):
        assert eng.put_rows(keys[:500], data[:500]).success
    check()
    for eng in (jeng, port):
        eng.flush()
        assert eng.put_rows(keys[500:], data[500:]).success  # a host delta
        assert eng.delete("k3").success
        assert eng.put_rows(["k5"], data[6:7] + 0.25).success
    check()
    for eng in (jeng, port):
        eng.flush()                      # quantize-on-scatter
    check()
    np.testing.assert_array_equal(port._index.vectors.numpy(),
                                  np.asarray(jeng._index.vectors))
    np.testing.assert_array_equal(port._index.row_scales.numpy(),
                                  np.asarray(jeng._index.row_scales))
    for eng in (jeng, port):
        eng.compact()
    check()


def test_int8_mirrors_hand_their_codes_to_the_cells(rng):
    """mirror_dtype='int8': the IVF cells and the spill hold the mirrors'
    codes, scales and norms bit for bit."""
    eng = _engine(index_type="ivf", mirror_dtype="int8")
    _fill(eng, rng, 500)
    eng.flush()
    ivf, layout = eng._ivf, eng._ivf_layout
    for rows, codes, scales, sq, valid in (
            (ivf.row_ids, ivf.grouped, ivf.cell_scales, ivf.grouped_sq,
             ivf.grouped_valid),
            (ivf.spill_row_ids, ivf.spill, ivf.spill_scales, ivf.spill_sq,
             ivf.spill_valid)):
        pos = np.flatnonzero(rows >= 0)
        assert valid.numpy()[pos].all()
        for p in pos[:: max(1, len(pos) // 64)]:
            s, sl = layout.shard_slot_of(int(rows[p]))
            c, sc, q = eng.mirrors[s].rows_raw(np.array([sl]))
            np.testing.assert_array_equal(codes[p].numpy(), c[0])
            assert scales[p].item() == sc[0] and sq[p].item() == q[0]
    # padding rows: code 0, scale 1.0, dead
    pad = np.flatnonzero(ivf.row_ids < 0)
    assert len(pad) and not ivf.grouped[pad].any()
    assert (ivf.cell_scales[pad] == 1.0).all()
    assert not ivf.grouped_valid[pad].any()
    # an append quantizes the (dequantized) mirror rows in place
    version = ivf.version
    eng.config.ivf_delta_max = 4
    _fill_more = {f"m{i}": rng.standard_normal(DIM).astype(np.float32)
                  for i in range(8)}
    eng.put_rows(list(_fill_more), np.stack(list(_fill_more.values())))
    eng.flush()
    assert eng._ivf is ivf and ivf.version > version
    assert eng.stats["ivf_appends"] >= 8
    assert _top(eng, _fill_more["m3"], 1).keys == ["m3"]


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_int8_filtered_search_on_device(rng, index_type):
    eng = _engine(index_type=index_type)
    eng._FILTER_DEVICE_MIN = 50
    data = rng.standard_normal((400, DIM)).astype(np.float32)
    assert eng.put_rows([f"k{i}" for i in range(400)], data,
                        metadatas=[{"g": str(i % 3)}
                                   for i in range(400)]).success
    eng.delete("k1")
    searches = eng.stats["searches"]
    res = eng.search(SearchRequest(query_vector=data[4], top_k=5,
                                   filter_metadata={"g": "1"})).search_result
    assert eng.stats["searches"] == searches + 1
    assert res.keys[0] == "k4" and len(res.keys) == 5
    assert all(int(k[1:]) % 3 == 1 and k != "k1" for k in res.keys)
    assert (np.diff(res.scores) >= 0).all()


def _write_and_crash(eng, rng, data_cls):
    """Checkpoint, then leave a WAL tail (puts, an overwrite, deletes) and
    close only the WAL, as a crash would."""
    data = rng.standard_normal((400, DIM)).astype(np.float32)
    eng.put_rows([f"k{i}" for i in range(400)], data,
                 metadatas=[{"g": str(i % 2)} for i in range(400)])
    eng.flush()
    eng.delete("k3")
    eng.save_checkpoint()
    eng.put(data_cls(key="k7", vector=data[8] + 0.25, metadata={"g": "x"}))
    eng.put_batch([data_cls(key=f"tail{i}", vector=data[i] + 0.5)
                   for i in range(20)])
    eng.delete("k11")
    queries = data[20:28] + 0.01
    want = eng.search_batch(queries, 10)
    count = eng.count()
    eng.wal.close()
    return queries, want, count


def _check_recovered(eng, queries, want, count, index_type):
    assert eng.count() == count
    got_d, got_k = eng.search_batch(queries, 10)
    if index_type == "flat":
        assert got_k == want[1]
        np.testing.assert_allclose(got_d, want[0], rtol=1e-5, atol=1e-4)
    else:
        # the two packages' CPU probes rank differently (the JAX engine
        # takes its XLA route there): the re-ranked hits agree in the main
        same = np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(got_k, want[1])])
        assert same >= 0.9, same
        assert [r[0] for r in got_k] == [r[0] for r in want[1]]
    assert eng.get("k7").vector_data.metadata == {"g": "x"}
    assert not eng.get("k11").success and not eng.get("k3").success
    index = eng._ivf if index_type == "ivf" else eng._index
    assert index.quantized


@pytest.mark.parametrize("mirror_dtype", ["float32", "int8"])
@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_jax_int8_data_dir_recovers_in_port(rng, tmp_path, index_type,
                                            mirror_dtype):
    kw = dict(index_type=index_type, mirror_dtype=mirror_dtype)
    jeng = JaxEngine(_cfg(JaxConfig, **kw), data_dir=str(tmp_path))
    queries, want, count = _write_and_crash(jeng, rng, JaxData)
    port = _engine(data_dir=str(tmp_path), **kw)
    _check_recovered(port, queries, want, count, index_type)
    if mirror_dtype == "int8":
        assert port.mirrors[0].quantized
    port.close()


@pytest.mark.parametrize("mirror_dtype", ["float32", "int8"])
@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_port_int8_data_dir_recovers_in_jax(rng, tmp_path, index_type,
                                            mirror_dtype):
    kw = dict(index_type=index_type, mirror_dtype=mirror_dtype)
    port = _engine(data_dir=str(tmp_path), **kw)
    queries, want, count = _write_and_crash(port, rng, VectorData)
    jeng = JaxEngine(_cfg(JaxConfig, **kw), data_dir=str(tmp_path))
    _check_recovered(jeng, queries, want, count, index_type)
    jeng.close()
    # and back again, now from the JAX engine's close() checkpoint
    port = _engine(data_dir=str(tmp_path), **kw)
    assert port.search_batch(queries, 10)[1] == want[1]
    port.close()


def test_rescored_search_checks_only_the_slot_generation(rng):
    """An IVF append that lands during the host re-rank bumps the device
    epoch but moves no slot: the rescored search completes. A compaction
    reuses slots: the search retries and returns the compacted state."""
    eng = _engine(index_type="ivf", ivf_delta_max=4)
    vecs = _fill(eng, rng, 300)
    eng.flush()
    real = VectorDBEngine._rescore_exact
    fired = []

    def rescore_then(action):
        def wrapped(*a, **kw):
            out = real(*a, **kw)
            if not fired:
                fired.append(True)
                action()
            return out
        return staticmethod(wrapped)

    def append():
        more = rng.standard_normal((8, DIM)).astype(np.float32)
        eng.put_rows([f"a{i}" for i in range(8)], more)
        eng.flush()                       # > ivf_delta_max: an append

    eng._rescore_exact = rescore_then(append).__func__
    gen, retries = eng._generation, eng.stats["search_retries"]
    assert _top(eng, vecs["k42"], 3).keys[0] == "k42"
    assert eng._generation > gen and eng.stats["ivf_appends"] >= 8
    assert eng.stats["search_retries"] == retries

    fired.clear()
    eng._rescore_exact = rescore_then(
        lambda: (eng.delete("k42"), eng.compact(online=False))).__func__
    slot_gen = eng._slot_generation
    assert "k42" not in _top(eng, vecs["k42"], 3).keys
    assert eng._slot_generation == slot_gen + 1
    assert eng.stats["search_retries"] > retries
