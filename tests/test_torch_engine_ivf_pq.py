"""tpuvdb_torch.VectorDBEngine with IVF-PQ cells (on the CPU).

* The scenarios of tests/test_engine_ivf_pq.py, tests/test_pq4.py,
  tests/test_opq.py and tests/test_ivf_packed_restore.py that need no mesh,
  on the port's engine, over the three tiers (8-bit, 4-bit, OPQ): end to
  end, delete and overwrite, appends that drain without a recluster, a warm
  restart that trains nothing (through the packed file and without it),
  filtered search on the host and through the probe's validity mask, the
  deep rescore window, the adaptive rescore against the full window,
  `pq_err` across a restart, the caller-visible width, a tier flip on
  restart, and the packed checkpoint: restore without a build, WAL-tail
  reconcile, flag off, stale configuration, identical results, the clean
  hard link, and a write that overlaps the fetch.
* data_dirs interchange: a JAX IVF-PQ data_dir (warm keys in ivf_warm.npz,
  with and without ivf_packed.npz) restarts in the port without training
  or, with the packed file, without a build, and the port's restart in the
  JAX engine likewise.
* On clustered data the port's and the JAX engine's keys after the exact
  re-rank agree in recall@10 against an exact scan (each >= 0.9) and in the
  first key (the JAX engine takes `_ivf_search_pq` on the CPU, which masks
  over-scanned rows where the probe kernel scores them, so the candidate
  sets differ beyond that).

Exact distances come from the f32 mirrors in both engines: a self-query
scores < 1e-2, as in the reference's tests.
"""

import os

import numpy as np
import pytest

import tpuvdb_torch.index.ivf as ivf_mod
import tpuvdb_torch.kernels.pq as pq_mod
from tpuvdb.core.config import DBConfig as JaxConfig
from tpuvdb import native as jax_native
from tpuvdb.engine.engine import VectorDBEngine as JaxEngine
from tpuvdb_torch import DBConfig, VectorDBEngine
from tpuvdb_torch.core.types import SearchRequest, VectorData
from tpuvdb_torch.kernels.distance import numpy_oracle

DIM = 16
TIERS = {
    "pq8": {},
    "pq4": {"ivf_pq_bits": 4},
    "opq": {"ivf_opq": True},
}
CB_SHAPE = {"pq8": (4, 256, 4), "pq4": (8, 16, 2), "opq": (4, 256, 4)}


def pq_config(cls=DBConfig, **kw):
    d = dict(vector_dim=DIM, shard_count=4, shard_capacity=8192,
             block_size=128, index_type="ivf", ivf_nlist=8, ivf_nprobe=8,
             ivf_kmeans_iters=5, ivf_delta_max=64, ivf_pq_subq=4,
             rescore_overfetch=16, checkpoint_every_puts=10 ** 9,
             compact_every_puts=10 ** 9)
    d.update(kw)
    return cls(**d)


def engine(data_dir=None, **kw):
    return VectorDBEngine(pq_config(**kw), data_dir=data_dir, device="cpu")


def fill(eng, rng, n, prefix="k"):
    vecs = {}
    batch = []
    for i in range(n):
        v = rng.standard_normal(DIM).astype(np.float32)
        vecs[f"{prefix}{i}"] = v
        batch.append(VectorData(key=f"{prefix}{i}", vector=v))
    assert eng.put_batch(batch).success
    return vecs


def top(eng, q, k, **kw):
    r = eng.search(SearchRequest(query_vector=q, top_k=k, **kw))
    assert r.success
    return r.search_result


def no_training(*a, **k):
    raise AssertionError("training ran on a warm restart")


def forbid_training(monkeypatch, ivf=ivf_mod, pq=pq_mod):
    monkeypatch.setattr(ivf, "kmeans", no_training)
    monkeypatch.setattr(pq, "train_pq", no_training)
    monkeypatch.setattr(pq, "train_opq", no_training)


def forbid_build(monkeypatch, ivf=ivf_mod):
    def no_build(*a, **k):
        raise AssertionError("a full IVF build ran on a packed restart")

    monkeypatch.setattr(ivf.IVFIndex, "build_streaming",
                        classmethod(no_build))


# ------------------------------------------------------------- scenarios


@pytest.mark.parametrize("tier", list(TIERS))
def test_pq_engine_end_to_end(rng, tier):
    eng = engine(**TIERS[tier])
    vecs = fill(eng, rng, 400)
    eng.flush()
    ivf = eng._ivf
    assert ivf is not None and ivf.pq and not ivf.quantized
    assert tuple(ivf.pq_codebooks.shape) == CB_SHAPE[tier]
    assert (ivf.pq_rotation is not None) == (tier == "opq")
    assert ivf.grouped.shape[1] == 4  # bytes per row in every tier
    # the exact re-rank makes self-queries exact despite lossy cells
    for key in ("k3", "k123", "k321"):
        res = top(eng, vecs[key], 5)
        assert res.keys[0] == key and res.scores[0] < 1e-2
    info = eng.info()
    assert info["device_bytes"] == ivf.nbytes() > 0
    assert not info["quantized"]


@pytest.mark.parametrize("tier", list(TIERS))
def test_pq_delete_and_overwrite(rng, tier):
    eng = engine(**TIERS[tier])
    vecs = fill(eng, rng, 300)
    eng.flush()
    assert eng.delete("k7").success
    assert "k7" not in top(eng, vecs["k7"], 5).keys
    nv = rng.standard_normal(DIM).astype(np.float32)
    eng.put(VectorData(key="k9", vector=nv))
    for _ in range(2):  # staged, then flushed into the delta
        res = top(eng, nv, 1)
        assert res.keys[0] == "k9" and res.scores[0] < 1e-2
        eng.flush()


@pytest.mark.parametrize("tier", list(TIERS))
def test_pq_sustained_appends_drain_without_recluster(rng, tier):
    """Overflowing ivf_delta_max drains through append_rows: the rows are
    residual-coded with the trained codebooks (and rotation) and stay
    searchable; the index is not rebuilt."""
    eng = engine(ivf_delta_max=64, **TIERS[tier])
    fill(eng, rng, 300)
    eng.flush()
    ivf = eng._ivf
    vecs2 = fill(eng, rng, 200, prefix="m")  # > delta_max: appends
    eng.flush()
    assert eng._ivf is ivf and eng.stats["ivf_appends"] == 200
    assert eng.info()["ivf_delta"] == 0
    res = top(eng, vecs2["m150"], 3)
    assert res.keys[0] == "m150" and res.scores[0] < 1e-2


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("packed", [True, False])
def test_pq_warm_restart_trains_nothing(rng, tmp_path, monkeypatch, tier,
                                        packed):
    """A restart reuses the checkpointed centroids, codebooks and rotation:
    k-means, PQ and OPQ training must not run, whether the restart takes
    the packed file or encodes the rows again."""
    d = str(tmp_path / "db")
    kw = dict(ivf_delta_max=10_000, ivf_checkpoint_packed=packed,
              **TIERS[tier])
    eng = engine(d, **kw)
    vecs = fill(eng, rng, 400)
    eng.flush()
    cb0 = eng._ivf.pq_codebooks_np().copy()
    rot0 = eng._ivf.pq_rotation_np()
    want = eng.search_batch(np.stack([vecs["k42"], vecs["k7"]]), 5)
    eng.close()

    forbid_training(monkeypatch)
    eng2 = engine(d, **kw)
    res = top(eng2, vecs["k42"], 3)
    assert res.keys[0] == "k42" and res.scores[0] < 1e-2
    np.testing.assert_array_equal(eng2._ivf.pq_codebooks_np(), cb0)
    if tier == "opq":
        np.testing.assert_array_equal(eng2._ivf.pq_rotation_np(), rot0)
    assert eng2.stats.get("ivf_packed_restores", 0) == int(packed)
    got = eng2.search_batch(np.stack([vecs["k42"], vecs["k7"]]), 5)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    eng2.close()


@pytest.mark.parametrize("on_device", [False, True])
def test_pq_filtered_search(rng, on_device):
    eng = engine()
    if on_device:  # the filter folds into the probe's validity mask
        eng._FILTER_DEVICE_MIN = 10
    vecs = {}
    batch = []
    for i in range(300):
        v = rng.standard_normal(DIM).astype(np.float32)
        vecs[f"k{i}"] = v
        batch.append(VectorData(key=f"k{i}", vector=v,
                                metadata={"par": str(i % 2)}))
    eng.put_batch(batch)
    eng.flush()
    res = top(eng, vecs["k11"], 5, filter_metadata={"par": "1"})
    assert len(res.keys) == 5
    assert all(int(k[1:]) % 2 == 1 for k in res.keys)
    if not on_device:
        assert res.keys[0] == "k11"


def _spy_fetch(eng, seen):
    orig = eng._ivf_search_rows

    def spy(queries, fetch_k, *a):
        seen["fetch_k"] = fetch_k
        return orig(queries, fetch_k, *a)

    eng._ivf_search_rows = spy


def test_pq_deep_rescore_window(rng):
    """PQ searches re-rank a deeper window than int8: fetch_k honours
    ivf_pq_rescore_overfetch, and 0 falls back to rescore_overfetch."""
    q = rng.standard_normal((2, DIM)).astype(np.float32)
    for ovf, want in ((64, 64 * 5), (0, 16 * 5)):
        eng = engine(shard_capacity=512, ivf_delta_max=2048,
                     ivf_pq_rescore_overfetch=ovf)
        fill(eng, rng, 1200)
        eng.flush()
        seen = {}
        _spy_fetch(eng, seen)
        eng.search_batch(q, 5)
        assert seen["fetch_k"] == want


def test_pq_adaptive_rescore_matches_full_window(rng):
    """The error-bounded re-rank serves the same top-k as the full fixed
    window while gathering fewer candidate rows from the mirrors."""
    cents = rng.standard_normal((8, DIM)).astype(np.float32) * 3
    corpus = {f"k{i}": cents[i % 8]
              + rng.standard_normal(DIM).astype(np.float32) * 0.2
              for i in range(1500)}
    batch = [VectorData(key=k, vector=v) for k, v in corpus.items()]
    engines = []
    for adaptive in (True, False):
        eng = engine(shard_capacity=4096, ivf_delta_max=100_000,
                     ivf_pq_adaptive_rescore=adaptive)
        assert eng.put_batch(batch).success
        eng.flush()
        engines.append(eng)
    ada, full = engines
    assert ada._ivf.pq_err > 0.0  # the build calibrated the bound
    q = np.stack([corpus[f"k{i}"] for i in range(32)])
    q = q + rng.standard_normal(q.shape).astype(np.float32) * 0.05
    d_a, k_a = ada.search_batch(q, 10)
    d_f, k_f = full.search_batch(q, 10)
    assert k_a == k_f
    # the two re-ranks form |q|^2 - 2 q.v + |v|^2 with a batched product
    # and with a per-candidate sum: norms near 150 cancel to distances
    # near 1, which leaves a few f32 ulps of 300 between them
    np.testing.assert_allclose(d_a, d_f, rtol=1e-5, atol=1e-4)
    assert ada.stats["rescore_skipped_rows"] > 0
    assert ada.stats["rescored_rows"] > 0
    assert full.stats["rescore_skipped_rows"] == 0


def test_adaptive_rescore_takes_empty_slots(rng):
    """Candidates past the probe's reach carry +inf and row -1: the bound
    must not turn them into nan, and they stay last."""
    eng = engine(ivf_nprobe=1, ivf_delta_max=10_000)
    fill(eng, rng, 200)
    eng.flush()
    q = rng.standard_normal((3, DIM)).astype(np.float32)
    d, keys = eng.search_batch(q, 10)
    assert not np.isnan(d).any()
    for row_d, row_k in zip(d, keys):
        live = [k is not None for k in row_k]
        assert live == sorted(live, reverse=True)
        assert np.isinf(row_d[~np.asarray(live)]).all()


@pytest.mark.parametrize("packed", [True, False])
def test_pq_err_survives_checkpoint_restart(rng, tmp_path, packed):
    """pq_err rides the warm state like the codebooks, on the warm rebuild
    and on the packed restore; 0 is not stored and reads back as 0."""
    d = str(tmp_path / "db")
    kw = dict(ivf_delta_max=10_000, ivf_checkpoint_packed=packed)
    eng = engine(d, **kw)
    vecs = fill(eng, rng, 400)
    eng.flush()
    err0 = eng._ivf.pq_err
    assert err0 > 0.0
    eng.close()
    with np.load(os.path.join(eng.ckpts.latest(), "ivf_warm.npz")) as z:
        assert float(z["pq_err"]) == pytest.approx(err0)
    eng2 = engine(d, **kw)
    assert top(eng2, vecs["k7"], 3).keys[0] == "k7"
    assert eng2._ivf.pq_err == pytest.approx(err0)
    # an uncalibrated index writes no pq_err key
    eng2._ivf_pq_err = 0.0
    eng2.close()
    with np.load(os.path.join(eng2.ckpts.latest(), "ivf_warm.npz")) as z:
        assert "pq_err" not in z and "pq_codebooks" in z
    assert eng2.ckpts.load_ivf_warm()[6] == 0.0


def test_search_width_is_caller_visible(rng):
    """The returned width is what the caller asked for (k, or the
    overfetch slack), not the 64 * k rescore window."""
    eng = engine(shard_capacity=512, ivf_delta_max=2048)
    fill(eng, rng, 1200)
    eng.flush()
    q = rng.standard_normal((3, DIM)).astype(np.float32)
    d, keys = eng.search_batch(q, 5)
    assert d.shape == (3, 5)
    assert all(len(row) == 5 for row in keys)
    assert all(k_ is not None for row in keys for k_ in row)
    d2, _ = eng.search_batch(q, 5, overfetch=True)
    assert d2.shape[1] == max(2 * 5, 5 + 16)
    assert (np.diff(d, axis=1) >= -1e-5).all()


def test_search_width_refills_after_deletes(rng):
    """Staged deletes inside the candidate set do not eat the caller's
    width: the return still carries k live hits."""
    eng = engine(shard_capacity=512, ivf_delta_max=2048,
                 flush_batch=1 << 30)
    vecs = fill(eng, rng, 1200)
    eng.flush()
    target = vecs["k7"]
    _, keys0 = eng.search_batch(target.reshape(1, -1), 8)
    victims = [k_ for k_ in keys0[0][:4] if k_ is not None]
    for k_ in victims:
        assert eng.delete(k_).success
    _, keys1 = eng.search_batch(target.reshape(1, -1), 8)
    live = [k_ for k_ in keys1[0] if k_ is not None]
    assert len(live) == 8 and not set(live) & set(victims)


def test_pq4_tier_flip_on_restart(rng, tmp_path):
    """Flipping the bit tier on a restart: the stale codebook shape (and
    the packed file of the other tier) retrain and rebuild cleanly."""
    d = str(tmp_path / "db")
    eng = engine(d, ivf_delta_max=10_000, ivf_pq_bits=4)
    vecs = fill(eng, rng, 400)
    eng.flush()
    assert tuple(eng._ivf.pq_codebooks.shape) == (8, 16, 2)
    eng.close()
    eng3 = engine(d, ivf_delta_max=10_000, ivf_pq_bits=8)
    eng3.flush()  # the IVF rebuilds lazily: the flip happens here
    assert tuple(eng3._ivf.pq_codebooks.shape) == (4, 256, 4)
    assert eng3.stats.get("ivf_packed_restores", 0) == 0
    assert top(eng3, vecs["k42"], 3).keys[0] == "k42"
    eng3.close()


def test_pq_config_validation_and_device():
    with pytest.raises(ValueError, match="divide"):
        DBConfig(vector_dim=30, index_type="ivf", ivf_pq_subq=7)
    with pytest.raises(ValueError, match="exclusive"):
        DBConfig(vector_dim=32, index_type="ivf", ivf_pq_subq=4,
                 storage_dtype="int8")
    with pytest.raises(ValueError, match="ivf_opq"):
        DBConfig(vector_dim=32, index_type="ivf", ivf_opq=True)
    with pytest.raises(ValueError, match="subspaces"):
        DBConfig(vector_dim=48, index_type="ivf", ivf_pq_subq=16,
                 ivf_pq_bits=4)
    # int8 mirrors under PQ cells is the intended capacity pairing
    eng = engine(mirror_dtype="int8")
    assert eng.mirrors[0].quantized
    import torch

    if not torch.cuda.is_available():  # device=None means cuda: no fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VectorDBEngine(pq_config())


def test_pq_engine_over_int8_mirrors(rng):
    """PQ cells over int8 mirrors: rows reach the encoder dequantized, and
    the exact re-rank is exact to the mirrors' rows."""
    eng = engine(mirror_dtype="int8", ivf_delta_max=64)
    vecs = fill(eng, rng, 400)
    eng.flush()
    fill(eng, rng, 100, prefix="m")
    eng.flush()
    res = top(eng, vecs["k123"], 5)
    assert res.keys[0] == "k123" and res.scores[0] < 1e-2


# ------------------------------------------------------ packed checkpoint


def test_packed_restore_skips_reencode(rng, tmp_path, monkeypatch):
    d = str(tmp_path / "db")
    eng = engine(d, ivf_delta_max=10_000)
    vecs = fill(eng, rng, 400)
    eng.flush()
    nlist0 = eng._ivf.nlist
    eng.close()  # the checkpoint covers everything: no WAL tail
    forbid_build(monkeypatch)
    eng2 = engine(d, ivf_delta_max=10_000)
    res = top(eng2, vecs["k42"], 3)
    assert res.keys[0] == "k42" and res.scores[0] < 1e-2
    assert eng2._ivf.nlist == nlist0
    assert eng2.stats["ivf_packed_restores"] == 1
    eng2.close()


def test_packed_restore_reconciles_wal_tail(rng, tmp_path, monkeypatch):
    """Puts and deletes replayed from the WAL tail land on top of the
    restored image: appended rows searchable, deleted rows gone, and still
    no full build."""
    d = str(tmp_path / "db")
    eng = engine(d, ivf_delta_max=10_000)
    vecs = fill(eng, rng, 400)
    eng.flush()
    eng.save_checkpoint()
    tail = fill(eng, rng, 60, prefix="t")  # after the checkpoint
    assert eng.delete("k7").success
    eng.wal.close()  # crash: the tail lives only in the WAL
    forbid_build(monkeypatch)
    eng2 = engine(d, ivf_delta_max=10_000)
    assert eng2.count() == 400 + 60 - 1
    res = top(eng2, tail["t13"], 3)
    assert res.keys[0] == "t13" and res.scores[0] < 1e-2
    assert "k7" not in top(eng2, vecs["k7"], 10).keys
    assert top(eng2, vecs["k123"], 3).keys[0] == "k123"
    assert eng2.stats["ivf_packed_restores"] == 1
    # the restored image is no longer the checkpoint's: the next checkpoint
    # fetches it again instead of linking
    assert eng2._ivf_packed_saved_epoch != eng2._ivf_packed_epoch
    eng2.close()


def test_packed_flag_off_writes_nothing(rng, tmp_path):
    d = str(tmp_path / "db")
    eng = engine(d, ivf_checkpoint_packed=False)
    fill(eng, rng, 300)
    eng.flush()
    eng.close()
    ckpt = eng.ckpts.latest()
    assert ckpt is not None
    assert not os.path.exists(os.path.join(ckpt, "ivf_packed.npz"))
    eng2 = engine(d, ivf_checkpoint_packed=False)
    assert eng2.count() == 300
    eng2.flush()
    assert eng2.stats.get("ivf_packed_restores", 0) == 0
    eng2.close()


@pytest.mark.parametrize("change", [{"ivf_pq_subq": 8}, {"ivf_opq": True},
                                    {"ivf_pq_bits": 4}])
def test_packed_stale_config_falls_back_to_build(rng, tmp_path, change):
    """A restart under another PQ geometry must not upload the stale image:
    it retrains and rebuilds."""
    d = str(tmp_path / "db")
    eng = engine(d)
    vecs = fill(eng, rng, 300)
    eng.flush()
    eng.close()
    eng2 = engine(d, **change)
    eng2.flush()
    assert eng2.stats.get("ivf_packed_restores", 0) == 0
    assert eng2._ivf is not None and eng2._ivf.pq
    assert top(eng2, vecs["k11"], 3).keys[0] == "k11"
    eng2.close()


def test_packed_roundtrip_search_parity(rng, tmp_path, monkeypatch):
    """The restored index returns the results of the one before the
    restart (identical cells, codes and re-rank)."""
    d = str(tmp_path / "db")
    eng = engine(d, ivf_delta_max=10_000)
    fill(eng, rng, 500)
    eng.flush()
    qs = rng.standard_normal((16, DIM)).astype(np.float32)
    d0, k0 = eng.search_batch(qs, 5)
    eng.close()
    forbid_build(monkeypatch)
    eng2 = engine(d, ivf_delta_max=10_000)
    d1, k1 = eng2.search_batch(qs, 5)
    assert k0 == k1
    np.testing.assert_array_equal(d0, d1)
    eng2.close()


def test_packed_clean_checkpoint_links_the_file(rng, tmp_path):
    """While the index is unchanged since the last packed save, the next
    checkpoint hard-links that file instead of fetching the code table;
    a flush that touches the index makes the next one fetch again."""
    d = str(tmp_path / "db")
    eng = engine(d, ivf_delta_max=10_000)
    fill(eng, rng, 300)
    eng.flush()
    p1 = os.path.join(eng.save_checkpoint(), "ivf_packed.npz")
    fetched = []
    real = ivf_mod.IVFIndex.packed_fetch
    ivf_mod.IVFIndex.packed_fetch = staticmethod(
        lambda cap: fetched.append(1) or real(cap))
    try:
        p2 = os.path.join(eng.save_checkpoint(), "ivf_packed.npz")
        assert not fetched and os.path.samefile(p1, p2)
        assert eng.delete("k5").success
        eng.flush()                      # the index changed
        p3 = os.path.join(eng.save_checkpoint(), "ivf_packed.npz")
        assert fetched == [1] and not os.path.samefile(p2, p3)
    finally:
        ivf_mod.IVFIndex.packed_fetch = real
    eng.close()


def test_packed_file_is_skipped_when_a_write_overlaps_the_fetch(rng,
                                                                tmp_path):
    """The port writes the index in place: a write between the capture
    (under the lock) and the end of the fetch (off it) moves `version`, the
    fetch raises, and the checkpoint goes without the packed file. The
    restart then takes the warm path."""
    d = str(tmp_path / "db")
    eng = engine(d, ivf_delta_max=10_000)
    vecs = fill(eng, rng, 300)
    eng.flush()
    real = ivf_mod.IVFIndex.packed_fetch

    def racing(cap):
        cap["_index"].invalidate_rows(np.asarray([0]))  # an in-place write
        return real(cap)

    ivf_mod.IVFIndex.packed_fetch = staticmethod(racing)
    try:
        path = eng.save_checkpoint()
    finally:
        ivf_mod.IVFIndex.packed_fetch = real
    assert not os.path.exists(os.path.join(path, "ivf_packed.npz"))
    assert os.path.exists(os.path.join(path, "ivf_warm.npz"))
    eng.wal.close()
    eng2 = engine(d, ivf_delta_max=10_000)
    assert top(eng2, vecs["k42"], 3).keys[0] == "k42"
    assert eng2.stats.get("ivf_packed_restores", 0) == 0
    eng2.close()


# ------------------------------------------------- interchange with JAX


def _jax_fill(eng, vecs):
    from tpuvdb.core.types import VectorData as JVD

    assert eng.put_batch([JVD(key=k, vector=v)
                          for k, v in vecs.items()]).success


def _jax_top(eng, q, k):
    from tpuvdb.core.types import SearchRequest as JSR

    r = eng.search(JSR(query_vector=q, top_k=k))
    assert r.success
    return r.search_result


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("packed", [True, False])
def test_jax_pq_data_dir_restarts_in_the_port(rng, tmp_path, monkeypatch,
                                              tier, packed):
    d = str(tmp_path / "db")
    kw = dict(ivf_delta_max=10_000, ivf_checkpoint_packed=packed,
              **TIERS[tier])
    vecs = {f"k{i}": rng.standard_normal(DIM).astype(np.float32)
            for i in range(400)}
    jeng = JaxEngine(pq_config(JaxConfig, **kw), data_dir=d)
    _jax_fill(jeng, vecs)
    jeng.flush()
    cb0 = np.asarray(jeng._ivf.pq_codebooks)
    err0 = jeng._ivf.pq_err
    jeng.close()
    ckpt = jeng.ckpts.latest()
    assert os.path.exists(os.path.join(ckpt, "ivf_packed.npz")) == packed

    forbid_training(monkeypatch)
    if packed:
        forbid_build(monkeypatch)
    eng = engine(d, **kw)
    res = top(eng, vecs["k42"], 3)
    assert res.keys[0] == "k42" and res.scores[0] < 1e-2
    np.testing.assert_array_equal(eng._ivf.pq_codebooks_np(), cb0)
    assert eng._ivf.pq_err == pytest.approx(err0)
    assert (eng._ivf.pq_rotation is not None) == (tier == "opq")
    assert eng.stats.get("ivf_packed_restores", 0) == int(packed)
    eng.close()


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("packed", [True, False])
def test_port_pq_data_dir_restarts_in_jax(rng, tmp_path, monkeypatch, tier,
                                          packed):
    import tpuvdb.index.ivf as jivf
    import tpuvdb.kernels.pq as jpq

    d = str(tmp_path / "db")
    kw = dict(ivf_delta_max=10_000, ivf_checkpoint_packed=packed,
              **TIERS[tier])
    eng = engine(d, **kw)
    vecs = fill(eng, rng, 400)
    eng.flush()
    cb0 = eng._ivf.pq_codebooks_np().copy()
    err0 = eng._ivf.pq_err
    eng.close()

    forbid_training(monkeypatch, ivf=jivf, pq=jpq)
    if packed:
        forbid_build(monkeypatch, ivf=jivf)
    jeng = JaxEngine(pq_config(JaxConfig, **kw), data_dir=d)
    res = _jax_top(jeng, vecs["k42"], 3)
    assert res.keys[0] == "k42" and res.scores[0] < 1e-2
    np.testing.assert_array_equal(np.asarray(jeng._ivf.pq_codebooks), cb0)
    assert jeng._ivf.pq_err == pytest.approx(err0)
    assert jeng.stats.get("ivf_packed_restores", 0) == int(packed)
    jeng.close()


def test_packed_file_has_the_reference_keys(rng, tmp_path):
    """ivf_packed.npz carries the reference's keys and dtypes, so either
    package's from_packed takes the other's file."""
    vecs = {f"k{i}": rng.standard_normal(DIM).astype(np.float32)
            for i in range(300)}
    files = {}
    for name in ("jax", "torch"):
        d = str(tmp_path / name)
        kw = dict(ivf_delta_max=10_000, ivf_opq=True)
        if name == "jax":
            eng = JaxEngine(pq_config(JaxConfig, **kw), data_dir=d)
            _jax_fill(eng, vecs)
        else:
            eng = engine(d, **kw)
            assert eng.put_batch([VectorData(key=k, vector=v)
                                  for k, v in vecs.items()]).success
        eng.flush()
        eng.close()
        with np.load(os.path.join(eng.ckpts.latest(),
                                  "ivf_packed.npz")) as z:
            files[name] = {k: (z[k].dtype, z[k].ndim) for k in z.files}
    assert files["torch"] == files["jax"]


@pytest.mark.parametrize("tier", list(TIERS))
def test_keys_after_the_rerank_agree_with_the_jax_engine(rng, tier):
    """Recall@10 against an exact scan (each >= 0.9) and the first key."""
    n, k = 2000, 10
    cents = rng.standard_normal((16, DIM)).astype(np.float32) * 3
    data = (cents[rng.integers(0, 16, n)]
            + 0.4 * rng.standard_normal((n, DIM))).astype(np.float32)
    keys = [f"k{i}" for i in range(n)]
    queries = data[:32] + 0.05 * rng.standard_normal(
        (32, DIM)).astype(np.float32)
    _, truth = numpy_oracle(queries, data, np.ones(n, bool), k)
    kw = dict(ivf_nlist=16, ivf_nprobe=16, ivf_delta_max=100_000,
              **TIERS[tier])
    eng = engine(**kw)
    assert eng.put_rows(keys, data).success
    eng.flush()
    jeng = JaxEngine(pq_config(JaxConfig, **kw))
    assert jeng.put_rows(keys, data).success
    jeng.flush()
    _, got = eng.search_batch(queries, k)
    _, jgot = jeng.search_batch(queries, k)

    def recall(rows):
        return np.mean([len({keys[i] for i in t} & set(r)) / k
                        for r, t in zip(rows, truth)])

    assert recall(got) >= 0.9 and recall(jgot) >= 0.9
    first_same = np.mean([a[0] == b[0] for a, b in zip(got, jgot)])
    assert first_same >= 0.95


def _assert_keys_equal_outside_ties(dists, keys, jdists, jkeys, distance):
    """Keys rank by rank, except across a run of ranks where the engines'
    distances are equal: exact f32 ties come back in each implementation's
    order, so a run's keys compare as sets. A run that reaches the last
    rank may go on past it, so there a key one engine returns and the
    other does not must lie at the run's distance itself:
    `distance(query, key)` is the port's exact re-rank of that one key."""
    dists, jdists = np.asarray(dists), np.asarray(jdists)
    np.testing.assert_array_equal(dists, jdists)
    for i, (row, jrow) in enumerate(zip(keys, jkeys)):
        d = jdists[i]
        start = 0
        while start < len(d):
            end = start + 1
            while end < len(d) and d[end] == d[start]:
                end += 1
            run, jrun = set(row[start:end]), set(jrow[start:end])
            if end < len(d):
                assert run == jrun, (i, start, row, jrow)
            else:
                for key in run ^ jrun:
                    gap = distance(i, key)
                    assert gap == pytest.approx(float(d[start]), rel=1e-6), (
                        i, key, gap, d[start])
            start = end


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_rescore_counters_equal_the_jax_engine(tmp_path,
                                                        monkeypatch, seed):
    """The adaptive re-rank skips the same candidates as the reference's,
    on a corpus where its bound does skip: tight clusters (spread 0.2 of
    centres 3 apart), so most of the 64 x k window lies far past the kth
    exact distance. The JAX engine builds the index and checkpoints it with
    its packed file; the port restarts from that data_dir without a build,
    so both hold the same codes, centroids and pq_err, and with every cell
    probed both rank the same candidates. rescored_rows and
    rescore_skipped_rows must then agree (up to candidates whose bound
    lies within rounding of the kth distance), and the keys be equal
    outside exact ties. Both engines re-rank on the same backend: the
    native one exactly when the reference's library is loaded, which an
    xdist worker that loses the reference's build race does not have."""
    rng = np.random.default_rng(seed)
    d = str(tmp_path / "db")
    kw = dict(shard_capacity=4096, ivf_delta_max=100_000)
    cents = rng.standard_normal((8, DIM)).astype(np.float32) * 3
    vecs = {f"k{i}": cents[i % 8]
            + rng.standard_normal(DIM).astype(np.float32) * 0.2
            for i in range(1500)}
    q = np.stack([vecs[f"k{i}"] for i in range(32)])
    q = q + rng.standard_normal(q.shape).astype(np.float32) * 0.05
    jeng = JaxEngine(pq_config(JaxConfig, **kw), data_dir=d)
    _jax_fill(jeng, vecs)
    jeng.flush()
    jeng.close()
    forbid_training(monkeypatch)
    forbid_build(monkeypatch)
    eng = engine(d, **kw)
    jeng = JaxEngine(pq_config(JaxConfig, **kw), data_dir=d)
    eng.rescore_backend = ("native" if jax_native.rescore_available()
                           else "numpy")
    for name in ("rescored_rows", "rescore_skipped_rows"):
        assert eng.stats[name] == jeng.stats[name] == 0
    dists, keys = eng.search_batch(q, 10)
    jdists, jkeys = jeng.search_batch(q, 10)
    assert eng.stats.get("ivf_packed_restores", 0) == 1
    assert eng._ivf.pq_err == pytest.approx(jeng._ivf.pq_err, rel=1e-6)

    def distance(i, key):
        e = eng.docstore.get(key)
        row = np.asarray([[eng._ivf_layout.row_of(e.shard, e.slot)]])
        return float(eng._exact_masked(
            q[i:i + 1], row, np.ones((1, 1), bool), eng._ivf_layout,
            eng.mirrors, native=eng.rescore_backend == "native")[0, 0])

    _assert_keys_equal_outside_ties(dists, keys, jdists, jkeys, distance)
    done, jdone = eng.stats["rescored_rows"], jeng.stats["rescored_rows"]
    skip = eng.stats["rescore_skipped_rows"]
    jskip = jeng.stats["rescore_skipped_rows"]
    window = 32 * 10 * eng.config.ivf_pq_rescore_overfetch
    assert done + skip == jdone + jskip == window   # the same candidates
    # a candidate whose bound lies within f32 rounding of the kth exact
    # distance may fall either way: the ADC sums are taken in another
    # order (the port adds subspaces in turn, the reference contracts a
    # one-hot), so at most 0.1% of the window may differ
    assert abs(skip - jskip) <= 0.001 * (done + skip), (skip, jskip)
    assert skip > done > 0      # the bound skips most of the window
    eng.close()
    jeng.close()
