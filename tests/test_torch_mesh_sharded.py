"""tpuvdb_torch.mesh (mesh, sharded search) vs tpuvdb.mesh on the CPU.

The JAX functions run on the conftest's 8-device CPU mesh, the port on an
8-slot CPU mesh (`create_mesh(devices=["cpu"] * 8)`), on the same seeded
numpy inputs. Tolerances:
* "exact" mode: rows equal except inside exact distance ties (a gap
  within 1e-6 relative), distances within rtol 1e-5 (atol 1e-4 near 0).
* "approx" (the bucketed scan's plain twin here; JAX's approx_max_k is
  exact on the CPU): recall@10 >= 0.95 against the numpy oracle.
* int8 with the per-slot exact re-rank: the JAX rows, and distances
  within 1e-4 of the dequantized oracle's.
The merge keeps jax.lax.top_k's tie rule (the lower slot first). The dry
run of every mesh path (mesh/dryrun.py) passes on CPU slots. The card's
test of the launchers' device switch is in test_torch_mesh_device.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tpuvdb.index.exact import DeviceExactIndex as JaxIndex
from tpuvdb.index.layout import ShardMirror as JaxMirror
from tpuvdb.mesh.mesh import create_mesh as jax_create_mesh
from tpuvdb.mesh.sharded import sharded_search as jax_sharded_search
from tpuvdb_torch.index.exact import DeviceExactIndex
from tpuvdb_torch.index.layout import ShardMirror, StackedLayout
from tpuvdb_torch.kernels.distance import numpy_oracle
from tpuvdb_torch.kernels.quant import quantize_rows_np
from tpuvdb_torch.mesh import create_mesh, sharded_search
from tpuvdb_torch.mesh.sharded import merge_topk, shard_rows

CPU8 = ["cpu"] * 8


def _put_jax(mesh, *arrays):
    out = []
    for a in arrays:
        spec = P("shards", None) if a.ndim == 2 else P("shards")
        out.append(jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)))
    return out


def assert_rows_equal_outside_ties(got_d, got_r, want_d, want_r):
    """Rows equal wherever the reference's distance is not tied with a
    neighbour's; distances within rtol 1e-5."""
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
    tie = np.zeros(want_d.shape, bool)
    gap = np.abs(np.diff(want_d, axis=1)) <= 1e-6 * np.maximum(
        np.abs(want_d[:, 1:]), 1.0)
    tie[:, 1:] |= gap
    tie[:, :-1] |= gap
    got_r, want_r = np.asarray(got_r), np.asarray(want_r)
    assert (got_r[~tie] == want_r[~tie]).all()


def _corpus(rng, rows, d, dead=(5,)):
    corpus = rng.standard_normal((rows, d)).astype(np.float32)
    valid = np.ones(rows, bool)
    valid[list(dead)] = False
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    return corpus, sq, valid


def test_mesh_slots_and_devices():
    mesh = create_mesh(devices=CPU8)
    assert mesh.size == 8 and mesh.shape == {"shards": 8}
    assert mesh.axis_names == ("shards",) and mesh.local_slots() == list(
        range(8))
    assert create_mesh(n_devices=3, devices=CPU8).size == 3
    with pytest.raises(ValueError, match="need 9 devices"):
        create_mesh(n_devices=9, devices=CPU8)
    if not torch.cuda.is_available():  # devices=None means the cards
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_mesh()
    # a mesh of one slot takes the single-device path on that slot
    idx = DeviceExactIndex(StackedLayout(2, 128, 8),
                           mesh=create_mesh(devices=["cpu"]))
    assert idx.mesh is None and isinstance(idx.vectors, torch.Tensor)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_sharded_search_matches_jax(rng, mode):
    block, d, k = 128, 32, 10
    rows = 8 * block * 2
    corpus, sq, valid = _corpus(rng, rows, d)
    q = rng.standard_normal((6, d)).astype(np.float32)
    mesh = create_mesh(devices=CPU8)
    dist, out = sharded_search(q, *(shard_rows(mesh, a)
                                    for a in (corpus, sq, valid)),
                               k=k, block_size=block, mesh=mesh, mode=mode)
    dist, out = dist.numpy(), out.numpy()
    assert 5 not in out
    odist, oidx = numpy_oracle(q, corpus, valid, k)
    if mode == "exact":
        jmesh = jax_create_mesh()
        jd, jr = jax_sharded_search(q, *_put_jax(jmesh, corpus, sq, valid),
                                    k=k, block_size=block, mesh=jmesh,
                                    mode="exact")
        assert_rows_equal_outside_ties(dist, out, jd, jr)
        assert_rows_equal_outside_ties(dist, out, odist, oidx)
    else:
        recall = np.mean([len(set(out[i]) & set(oidx[i])) / k
                          for i in range(len(q))])
        assert recall >= 0.95, recall


def test_sharded_search_checks_the_references_rules(rng):
    mesh = create_mesh(devices=CPU8)
    with pytest.raises(ValueError, match="not divisible by mesh size"):
        shard_rows(mesh, np.zeros((100, 4), np.float32))
    corpus, sq, valid = _corpus(rng, 8 * 200, 8)
    parts = [shard_rows(mesh, a) for a in (corpus, sq, valid)]
    with pytest.raises(ValueError, match="not a multiple of block"):
        sharded_search(corpus[:2], *parts, k=3, block_size=128, mesh=mesh,
                       mode="exact")


def test_merge_keeps_the_lower_slot_on_a_tie(rng):
    """The same row stored in every slot: equal distances, and the merge
    returns them lower slot first, as jax.lax.top_k does."""
    d, per = 16, 128
    row = rng.standard_normal(d).astype(np.float32)
    corpus = rng.standard_normal((8 * per, d)).astype(np.float32) + 20.0
    corpus[np.arange(8) * per + 7] = row
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    valid = np.ones(len(corpus), bool)
    mesh = create_mesh(devices=CPU8)
    dist, out = sharded_search(row[None], *(shard_rows(mesh, a)
                                            for a in (corpus, sq, valid)),
                               k=8, block_size=per, mesh=mesh, mode="exact")
    jmesh = jax_create_mesh()
    _, jr = jax_sharded_search(row[None], *_put_jax(jmesh, corpus, sq, valid),
                               k=8, block_size=per, mesh=jmesh, mode="exact")
    want = np.arange(8) * per + 7
    np.testing.assert_array_equal(out.numpy()[0], want)
    np.testing.assert_array_equal(np.asarray(jr)[0], want)
    # merge_topk alone: equal scores keep the earlier part first
    parts = [(torch.zeros(1, 2), torch.tensor([[0, 1]])),
             (torch.zeros(1, 2), torch.tensor([[0, 1]]))]
    _, r = merge_topk(parts, [0, 100], 3, torch.device("cpu"))
    assert r.tolist() == [[0, 1, 100]]


def _fill_mirrors(rng, cls, n_shards, dim, per_shard):
    mirrors = [cls(dim=dim, capacity=4096, init_cap=256, block=128)
               for _ in range(n_shards)]
    stored = {}
    for s, m in enumerate(mirrors):
        for _ in range(per_shard(s)):
            slot = m.alloc()
            v = rng.standard_normal(dim).astype(np.float32)
            m.write(slot, v)
            stored[(s, slot)] = v
    return mirrors, stored


@pytest.mark.parametrize("n_shards", [4, 3])  # 3 shards: coprime with 8
def test_device_index_end_to_end_with_mesh(n_shards):
    """Build, updates and deletes on an 8-slot mesh, step for step beside
    the JAX index on its 8-device mesh."""
    dim = 16
    mirrors_j, stored = _fill_mirrors(np.random.default_rng(1), JaxMirror,
                                      n_shards, dim, lambda s: 100 + 17 * s)
    mirrors_t, _ = _fill_mirrors(np.random.default_rng(1), ShardMirror,
                                 n_shards, dim, lambda s: 100 + 17 * s)
    jidx = JaxIndex.build(mirrors_j, block_size=128, mesh=jax_create_mesh(),
                          search_mode="exact")
    idx = DeviceExactIndex.build(mirrors_t, block_size=128,
                                 mesh=create_mesh(devices=CPU8),
                                 search_mode="exact", device="cpu")
    assert idx.layout == StackedLayout(**vars(jidx.layout))
    assert idx.layout.total_rows % (128 * 8) == 0
    assert idx.nbytes() == jidx.nbytes()
    rng = np.random.default_rng(2)
    q = rng.standard_normal((5, dim)).astype(np.float32)

    def same():
        d_t, r_t = idx.search(q, k=6)
        d_j, r_j = jidx.search(q, k=6)
        assert_rows_equal_outside_ties(d_t, r_t, d_j, r_j)

    same()
    target = stored[(2, 42)]
    _, rows = idx.search(target[None], k=3)
    assert idx.layout.shard_slot_of(int(rows[0, 0])) == (2, 42)
    # an update in another shard's range, then a delete
    row = idx.layout.row_of(1, 300)
    for ix in (idx, jidx):
        ix.apply_updates(np.array([row], np.int32), target[None],
                         np.array([True]))
    same()
    _, rows = idx.search(target[None], k=2)
    assert {int(r) for r in rows[0]} == {row, idx.layout.row_of(2, 42)}
    for ix in (idx, jidx):
        ix.apply_deletes(np.array([idx.layout.row_of(2, 42)], np.int32))
    same()
    _, rows = idx.search(target[None], k=2)
    assert idx.layout.row_of(2, 42) not in rows[0]


def test_sharded_int8_rescored_matches_dequant_oracle(rng):
    block, d, k = 128, 64, 10
    rows = 8 * block
    corpus = rng.standard_normal((rows, d)).astype(np.float32)
    ci8, scales = quantize_rows_np(corpus)
    stored = ci8.astype(np.float32) * scales[:, None]
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    valid = np.ones(rows, bool)
    valid[9] = False
    q = rng.standard_normal((8, d)).astype(np.float32)
    mesh = create_mesh(devices=CPU8)
    dist, out = sharded_search(
        q, *(shard_rows(mesh, a) for a in (ci8, sq, valid)), k=k,
        block_size=block, mesh=mesh, row_scales=shard_rows(mesh, scales),
        rescore_fetch=32)
    dist, out = dist.numpy(), out.numpy()
    jmesh = jax_create_mesh()
    jd, jr = jax_sharded_search(
        q, *_put_jax(jmesh, ci8, sq, valid), k=k, block_size=block,
        mesh=jmesh, row_scales=_put_jax(jmesh, scales)[0], rescore_fetch=32)
    assert 9 not in out
    assert_rows_equal_outside_ties(dist, out, jd, jr)
    _, oidx = numpy_oracle(q, stored, valid, k)
    overlap = np.mean([len(set(out[i]) & set(oidx[i])) / k
                       for i in range(len(q))])
    assert overlap >= 0.9, overlap
    true = ((q[:, None, :] - stored[out]) ** 2).sum(-1)
    np.testing.assert_allclose(dist, true, rtol=1e-5, atol=1e-4)
    # without the re-rank: the raw int8 scan of every slot, JAX's rows
    dist, out = sharded_search(
        q, *(shard_rows(mesh, a) for a in (ci8, sq, valid)), k=k,
        block_size=block, mesh=mesh, row_scales=shard_rows(mesh, scales))
    jd, jr = jax_sharded_search(
        q, *_put_jax(jmesh, ci8, sq, valid), k=k, block_size=block,
        mesh=jmesh, row_scales=_put_jax(jmesh, scales)[0])
    assert_rows_equal_outside_ties(dist.numpy(), out.numpy(), jd, jr)


@pytest.mark.parametrize("n", [4, 2])
def test_dryrun_on_cpu_slots(n):
    """The port's dry run (every mesh path against its numpy oracle) on
    CPU slots; on the card chip_smoke.py runs it on four slots."""
    from tpuvdb_torch.mesh.dryrun import dryrun_multichip

    out = dryrun_multichip(n, devices=["cpu"] * n)
    assert out["flat_sharded"]["slots_hit"] > 1
    assert ("replicated" in out) == (n >= 4)
