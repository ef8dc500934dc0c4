"""tpuvdb_torch.mesh.replicated vs tpuvdb.mesh.replicated on the CPU.

A 2-D (repl, shards) mesh: the corpus split over `shards` and copied to
every replica group, the query batch split over `repl`. The JAX program
runs on the conftest's 8-device CPU mesh, the port on 8 CPU slots, with
the same seeded inputs, for (repl, shards) = (2, 4) and (4, 2). Rows equal
outside exact ties and distances within rtol 1e-5 ("exact" mode), and
against the numpy oracle; int8 with the per-slot re-rank equal to JAX's.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from test_torch_mesh_sharded import assert_rows_equal_outside_ties
from tpuvdb.mesh.replicated import create_mesh_2d as jax_mesh_2d
from tpuvdb.mesh.replicated import replicated_search as jax_replicated
from tpuvdb.mesh.replicated import shard_corpus_replicated as jax_place
from tpuvdb_torch.kernels.distance import numpy_oracle
from tpuvdb_torch.kernels.quant import quantize_rows_np
from tpuvdb_torch.mesh.replicated import (create_mesh_2d, replicated_search,
                                          shard_corpus_replicated)
from tpuvdb_torch.mesh.sharded import shard_rows

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("repl,shards", [(2, 4), (4, 2)])
def test_replicated_search_matches_jax(rng, repl, shards):
    rows, d, k = shards * 256, 32, 10
    corpus = rng.standard_normal((rows, d)).astype(np.float32)
    valid = np.ones(rows, bool)
    valid[17] = False
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    mesh = create_mesh_2d(repl, shards, devices=CPU8)
    assert mesh.shape == {"repl": repl, "shards": shards}
    dist, out = replicated_search(
        q, *shard_corpus_replicated(mesh, corpus, sq, valid), k=k,
        block_size=128, mesh=mesh, mode="exact")
    dist, out = dist.numpy(), out.numpy()
    assert dist.shape == (16, k) and 17 not in out
    jmesh = jax_mesh_2d(repl, shards)
    jd, jr = jax_replicated(
        jnp.asarray(q), *jax_place(jmesh, jnp.asarray(corpus),
                                   jnp.asarray(sq), jnp.asarray(valid)),
        k=k, block_size=128, mesh=jmesh, mode="exact")
    assert_rows_equal_outside_ties(dist, out, jd, jr)
    odist, oidx = numpy_oracle(q, corpus, valid, k)
    assert_rows_equal_outside_ties(dist, out, odist, oidx)
    # approx: every replica group's slice keeps the recall
    _, out = replicated_search(
        q, *shard_corpus_replicated(mesh, corpus, sq, valid), k=k,
        block_size=128, mesh=mesh)
    recall = np.mean([len(set(out.numpy()[i]) & set(oidx[i])) / k
                      for i in range(16)])
    assert recall >= 0.95, recall


def test_replica_groups_hold_full_copies(rng):
    """Each replica group answers its own slice from its own full copy."""
    mesh = create_mesh_2d(2, 4, devices=CPU8)
    rows, d = 4 * 128, 16
    corpus = rng.standard_normal((rows, d)).astype(np.float32)
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    placed = shard_corpus_replicated(mesh, corpus, sq, np.ones(rows, bool))
    # slot (r, s) holds shard s's rows, for both r
    for r in range(2):
        for s in range(4):
            np.testing.assert_array_equal(placed[0][r * 4 + s].numpy(),
                                          corpus[s * 128:(s + 1) * 128])
    dist, out = replicated_search(corpus[[100, 400]], *placed, k=1,
                                  block_size=128, mesh=mesh)
    assert out.numpy()[:, 0].tolist() == [100, 400]
    assert (dist.numpy()[:, 0] < 1e-2).all()
    with pytest.raises(ValueError, match="not divisible by repl axis"):
        replicated_search(corpus[:3], *placed, k=1, block_size=128,
                          mesh=mesh)
    with pytest.raises(ValueError, match="need 10 devices"):
        create_mesh_2d(2, 5, devices=CPU8)


def test_replicated_int8_rescored_matches_jax(rng):
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax

    mesh = create_mesh_2d(2, 4, devices=CPU8)
    rows, d, k = 4 * 128, 32, 5
    corpus = rng.standard_normal((rows, d)).astype(np.float32)
    ci8, scales = quantize_rows_np(corpus)
    stored = ci8.astype(np.float32) * scales[:, None]
    sq = np.einsum("nd,nd->n", stored, stored).astype(np.float32)
    ones = np.ones(rows, bool)
    q = corpus[:6] + 0.1 * rng.standard_normal((6, d)).astype(np.float32)
    dist, out = replicated_search(
        q, *shard_corpus_replicated(mesh, ci8, sq, ones), k=k,
        block_size=128, mesh=mesh, row_scales=shard_rows(mesh, scales),
        rescore_fetch=8)
    jmesh = jax_mesh_2d(2, 4)
    jd, jr = jax_replicated(
        jnp.asarray(q), *jax_place(jmesh, jnp.asarray(ci8), jnp.asarray(sq),
                                   jnp.asarray(ones)),
        k=k, block_size=128, mesh=jmesh,
        row_scales=jax.device_put(jnp.asarray(scales),
                                  NamedSharding(jmesh, P("shards"))),
        rescore_fetch=8)
    assert_rows_equal_outside_ties(dist.numpy(), out.numpy(), jd, jr)
    true = ((q[:, None, :] - stored[out.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(dist.numpy(), true, rtol=1e-5, atol=1e-4)
