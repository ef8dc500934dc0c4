"""tpuvdb_torch distance/top-k ops vs the JAX functions and the numpy oracle.

Mirrors tests/test_kernels_distance.py. Inputs come from a numpy seed and go
to both packages as numpy arrays. Tolerances: f32 distances agree with the
JAX functions to rtol 1e-5 (both score in full f32; only the summation
order differs) and with the float64 oracle to rtol 3e-3 / atol 1e-2, as in
the reference's own test; bf16 corpora within rtol 0.05 / atol 0.5 of the
oracle, as there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvdb.kernels import distance as jd
from tpuvdb.kernels import topk as jtk
from tpuvdb_torch.kernels import distance as td
from tpuvdb_torch.kernels import topk as ttk

RTOL = 1e-5


def make_corpus(rng, n, d, n_valid=None):
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.zeros(n, dtype=bool)
    valid[: n if n_valid is None else n_valid] = True
    sq = np.sum(corpus * corpus, axis=1).astype(np.float32)
    return corpus, sq, valid


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,d,k,block", [(1024, 64, 10, 256),
                                         (2048, 128, 5, 512)])
def test_blockwise_matches_jax_and_oracle(rng, n, d, k, block):
    corpus, sq, valid = make_corpus(rng, n, d)
    valid[rng.choice(n, 40, replace=False)] = False
    q = rng.standard_normal((16, d)).astype(np.float32)
    dist, idx = td.l2sq_topk_blockwise(t(q), t(corpus), t(sq), t(valid),
                                       k=k, block_size=block)
    jdist, jidx = jd.l2sq_topk_blockwise(q, corpus, sq, valid, k=k,
                                         block_size=block)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=RTOL)
    odist, oidx = jd.numpy_oracle(q, corpus, valid, k)
    np.testing.assert_allclose(dist.numpy(), odist, rtol=3e-3, atol=1e-2)
    np.testing.assert_array_equal(idx.numpy(), oidx)


def test_full_matches_jax_and_blockwise(rng):
    corpus, sq, valid = make_corpus(rng, 512, 32)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    d1, i1 = td.l2sq_full(t(q), t(corpus), t(sq), t(valid), k=7)
    d2, i2 = td.l2sq_topk_blockwise(t(q), t(corpus), t(sq), t(valid), k=7,
                                    block_size=128)
    jdist, jidx = jd.l2sq_full(q, corpus, sq, valid, k=7)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d1.numpy(), np.asarray(jdist), rtol=RTOL)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=RTOL)


def test_soft_deleted_slots_excluded(rng):
    corpus, sq, valid = make_corpus(rng, 256, 16)
    q = corpus[:4].copy()  # exact matches at rows 0..3
    valid[0] = False
    dist, idx = td.l2sq_full(t(q), t(corpus), t(sq), t(valid), k=3)
    assert 0 not in idx[0].tolist()
    assert idx[1, 0].item() == 1
    assert dist[1, 0].item() < 1e-3


def test_empty_and_partial_corpus(rng):
    corpus, sq, valid = make_corpus(rng, 128, 16, n_valid=2)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    dist, idx = td.l2sq_full(t(q), t(corpus), t(sq), t(valid), k=5)
    jdist, jidx = jd.l2sq_full(q, corpus, sq, valid, k=5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx[:, :2] >= 0).all() and (idx[:, 2:] == -1).all()
    assert torch.isinf(dist[:, 2:]).all()
    dist, idx = td.l2sq_full(t(q), t(corpus), t(sq),
                             t(np.zeros_like(valid)), k=5)
    assert (idx == -1).all()


def test_bfloat16_corpus_matches_jax(rng):
    corpus, sq, valid = make_corpus(rng, 1024, 64)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    bf = t(corpus).to(torch.bfloat16)
    dist, idx = td.l2sq_topk_blockwise(t(q), bf, t(sq), t(valid), k=10,
                                       block_size=256)
    jdist, jidx = jd.l2sq_topk_blockwise(
        q, jnp.asarray(corpus, dtype=jnp.bfloat16), sq, valid, k=10,
        block_size=256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=RTOL)
    odist, _ = jd.numpy_oracle(q, corpus, valid, k=10)
    np.testing.assert_allclose(dist.numpy(), odist, rtol=0.05, atol=0.5)


def test_mask_and_merge_match_jax(rng):
    neg = rng.standard_normal((6, 40)).astype(np.float32)
    valid = rng.random((6, 40)) > 0.3
    np.testing.assert_array_equal(
        ttk.mask_scores(t(neg), t(valid)).numpy(),
        np.asarray(jtk.mask_scores(neg, valid)))
    a_neg = -np.sort(rng.random((6, 8)).astype(np.float32), axis=1)
    a_idx = rng.integers(0, 1000, (6, 8)).astype(np.int32)
    b_neg = rng.standard_normal((6, 20)).astype(np.float32)
    b_idx = rng.integers(1000, 2000, (6, 20)).astype(np.int32)
    tn, ti = ttk.merge_topk(t(a_neg), t(a_idx), t(b_neg), t(b_idx), 8)
    jn, ji = jtk.merge_topk(a_neg, a_idx, b_neg, b_idx, 8)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    en, ei = ttk.empty_topk(3, 4)
    jen, jei = jtk.empty_topk(3, 4)
    np.testing.assert_array_equal(en.numpy(), np.asarray(jen))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))
    fd, fi = ttk.finalize(tn, ti)
    jfd, jfi = jtk.finalize(jn, ji)
    np.testing.assert_array_equal(fd.numpy(), np.asarray(jfd))


def test_exact_dispatch_matches_jax(rng):
    corpus, sq, valid = make_corpus(rng, 4096, 32)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    for block in (1024, 8192):  # blockwise, then the single-GEMM path
        dist, idx = td.l2sq_topk(t(q), t(corpus), t(sq), t(valid), k=10,
                                 mode="exact", block_size=block)
        jdist, jidx = jd.l2sq_topk(q, corpus, sq, valid, k=10, mode="exact",
                                   block_size=block)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                                   rtol=RTOL)
    with pytest.raises(ValueError):
        td.l2sq_topk(t(q), t(corpus), t(sq), t(valid), k=10, mode="bogus")


def test_numpy_oracle_is_the_reference_one(rng):
    corpus, _, valid = make_corpus(rng, 300, 8, n_valid=250)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    a = td.numpy_oracle(q, corpus, valid, 12)
    b = jd.numpy_oracle(q, corpus, valid, 12)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
