"""The port's bucketed scan vs tpuvdb.kernels.pallas_scan.

`scan_candidates_plain` (the plain PyTorch version of the CUDA kernel) is
held against `pallas_candidates(..., interpret=True)`, as
tests/test_pallas_scan.py runs it on the CPU: candidate rows identical,
candidate scores within rtol 1e-4 (f32 and bf16 products are exact in f32 in
both; only the summation order differs). The JAX kernel needs the corpus to
be a multiple of block_rows and the queries of query_tile, so its inputs
are padded with dead rows / zero queries; a row's bucket is its global row
id mod n_buckets in both, so padding moves nothing.

The CUDA kernel itself cannot run here; `test_kernel_matches_plain_on_card`
holds it against the plain version when a card is present. The card test
needs no JAX (only the `ref` fixture imports it), so it runs there with
no conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_scan.py
"""

import types

import numpy as np
import pytest
import torch

from tpuvdb_torch.kernels import scan
from tpuvdb_torch.kernels.distance import l2sq_topk, numpy_oracle, scan_max_k

SCORE_RTOL = 1e-4
NEG_INF = scan.NEG_INF


@pytest.fixture()
def ref():
    """The JAX reference: jax.numpy and tpuvdb.kernels.pallas_scan."""
    import jax.numpy as jnp

    from tpuvdb.kernels import pallas_scan

    assert pallas_scan.NEG_INF == NEG_INF
    return types.SimpleNamespace(jnp=jnp, scan=pallas_scan)


def _inputs(rng, n, d, nq, n_dead):
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_dead, replace=False)] = False
    neg_mask = np.where(valid, 0.0, NEG_INF).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    return q, corpus, sq, valid, neg_mask


def _jax_candidates(ref, q, corpus, sq, neg_mask, n_buckets, block_rows, qt,
                    dtype="float32"):
    """pallas_candidates on padded inputs, cut back to the real queries."""
    jnp = ref.jnp
    n, d = corpus.shape
    pad_n = (-n) % block_rows
    pad_q = (-q.shape[0]) % qt
    cp = np.concatenate([corpus, np.zeros((pad_n, d), np.float32)])
    sp = np.concatenate([sq, np.zeros(pad_n, np.float32)])
    mp = np.concatenate([neg_mask, np.full(pad_n, NEG_INF, np.float32)])
    qp = np.concatenate([q, np.zeros((pad_q, d), np.float32)])
    val, idx = ref.scan.pallas_candidates(
        jnp.asarray(qp), jnp.asarray(cp, dtype=getattr(jnp, dtype)),
        jnp.asarray(sp)[None], jnp.asarray(mp)[None],
        block_rows=block_rows, n_buckets=n_buckets,
        query_tile=qt, sub_rows=min(block_rows, 512), interpret=True)
    return np.asarray(val)[: q.shape[0]], np.asarray(idx)[: q.shape[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,nq,n_buckets", [(2048, 64, 8, 128),
                                              (1800, 96, 5, 256)])
def test_plain_matches_pallas_candidates(rng, ref, dtype, n, d, nq,
                                         n_buckets):
    q, corpus, sq, valid, neg_mask = _inputs(rng, n, d, nq, n_dead=60)
    tdt = getattr(torch, dtype)
    val, idx = scan.scan_candidates(
        torch.from_numpy(q), torch.from_numpy(corpus).to(tdt),
        torch.from_numpy(sq), torch.from_numpy(neg_mask), n_buckets)
    jval, jidx = _jax_candidates(ref, q, corpus, sq, neg_mask, n_buckets,
                                 block_rows=512, qt=8, dtype=dtype)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(val.numpy(), jval, rtol=SCORE_RTOL)
    dead = set(np.flatnonzero(~valid).tolist())
    assert not dead & set(idx.numpy().ravel().tolist())


def test_plain_tie_keeps_lower_row(rng, ref):
    """Rows r and r + n_buckets share a bucket; identical vectors give
    identical scores, and the strict `>` keeps the lower row in both."""
    n, d, nb = 1024, 32, 128
    q, corpus, sq, valid, neg_mask = _inputs(rng, n, d, 8, n_dead=0)
    for r in (3, 77, 500):
        for twin in (r + nb, r + 3 * nb):
            corpus[twin] = corpus[r]
            sq[twin] = sq[r]
    # a dead twin below a live one: the live row must win
    corpus[900 - nb] = corpus[900]
    sq[900 - nb] = sq[900]
    neg_mask[900 - nb] = NEG_INF
    val, idx = scan.scan_candidates_plain(
        torch.from_numpy(q), torch.from_numpy(corpus), torch.from_numpy(sq),
        torch.from_numpy(neg_mask), nb)
    jval, jidx = _jax_candidates(ref, q, corpus, sq, neg_mask, nb,
                                 block_rows=256, qt=8)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    idx = idx.numpy()
    for r in (3, 77, 500):
        assert not np.isin([r + nb, r + 3 * nb], idx).any()
    assert not (idx == 900 - nb).any()


def test_empty_buckets_and_all_dead():
    q = np.ones((2, 8), np.float32)
    corpus = np.ones((100, 8), np.float32)
    sq = np.full(100, 8.0, np.float32)
    mask = np.zeros(100, np.float32)
    mask[::2] = NEG_INF
    val, idx = scan.scan_candidates_plain(
        torch.from_numpy(q), torch.from_numpy(corpus), torch.from_numpy(sq),
        torch.from_numpy(mask), 256)
    idx = idx.numpy()
    assert (idx[:, 100:] == -1).all()          # buckets past N stay empty
    assert (idx[:, 0:100:2] == -1).all()       # dead rows never enter
    assert (idx[:, 1:100:2] == np.arange(1, 100, 2)).all()
    assert (val.numpy()[:, 100:] == NEG_INF).all()


def test_l2sq_topk_pallas_mode_matches_pallas_l2sq_topk(rng, ref):
    jnp = ref.jnp
    n, d, k = 2048, 64, 10
    q, corpus, sq, valid, _ = _inputs(rng, n, d, 6, n_dead=30)
    for mode in ("pallas", "approx"):
        dist, idx = l2sq_topk(torch.from_numpy(q), torch.from_numpy(corpus),
                              torch.from_numpy(sq), torch.from_numpy(valid),
                              k=k, mode=mode)
        jdist, jidx = ref.scan.pallas_l2sq_topk(
            jnp.asarray(q), jnp.asarray(corpus), jnp.asarray(sq),
            jnp.asarray(valid), k=k, block_rows=1024, n_buckets=512,
            query_tile=8, sub_rows=512, interpret=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                                   rtol=1e-5)


def test_l2sq_topk_pads_k_beyond_buckets(rng):
    """The scan called directly returns at most n_buckets hits and pads
    the rest; the l2sq_topk dispatcher never routes such a k to it (k=600
    is past scan_max_k), so "approx" returns all live rows there."""
    q, corpus, sq, valid, _ = _inputs(rng, 700, 16, 3, n_dead=0)
    args = (torch.from_numpy(q), torch.from_numpy(corpus),
            torch.from_numpy(sq), torch.from_numpy(valid))
    dist, idx = scan.scan_l2sq_topk(*args, k=600, n_buckets=512)
    assert idx.shape == (3, 600)
    assert (idx[:, 512:] == -1).all() and torch.isinf(dist[:, 512:]).all()
    assert (idx[:, :512] >= 0).all()
    assert scan_max_k(0.95) == 51 and scan_max_k(0.99) == 10
    dist, idx = l2sq_topk(*args, k=600, mode="approx", recall_target=0.95)
    _, want = numpy_oracle(q, corpus, valid, 600)
    np.testing.assert_array_equal(idx.numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((10, 4), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        scan.scan_candidates(torch.zeros((1, 4)), x, torch.zeros(10),
                             torch.zeros(10))
    meta = torch.zeros((10, 4), device="meta")
    with pytest.raises(ValueError):
        scan.scan_candidates(torch.zeros((1, 4), device="meta"), meta,
                             torch.zeros(10, device="meta"),
                             torch.zeros(10, device="meta"))


@pytest.mark.parametrize("n_buckets", [0, 64, 100, 192, 500])
def test_wrapper_rejects_bucket_counts_the_kernel_does_not_take(n_buckets):
    """A kernel block owns 128 consecutive buckets: other counts raise, on
    either device, before any work; multiples of 128 go through."""
    q, x = torch.zeros((2, 8)), torch.zeros((300, 8))
    with pytest.raises(ValueError, match="multiple of 128"):
        scan.scan_candidates(q, x, torch.zeros(300), torch.zeros(300),
                             n_buckets)
    meta = torch.zeros((300, 8), device="meta")
    with pytest.raises(ValueError, match="multiple of 128"):
        scan.scan_candidates(torch.zeros((2, 8), device="meta"), meta,
                             torch.zeros(300, device="meta"),
                             torch.zeros(300, device="meta"), n_buckets)
    for ok in (128, 256, 512):
        val, idx = scan.scan_candidates(q, x, torch.zeros(300),
                                        torch.zeros(300), ok)
        assert val.shape == idx.shape == (2, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nq,d,offset", [
    (torch.float32, 37, 128, 0),
    (torch.bfloat16, 37, 128, 0),
    (torch.float32, 1, 128, 0),
    # the query tiles 8, 32, 64 and 128 wide, and a batch of two tiles
    (torch.float32, 7, 128, 0),
    (torch.float32, 64, 128, 0),
    (torch.float32, 200, 128, 0),
    (torch.bfloat16, 1, 128, 0),
    (torch.bfloat16, 7, 128, 0),
    (torch.bfloat16, 64, 128, 0),
    (torch.bfloat16, 200, 128, 0),
    # off TMA's layouts (a row stride or a base off 16 bytes: the
    # producer's element-wise copy), with a partial last depth slice: d=100
    # (f32 rows 400 bytes, still TMA; bf16 200 bytes), 99, and a corpus
    # pointer `offset` elements past a 16-byte boundary
    (torch.float32, 37, 100, 0),
    (torch.float32, 37, 99, 0),
    (torch.float32, 37, 128, 1),
    (torch.bfloat16, 37, 100, 0),
    (torch.bfloat16, 37, 96, 1),
    (torch.float32, 200, 99, 0),
    (torch.bfloat16, 200, 100, 0),
])
def test_kernel_matches_plain_on_card(dtype, nq, d, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernel has no CPU mode")
    rng = np.random.default_rng(0)
    q, corpus, sq, valid, neg_mask = _inputs(rng, 70_001, d, nq, n_dead=500)
    flat = torch.zeros(corpus.size + offset, dtype=dtype, device="cuda")
    x = flat[offset:].view(corpus.shape)
    x.copy_(torch.from_numpy(corpus))
    sq = (x.float() ** 2).sum(dim=1)
    args = (torch.from_numpy(q).cuda(), x, sq,
            torch.from_numpy(neg_mask).cuda())
    before = scan.LAUNCHES
    val, idx = scan.scan_candidates(*args, n_buckets=512)
    assert scan.LAUNCHES == before + 1
    pval, pidx = scan.scan_candidates_plain(*args, n_buckets=512)
    torch.cuda.synchronize()
    assert (idx == pidx).float().mean().item() >= 0.999
    torch.testing.assert_close(val, pval, rtol=1e-5, atol=1e-3)
