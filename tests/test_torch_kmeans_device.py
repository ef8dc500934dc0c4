"""The training sums (`kernels.kmeans.segment_add_`): sequential
`index_add_` on the host, a sorted accumulation on the card, so that
k-means and PQ training give the same tables in every run and in every
process of a mesh. The card cases need no JAX, so they run with
--noconftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kmeans_device.py
"""

import numpy as np
import pytest
import torch

from tpuvdb_torch.kernels import pq as pqk
from tpuvdb_torch.kernels.kmeans import kmeans, segment_add_


def _rows(seed, n=20_000, d=64, k=48):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    return x, rng.integers(0, k, n), k


def test_segment_add_on_the_host_is_index_add():
    """Bit for bit the sequential `index_add_` the CPU parity tests hold
    against the reference, and the numpy segment sums within f32
    rounding."""
    x, a, k = _rows(0)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    got = segment_add_(torch.zeros(k, x.shape[1]), at, xt)
    want = torch.zeros(k, x.shape[1]).index_add_(0, at, xt)
    assert torch.equal(got, want)
    ref = np.zeros((k, x.shape[1]))
    np.add.at(ref, a, x.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_card_training_is_the_same_in_every_run():
    """The segment sums, k-means and PQ training on the card: two runs on
    the same inputs give the same tables bit for bit, and the sums agree
    with the host's within f32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, a, k = _rows(1)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    sums = [segment_add_(torch.zeros(k, x.shape[1], device="cuda"),
                         at.cuda(), xt.cuda()) for _ in range(2)]
    assert torch.equal(sums[0], sums[1])
    host = segment_add_(torch.zeros(k, x.shape[1]), at, xt)
    torch.testing.assert_close(sums[0].cpu(), host, rtol=1e-4, atol=1e-3)
    valid = np.ones(len(x), bool)
    cents = [kmeans(x, valid, nlist=k, iters=5, block_size=4096, seed=3,
                    device="cuda")[0] for _ in range(2)]
    np.testing.assert_array_equal(cents[0], cents[1])
    books = [np.asarray(pqk.train_pq(x, m_subq=8, seed=3, device="cuda"))
             for _ in range(2)]
    np.testing.assert_array_equal(books[0], books[1])
