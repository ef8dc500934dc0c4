"""The plain reference at a tiny size against brute numpy, and the TF32
rounding of the control."""

import numpy as np
import pytest
import torch

from perfbench.registry import Registry

knn = Registry().reference("knn")


def brute(q, x, k):
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64))
         ** 2).sum(-1)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d, idx, axis=1)


@pytest.mark.parametrize("n", [50, 70_000])
def test_exact_topk_matches_brute(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    ids, d = knn.exact_topk(q, x, 5)
    bids, bd = brute(q, x, 5)
    np.testing.assert_array_equal(ids, bids)
    np.testing.assert_allclose(d, bd, rtol=1e-12)


def test_distances64_marks_foreign_ids():
    x = np.eye(3, dtype=np.float32)
    q = np.zeros((1, 3), np.float32)
    d = knn.distances64(q, x, np.array([[0, 2, -1, 3]]))
    np.testing.assert_array_equal(d, [[1.0, 1.0, np.inf, np.inf]])


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -11 + 2 ** -20, -3.0])
    got = knn.round_tf32(x).tolist()
    # a tie goes to the even mantissa: 1 + 2^-11 -> 1, 1 + 3*2^-11 -> 1 + 2^-9
    assert got == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0]


def test_tf32_control_answers_differ_from_f32():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((400, 64)).astype(np.float32)
    q = rng.standard_normal((20, 64)).astype(np.float32)
    _, d32 = knn.exact_topk(q, x, 4)
    ids, dtf = knn.exact_topk(q, x, 4, precision="tf32")
    exact = knn.distances64(q, x, ids)
    assert np.abs(dtf - exact).max() > 1e-4
    assert np.abs(d32 - brute(q, x, 4)[1]).max() < 1e-9
