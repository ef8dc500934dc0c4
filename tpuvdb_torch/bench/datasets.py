"""Benchmark corpora: the port's copy of tpuvdb.bench.datasets (numpy).

Real ANN benchmark sets use the TexMex fvecs/bvecs formats (SIFT1M:
sift_base.fvecs etc.; Deep: .fvecs); loaders below read them when a
dataset directory is available (scripts/download_dataset.py fetches them
in egress-enabled environments; set TPUVDB_DATASET_DIR). Synthetic
generators cover zero-egress runs: `clustered=True` produces data with
cluster structure (IVF-meaningful), else i.i.d. gaussian (a worst case for
any pruning index — nearest neighbors are spread uniformly over cells).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def load_fvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """TexMex .fvecs: per row [int32 dim][dim * float32]."""
    raw = np.fromfile(path, dtype=np.int32)
    dim = raw[0]
    row_ints = dim + 1
    n = len(raw) // row_ints
    if max_rows:
        n = min(n, max_rows)
    mat = raw[: n * row_ints].reshape(n, row_ints)[:, 1:]
    return mat.view(np.float32).copy()


def load_bvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """TexMex .bvecs: per row [int32 dim][dim * uint8]."""
    with open(path, "rb") as f:
        dim = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
    row_bytes = 4 + dim
    raw = np.fromfile(path, dtype=np.uint8)
    n = len(raw) // row_bytes
    if max_rows:
        n = min(n, max_rows)
    mat = raw[: n * row_bytes].reshape(n, row_bytes)[:, 4:]
    return mat.astype(np.float32)


def sift1m_if_available(max_rows: Optional[int] = None):
    """Returns (base, queries) from a local SIFT1M directory, or None."""
    root = os.environ.get("TPUVDB_DATASET_DIR", "datasets")
    base = os.path.join(root, "sift", "sift_base.fvecs")
    qry = os.path.join(root, "sift", "sift_query.fvecs")
    if os.path.isfile(base) and os.path.isfile(qry):
        return load_fvecs(base, max_rows), load_fvecs(qry, 1000)
    return None


def synthetic_corpus(
    n: int, dim: int, seed: int = 0,
    clustered: bool = False, n_clusters: int = 1024, spread: float = 0.4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (corpus (n, dim) f32, queries (1024, dim) f32)."""
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3
        assign = rng.integers(0, n_clusters, n)
        corpus = centers[assign] + spread * rng.standard_normal(
            (n, dim)).astype(np.float32)
        qi = rng.choice(n, 1024, replace=n < 1024)
        queries = corpus[qi] + 0.05 * rng.standard_normal(
            (1024, dim)).astype(np.float32)
    else:
        corpus = rng.standard_normal((n, dim), dtype=np.float32)
        queries = rng.standard_normal((1024, dim), dtype=np.float32)
    return corpus, queries


def adversarial_corpus(n: int, dim: int,
                       rng: np.random.Generator) -> np.ndarray:
    """The scan benchmark's synthetic corpus (tpuvdb/bench/scan.py:66-91):
    (n, dim) f32 rows that broke recall margins where gaussian data does
    not. Makes the reference's draws in its order from `rng`: a 20%
    gaussian background, 256 zipf-sized clusters (60% of the rows, centres
    * 4.0, spread 0.35), 20% near-duplicate shells (0.02) of random rows
    drawn so far, then a permutation. The shares' row counts must add up
    to n (int(0.2 n) + int(0.6 n) + int(0.2 n) == n), as in the reference.
    The caller draws its queries from the same `rng` afterwards, as the
    reference does."""
    n_clusters = 256
    w = 1.0 / np.arange(1, n_clusters + 1)
    counts = rng.multinomial(int(n * 0.6), w / w.sum())
    parts = [rng.standard_normal((int(n * 0.2), dim)).astype(np.float32)]
    for m in counts[counts > 0]:
        c = rng.standard_normal(dim).astype(np.float32) * 4.0
        parts.append(c + 0.35 * rng.standard_normal((m, dim)).astype(
            np.float32))
    basep = np.concatenate(parts)
    del parts
    dup_src = basep[rng.choice(len(basep), int(n * 0.2))]
    shells = dup_src + 0.02 * rng.standard_normal(dup_src.shape).astype(
        np.float32)
    del dup_src
    corpus = np.concatenate([basep, shells])[:n]
    del basep, shells
    return corpus[rng.permutation(n)]
