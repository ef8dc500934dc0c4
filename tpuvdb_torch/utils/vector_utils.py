"""Host-boundary vector helpers: the port's copy of
tpuvdb.utils.vector_utils (list <-> ndarray with a width check, L2
normalize). They run at the numpy boundary only; device math lives in
tpuvdb_torch.kernels.
"""

from __future__ import annotations

import numpy as np


def as_f32_matrix(vectors, dim: int) -> np.ndarray:
    """Coerce a vector or batch of vectors to float32 (n, dim)."""
    arr = np.asarray(vectors, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2 or arr.shape[1] != dim:
        raise ValueError(f"expected (*, {dim}) vectors, got shape {arr.shape}")
    return np.ascontiguousarray(arr)


def l2_normalize(v: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, eps)
