"""The work of the IVF probe (tpuvdb_torch/csrc/ivf_probe.cu through
kernels/ivf_probe.py): each query scores the rows of the nprobe cells whose
centroids lie nearest it, and the rows of the spill reserve.

The cells a query picks are worked out here from the index's centroids
(the nprobe best of 2 q.c - |c|^2) and its cells' live lengths. For one
launch of Q queries:
  operations: 2 * d * sum over queries of (rows of its picked cells +
              spill rows);
  bytes:      each input read once and each output written once: the rows
              of the union of the batch's picked cells and of the spill (d
              elements and a validity byte each), the f32 queries, and the
              f32 distance and int32 row of each of the Q * k hits.
The coarse pick itself is torch ops outside the kernel and is not counted.

KERNELS are the functions of the library's launch: the operand prep, the
probe and the decode of its candidates.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

KERNELS = ("probe_mma_kernel", "decode_kernel", "prep_queries_kernel")
MAIN = "probe_mma_kernel"


def picked_cells(queries: np.ndarray, centroids: np.ndarray,
                 nprobe: int) -> np.ndarray:
    """(Q, nprobe) cell ids each query probes."""
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    c = torch.from_numpy(np.ascontiguousarray(centroids, np.float32))
    scores = 2.0 * (q @ c.T) - (c * c).sum(dim=1)[None, :]
    return torch.topk(scores, nprobe, dim=1).indices.numpy()


def count(cells: np.ndarray, cell_rows: np.ndarray, spill_rows: int,
          d: int, k: int, element_bytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one launch whose queries pick `cells`
    (Q, nprobe), with cell_rows[c] live rows in cell c."""
    q = cells.shape[0]
    scored = float(cell_rows[cells].sum()) + q * spill_rows
    read = float(cell_rows[np.unique(cells)].sum()) + spill_rows
    ops = 2.0 * d * scored
    nbytes = read * (d * element_bytes + 1) + q * d * 4 + q * k * 8
    return ops, nbytes


def launches(run) -> List[Tuple[float, float]]:
    """(operations, bytes) of every call of the window, from the pool
    batch each call sent."""
    ivf = run.ivf_state
    tr = run.traffic
    cells = picked_cells(tr.pool, ivf["centroids"], ivf["nprobe"])
    per: Dict[int, Tuple[float, float]] = {}
    out = []
    for b in run.window.batches:
        if b not in per:
            per[b] = count(cells[b * tr.batch:(b + 1) * tr.batch],
                           ivf["cell_rows"], ivf["spill_rows"], run.dim,
                           tr.k, run.element_bytes)
        out.append(per[b])
    return out
