"""The work of the flat scan (tpuvdb_torch/csrc/scan.cu through
kernels/scan.py): the k nearest of Q queries among N live rows of d
elements, for each launch of the window.

Operations: 2 * Q * N * d (a multiply and an add for each element of each
query-row pair). Bytes: each input read once and each output written once,
whatever the kernel reads again: the live rows (N * d elements and a
validity byte each), the f32 queries and the f32 distance and int32 row of
each of the Q * k hits. Padding rows of the stacked layout, buckets and
splits are the kernel's choices and are not counted.

KERNELS are the functions of the library's launch: the operand prep, the
scan and the merge of its splits.
"""

from __future__ import annotations

from typing import List, Tuple

KERNELS = ("scan_kernel", "merge_splits_kernel", "prep_queries_kernel")
MAIN = "scan_kernel"


def count(q: int, n: int, d: int, k: int, element_bytes: int
          ) -> Tuple[float, float]:
    """(operations, bytes) of one launch."""
    ops = 2.0 * q * n * d
    nbytes = n * (d * element_bytes + 1) + q * d * 4 + q * k * 8
    return ops, nbytes


def launches(run) -> List[Tuple[float, float]]:
    """(operations, bytes) of every call of the window: each is one launch
    at the cell's batch."""
    one = count(run.traffic.batch, run.live_rows, run.dim, run.traffic.k,
                run.element_bytes)
    return [one] * len(run.window.batches)
