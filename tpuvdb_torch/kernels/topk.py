"""Top-k primitives shared by the scan paths (torch port of
tpuvdb.kernels.topk).

Convention: top-k state is kept as *negated* squared-L2 scores
("neg-scores", larger = closer) so `torch.topk` — a max-k — applies
directly; the public API converts back to ascending squared-L2 at the
boundary. Invalid / masked slots carry -inf neg-score and index -1.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def mask_scores(neg_scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Set neg-scores of invalid slots to -inf so top-k never selects them."""
    return torch.where(valid, neg_scores,
                       torch.full_like(neg_scores, NEG_INF))


def merge_topk(neg_a, idx_a, neg_b, idx_b, k: int):
    """Merge two (Q, ka) / (Q, kb) top-k sets into a (Q, k) top-k set,
    sorted descending by neg-score (ascending true distance)."""
    cat_neg = torch.cat([neg_a, neg_b], dim=-1)
    cat_idx = torch.cat([idx_a, idx_b], dim=-1)
    top_neg, pos = torch.topk(cat_neg, k, dim=-1)
    return top_neg, torch.gather(cat_idx, -1, pos)


def empty_topk(q: int, k: int, device=None):
    """Initial running top-k state: all -inf / index -1."""
    return (
        torch.full((q, k), NEG_INF, dtype=torch.float32, device=device),
        torch.full((q, k), -1, dtype=torch.int32, device=device),
    )


def finalize(neg_scores: torch.Tensor, idx: torch.Tensor):
    """Neg-score state -> ascending squared-L2; empty slots get +inf."""
    dist = torch.where(idx >= 0, -neg_scores,
                       torch.full_like(neg_scores, float("inf")))
    return dist, idx
