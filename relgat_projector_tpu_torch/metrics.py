"""Sampled-negative MRR and Hits@K (port of ``metrics.py``).

Pessimistic ties (``rank = 1 + count(neg >= pos)``); scores sanitized first
(NaN -> -1e9, then clipped to [-1e9, 1e9]).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _sanitize(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), -1e9, x).clamp(-1e9, 1e9)


def compute_ranks(pos_score, neg_score, *, pessimistic: bool = True):
    pos = _sanitize(pos_score)
    neg = _sanitize(neg_score)
    if pessimistic:
        worse = neg >= pos[:, None]
    else:
        worse = neg > pos[:, None]
    return 1.0 + worse.to(pos.dtype).sum(1)


def compute_mrr_hits(
    pos_score: torch.Tensor,
    neg_score: torch.Tensor,
    ks: Tuple[int, ...],
    *,
    pessimistic: bool = True,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """``(mrr, {k: hits@k})`` as 0-d tensors (empty batch -> 0); ``weights``
    is an optional 0/1 example mask."""
    if pos_score.shape[0] == 0:
        zero = pos_score.new_tensor(0.0)
        return zero, {k: zero for k in ks}
    if weights is None:
        def wmean(x):
            return x.mean()
    else:
        denom = weights.sum().clamp_min(1.0)

        def wmean(x):
            return (x * weights).sum() / denom
    ranks = compute_ranks(pos_score, neg_score, pessimistic=pessimistic)
    mrr = wmean(1.0 / ranks.clamp_min(1.0))
    hits = {k: wmean((ranks <= float(k)).to(pos_score.dtype)) for k in ks}
    return mrr, hits
