"""Ranking and reconstruction losses (port of ``losses.py``).

Margin ranking, RotatE-style self-adversarial (detached softmax weights),
cosine and MSE reconstruction, and the multi-objective sum normalized by the
sum of the active weights. Negatives are ``[B, K]`` / ``[B, K, D]``
throughout; an optional 0/1 row mask weights padded batches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from relgat_projector_tpu_torch.models.scorer import l2_normalize


def _row_mean(x: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over all elements, or over the rows whose weight is 1."""
    if weights is None:
        return x.mean()
    w = weights.reshape(weights.shape + (1,) * (x.dim() - 1))
    denom = weights.sum().clamp_min(1.0) * (x.numel() / x.shape[0])
    return (x * w).sum() / denom


def margin_ranking_loss(pos_score, neg_score, margin: float, weights=None):
    return _row_mean(F.relu(margin + neg_score - pos_score[:, None]), weights)


def self_adversarial_loss(pos_score, neg_score, alpha: float, weights=None):
    adv = torch.softmax(alpha * neg_score, dim=1).detach()
    pos_loss = _row_mean(-F.logsigmoid(pos_score), weights)
    neg_loss = _row_mean(-(adv * F.logsigmoid(-neg_score)).sum(1), weights)
    return pos_loss + neg_loss


def ranking_loss(
    pos_score, neg_score, *, use_self_adv_neg: bool, margin: float = 1.0,
    self_adv_alpha: float = 1.0, weights=None,
):
    if use_self_adv_neg:
        return self_adversarial_loss(pos_score, neg_score, self_adv_alpha, weights)
    return margin_ranking_loss(pos_score, neg_score, margin, weights)


def cosine_loss(pred, target, weights=None):
    """``(1 - cos).mean()``; ``pred [B, D]`` broadcasts against
    ``target [B, K, D]``."""
    pred_n = l2_normalize(pred)
    tgt_n = l2_normalize(target)
    while pred_n.dim() < tgt_n.dim():
        pred_n = pred_n.unsqueeze(1)
    cos = (pred_n * tgt_n).sum(-1)
    return _row_mean(1.0 - cos, weights)


def mse_loss(a, b, weights=None):
    return _row_mean((a - b).square(), weights)


class MultiObjectiveParts(NamedTuple):
    total: torch.Tensor
    ranking: torch.Tensor
    cosine_pos: torch.Tensor
    cosine_neg: torch.Tensor
    mse: torch.Tensor


def multi_objective_loss(
    *,
    pos_score,
    neg_score,
    transformed_src,
    dst_vec,
    neg_dst_vec,
    relgat_weight: float = 1.0,
    pos_cosine_weight: float = 1.0,
    neg_cosine_weight: float = 1.0,
    mse_weight: float = 0.0,
    use_self_adv_neg: bool = False,
    margin: float = 1.0,
    self_adv_alpha: float = 1.0,
    weights=None,
) -> MultiObjectiveParts:
    """Weighted sum over the active terms, divided by their weights' sum.
    The negative-cosine term is ``w * (1 - CosineLoss) = w * mean(cos)``."""
    rank = ranking_loss(
        pos_score, neg_score, use_self_adv_neg=use_self_adv_neg,
        margin=margin, self_adv_alpha=self_adv_alpha, weights=weights,
    )
    cos_pos = cosine_loss(transformed_src, dst_vec, weights)
    cos_neg = (
        cosine_loss(transformed_src, neg_dst_vec, weights)
        if neg_dst_vec is not None
        else pos_score.new_tensor(1.0)
    )
    mse = mse_loss(transformed_src, dst_vec, weights)

    parts = []
    weight_sum = 0.0
    for w, term in (
        (relgat_weight, rank),
        (pos_cosine_weight, cos_pos),
        (neg_cosine_weight, 1.0 - cos_neg),
        (mse_weight, mse),
    ):
        if w != 0.0:
            parts.append(w * term)
            weight_sum += w
    if not parts:
        raise ValueError("At least one loss weight must be non-zero.")
    total = sum(parts) / weight_sum
    return MultiObjectiveParts(
        total=total, ranking=rank, cosine_pos=cos_pos, cosine_neg=cos_neg,
        mse=mse,
    )


def sanitize_scores(scores: torch.Tensor) -> torch.Tensor:
    """NaN -> 0, then clip to [-1e9, 1e9]."""
    return torch.where(torch.isnan(scores), 0.0, scores).clamp(-1e9, 1e9)
