"""Triplet scorers and relation operators (port of ``models/scorer.py``).

DistMult: ``score = sum(s * r * d)``, ``transform(s, r) = s * r``.
TransE: ``score = -||n(s) + n(r) - n(d)||``, ``transform = n(s) + n(r)``
with ``n`` the L2 normalization below. Relation embeddings ``[R, D]``.
"""

from __future__ import annotations

from typing import Dict

import torch

from relgat_projector_tpu_torch.models.initializers import xavier_uniform

_NORMALIZE_EPS = 1e-12


def init_scorer(
    generator: torch.Generator, num_rel: int, rel_dim: int
) -> Dict[str, torch.Tensor]:
    return {
        "rel_emb": xavier_uniform(
            generator, (num_rel, rel_dim), fan_in=rel_dim, fan_out=num_rel
        )
    }


def l2_normalize(x: torch.Tensor, eps: float = _NORMALIZE_EPS) -> torch.Tensor:
    """``x / max(||x||, eps)`` with a zero gradient at zero rows, not the
    ``1/eps`` that ``F.normalize`` backpropagates there (zero rows are real:
    nodes without in-edges aggregate to exactly zero). NaN rows take the
    dividing branch so non-finite inputs still reach the loss."""
    sq = x.square().sum(-1, keepdim=True)
    out = x / torch.sqrt(sq.clamp_min(eps * eps))
    return torch.where(sq <= eps * eps, torch.zeros_like(x), out)


def safe_l2_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``||x||`` along the last axis with a zero (not NaN) gradient at 0."""
    return torch.sqrt(x.square().sum(-1).clamp_min(eps * eps))


def score_triplets(params, scorer_type: str, src_vec, rel_ids, dst_vec):
    """Scores ``[...]``; higher is more plausible."""
    rel = params["rel_emb"][rel_ids]
    if scorer_type == "distmult":
        return (src_vec * rel * dst_vec).sum(-1)
    if scorer_type == "transe":
        return -safe_l2_norm(
            l2_normalize(src_vec) + l2_normalize(rel) - l2_normalize(dst_vec)
        )
    raise ValueError(f"Unknown scorer_type: {scorer_type}")


def transform(params, scorer_type: str, src_vec, rel_ids):
    """Relation operator: DistMult ``s * r``; TransE ``n(s) + n(r)``."""
    rel = params["rel_emb"][rel_ids]
    if scorer_type == "distmult":
        return src_vec * rel
    if scorer_type == "transe":
        return l2_normalize(src_vec) + l2_normalize(rel)
    raise ValueError(f"Unknown scorer_type: {scorer_type}")
