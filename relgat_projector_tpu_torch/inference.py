"""Inference: export, relation paths, query expansion, imputation, scoring.

Port of ``relgat_projector_tpu/inference.py``, on tensors, on the device of
their inputs. Built on the relation operator ``transform`` (reference
``scorer.py:86-94, 188-201``) and the model's ``get_node_repr`` and
``transform_from_vectors``:

- the node-representation matrix, for offline indexing;
- relation-path composition: relation operators applied in sequence in the
  scorer's embedding space;
- query expansion: a query vector transformed by a relation, then every
  node ranked by cosine similarity (``torch.topk``);
- inductive imputation of a node without a vector, from the
  relation-transformed representations of its known neighbours.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from relgat_projector_tpu_torch.config import ModelConfig
from relgat_projector_tpu_torch.data.graph import GraphData
from relgat_projector_tpu_torch.device import set_matmul_precision
from relgat_projector_tpu_torch.models import model as model_lib
from relgat_projector_tpu_torch.models import scorer as scorer_mod
from relgat_projector_tpu_torch.models.scorer import l2_normalize


def export_node_representations(
    params,
    cfg: ModelConfig,
    node_emb: torch.Tensor,
    graph: GraphData,
    path: Optional[str] = None,
) -> torch.Tensor:
    """The ``[N, D_sc]`` representations of the real nodes; also written to
    ``path`` as ``.npy`` when given."""
    x = model_lib.get_node_repr(params, cfg, node_emb, graph)
    if path is not None:
        np.save(path, x.cpu().numpy())
    return x


def compose_relation_path(
    params,
    cfg: ModelConfig,
    vectors: torch.Tensor,      # [B, D_sc] starting vectors
    rel_path: Sequence[int],    # relation ids applied in order
) -> torch.Tensor:
    """``f_{r_k} o ... o f_{r_1}`` by repeated ``transform_from_vectors``
    (reference ``model.py:169-186``)."""
    out = vectors
    for rel_id in rel_path:
        out = model_lib.transform_from_vectors(
            params, cfg, out, torch.tensor([rel_id], device=vectors.device)
        )
    return out


def query_expansion(
    params,
    cfg: ModelConfig,
    node_repr: torch.Tensor,   # [N, D_sc], e.g. export_node_representations
    query_vec: torch.Tensor,   # [D_sc] or [B, D_sc]
    rel_id: int,
    top_k: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transform the queries by the relation and rank the nodes by cosine
    similarity. Returns ``(indices [B, top_k], scores [B, top_k])``, best
    first."""
    if node_repr.is_cuda:
        set_matmul_precision()
    q = torch.atleast_2d(query_vec)
    tq = model_lib.transform_from_vectors(
        params, cfg, q, torch.tensor([rel_id], device=q.device)
    )
    sims = l2_normalize(tq) @ l2_normalize(node_repr).T    # [B, N]
    scores, idx = torch.topk(sims, top_k)
    return idx, scores


def impute_embedding(
    params,
    cfg: ModelConfig,
    node_repr: torch.Tensor,               # [N, D_sc]
    neighbors: List[Tuple[int, int]],      # (known node id, relation id)
) -> torch.Tensor:
    """A representation for a node without a vector: the mean of its known
    neighbours' representations, each transformed by the relation of its
    edge ``u --r--> v``, which is the model's guess of where ``v`` lives."""
    if not neighbors:
        raise ValueError("impute_embedding needs at least one neighbor")
    ids = torch.tensor([u for u, _ in neighbors], device=node_repr.device)
    rels = torch.tensor([r for _, r in neighbors], device=node_repr.device)
    transformed = scorer_mod.transform(
        params["scorer"], cfg.scorer_type, node_repr[ids], rels
    )
    return transformed.mean(0)


def score_candidates(
    params,
    cfg: ModelConfig,
    node_repr: torch.Tensor,
    src_id: int,
    rel_id: int,
    candidate_ids: torch.Tensor,
) -> torch.Tensor:
    """The scorer's link-prediction scores of candidate destinations."""
    n = candidate_ids.shape[0]
    src = node_repr[src_id].expand(n, node_repr.shape[1])
    rels = torch.full((n,), rel_id, dtype=torch.int64, device=node_repr.device)
    dst = node_repr[candidate_ids]
    return scorer_mod.score_triplets(
        params["scorer"], cfg.scorer_type, src, rels, dst
    )
