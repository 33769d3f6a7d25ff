"""RelGAT layer: multi-head relational graph attention, heads vectorized.

Port of ``relgat_projector_tpu/models/layer.py``. Parameters keep the JAX
layout: ``proj [H, in, F]``, ``attn [H, R, F]``, optional ``rel_bias [R]``.
One ``[N, in] x [in, H*F]`` product projects every head; it stays
``torch.matmul`` (the JAX package leaves it to XLA), with its operands in
``compute_dtype`` and an fp32 result.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from relgat_projector_tpu_torch.data.graph import GraphData
from relgat_projector_tpu_torch.device import compute_matmul
from relgat_projector_tpu_torch.models.initializers import xavier_uniform
from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate
from relgat_projector_tpu_torch.utils.rng import RngStreams


def init_relgat_layer(
    generator: torch.Generator,
    in_dim: int,
    out_dim: int,
    num_rel: int,
    heads: int,
    *,
    use_bias: bool = True,
) -> Dict[str, torch.Tensor]:
    params = {
        "proj": xavier_uniform(
            generator, (heads, in_dim, out_dim), fan_in=in_dim, fan_out=out_dim
        ),
        "attn": xavier_uniform(
            generator, (heads, num_rel, out_dim), fan_in=out_dim,
            fan_out=num_rel,
        ),
    }
    if use_bias:
        params["rel_bias"] = torch.zeros((num_rel,))
    return params


def apply_relgat_layer(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,              # [N, in_dim]
    graph: GraphData,
    *,
    dropout_rate: float = 0.0,
    attn_dropout_rate: float = 0.0,
    train: bool = False,
    rng: Optional[RngStreams] = None,
    use_pallas: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    kernel_precision: str = "highest",
) -> torch.Tensor:
    """One message-passing step; returns ``[N, heads * out_dim]``."""
    proj = params["proj"]
    heads, in_dim, out_dim = proj.shape
    n = x.shape[0]
    w = proj.permute(1, 0, 2).reshape(in_dim, heads * out_dim)
    h = compute_matmul(x, w, compute_dtype).view(n, heads, out_dim)

    drawing = train and rng is not None
    agg = relgat_propagate(
        h,
        params["attn"],
        params.get("rel_bias"),
        graph.src,
        graph.dst,
        graph.etype,
        num_nodes=graph.num_nodes,
        attn_dropout_rate=attn_dropout_rate if train else 0.0,
        dropout_seed=(
            rng.int32_seed() if drawing and attn_dropout_rate > 0.0 else None
        ),
        use_pallas=use_pallas,
        csr=graph.csr,
        kernel_precision=kernel_precision,
    )
    out = agg.reshape(n, heads * out_dim)

    # Output dropout on the concatenated heads (reference ``layer.py:322``).
    if drawing and dropout_rate > 0.0:
        keep = torch.empty_like(out).bernoulli_(
            1.0 - dropout_rate, generator=rng.device
        )
        out = out * keep / (1.0 - dropout_rate)
    return out
