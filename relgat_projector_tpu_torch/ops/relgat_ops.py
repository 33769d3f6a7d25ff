"""Fused RelGAT message passing (SDDMM -> segment softmax -> SpMM).

Port of ``relgat_projector_tpu/ops/relgat_ops.py``. Per edge, the logit is
``LeakyReLU_0.2(<h[src], attn[etype]>)`` per head; a stable softmax per
destination (denominator clamped at 1e-16), optional dropout on the
normalized weights, the weighted sum of source rows, and a per-relation
scalar bias summed per destination and added to every head and feature.

``use_pallas`` selects the Hopper kernels (``ops/propagate.py``) and needs
the graph's CSR layout; ``kernel_precision`` picks their fp32 ("highest",
"high") or bf16-stream ("default") variants. Otherwise
``_plain_propagate``, the counterpart of ``_xla_propagate``, runs over the
padded COO in the input's precision and ignores ``kernel_precision``, as
the JAX path does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from relgat_projector_tpu_torch.data.csr import CSRGraph
from relgat_projector_tpu_torch.ops.dropout import edge_keep_mask_all_heads
from relgat_projector_tpu_torch.ops.segment import (
    STABLE_SOFTMAX_EPS,
    segment_softmax,
    segment_sum,
)

KERNEL_PRECISIONS = ("highest", "high", "default")


def relgat_propagate(
    h: torch.Tensor,              # [N, H, F]
    attn_bank: torch.Tensor,      # [H, R, F]
    rel_bias: Optional[torch.Tensor],  # [R] or None
    src: torch.Tensor,            # [E] int64
    dst: torch.Tensor,            # [E] int64
    etype: torch.Tensor,          # [E] int64
    *,
    num_nodes: int,
    negative_slope: float = 0.2,
    eps: float = STABLE_SOFTMAX_EPS,
    attn_dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    use_pallas: bool = False,
    csr: Optional[CSRGraph] = None,
    kernel_precision: str = "highest",
) -> torch.Tensor:
    """Aggregated messages ``[N, H, F]``. Dropout applies when the rate is
    positive and a seed is given (the JAX path's ``dropout_rng``)."""
    if use_pallas:
        if csr is None:
            raise ValueError(
                "use_pallas needs the kernels' CSR layout: build the graph "
                "with build_graph(..., csr=True)"
            )
        if kernel_precision not in KERNEL_PRECISIONS:
            raise ValueError(f"Unknown kernel_precision: {kernel_precision}")
        from relgat_projector_tpu_torch.ops.propagate import (
            relgat_propagate_kernels,
        )

        return relgat_propagate_kernels(
            h, attn_bank, rel_bias, csr,
            negative_slope=negative_slope, eps=eps,
            attn_dropout_rate=attn_dropout_rate, dropout_seed=dropout_seed,
            kernel_precision=kernel_precision,
        )
    return _plain_propagate(
        h, attn_bank, rel_bias, src, dst, etype,
        num_nodes=num_nodes, negative_slope=negative_slope, eps=eps,
        attn_dropout_rate=attn_dropout_rate, dropout_seed=dropout_seed,
    )


def _plain_propagate(
    h, attn_bank, rel_bias, src, dst, etype, *,
    num_nodes, negative_slope, eps, attn_dropout_rate, dropout_seed,
):
    proj_src = h[src]                                      # [E, H, F]
    rel_att = attn_bank[:, etype].transpose(0, 1)          # [E, H, F]
    e = F.leaky_relu((proj_src * rel_att).sum(-1), negative_slope)
    alpha = segment_softmax(e, dst, num_nodes, eps=eps)    # [E, H]
    if attn_dropout_rate > 0.0 and dropout_seed is not None:
        eids = torch.arange(src.shape[0], device=src.device)
        keep = edge_keep_mask_all_heads(
            eids, alpha.shape[1], dropout_seed, attn_dropout_rate
        )
        alpha = alpha * keep / (1.0 - attn_dropout_rate)
    out = segment_sum(proj_src * alpha[..., None], dst, num_nodes)
    if rel_bias is not None:
        bias_n = segment_sum(rel_bias[etype], dst, num_nodes)
        out = out + bias_n[:, None, None]
    return out
