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
the JAX path does. Given a graph shard's ``halo`` plan, the propagate runs
on the shard's rows with the boundary exchange (``parallel/halo.py``);
given an ``edge_shard``, on every row from this rank's part of the edges,
joined over its graph line: the kernels over its destination range on the
``replicated`` route (``parallel/pallas_sharded.py``), the plain partial
state of its piece of the edges on the ``gspmd`` route
(``parallel/sharded.py``).

``relgat_propagate_partial`` and ``merge_propagate_partials`` are the halo
route's plain form: the un-normalized online-softmax state of an edge
subset, and the merge of subsets over the same destination rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from relgat_projector_tpu_torch.data.csr import CSRGraph
from relgat_projector_tpu_torch.ops.dropout import edge_keep_mask_all_heads
from relgat_projector_tpu_torch.ops.segment import (
    STABLE_SOFTMAX_EPS,
    segment_max,
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
    halo=None,
    edge_shard=None,
) -> torch.Tensor:
    """Aggregated messages ``[N, H, F]``. Dropout applies when the rate is
    positive and a seed is given (the JAX path's ``dropout_rng``). With
    ``halo`` (a ``parallel.halo.HaloShard``) ``h`` holds this shard's rows
    and so does the result; with ``edge_shard`` (a
    ``parallel.pallas_sharded.ReplicatedShard``, which takes ``use_pallas``,
    or a ``parallel.sharded.GspmdShard``, which refuses it) ``h`` and the
    result hold every row. Either way ``src``/``dst``/``etype``/``csr`` are
    unused."""
    if (use_pallas or halo is not None or edge_shard is not None) and (
            kernel_precision not in KERNEL_PRECISIONS):
        raise ValueError(f"Unknown kernel_precision: {kernel_precision}")
    if edge_shard is not None:
        return _sharded_propagate(
            h, attn_bank, rel_bias, edge_shard, use_pallas=use_pallas,
            negative_slope=negative_slope, eps=eps,
            attn_dropout_rate=attn_dropout_rate, dropout_seed=dropout_seed,
            kernel_precision=kernel_precision,
        )
    if halo is not None:
        from relgat_projector_tpu_torch.parallel.halo import halo_propagate

        return halo_propagate(
            h, attn_bank, rel_bias, halo, use_pallas=use_pallas,
            negative_slope=negative_slope, eps=eps,
            attn_dropout_rate=attn_dropout_rate, dropout_seed=dropout_seed,
            kernel_precision=kernel_precision,
        )
    if use_pallas:
        if csr is None:
            raise ValueError(
                "use_pallas needs the kernels' CSR layout: build the graph "
                "with build_graph(..., csr=True)"
            )
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


def _sharded_propagate(h, attn_bank, rel_bias, edge_shard, *, use_pallas,
                       kernel_precision, **kw):
    """The routes with replicated features (JAX: ``use_pallas`` selects the
    replicated route's kernels; the gspmd route has none)."""
    from relgat_projector_tpu_torch.parallel.pallas_sharded import (
        ReplicatedShard,
        pallas_sharded_propagate,
    )
    from relgat_projector_tpu_torch.parallel.sharded import (
        GspmdShard,
        gspmd_propagate,
    )

    if isinstance(edge_shard, ReplicatedShard) and use_pallas:
        return pallas_sharded_propagate(h, attn_bank, rel_bias, edge_shard,
                                        kernel_precision=kernel_precision,
                                        **kw)
    if isinstance(edge_shard, GspmdShard) and not use_pallas:
        return gspmd_propagate(h, attn_bank, rel_bias, edge_shard, **kw)
    raise ValueError(
        f"{type(edge_shard).__name__} with use_pallas={use_pallas}: the "
        "replicated route runs the kernels and the gspmd route the plain "
        "propagate, each on a rank's part placed with parallel.place_graph"
    )


def _plain_propagate(
    h, attn_bank, rel_bias, src, dst, etype, *,
    num_nodes, negative_slope, eps, attn_dropout_rate, dropout_seed,
):
    """Over any source space: ``h`` rows are read at ``src``, the result has
    ``num_nodes`` destination rows; an edge's dropout id is its index."""
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


def relgat_propagate_partial(
    h: torch.Tensor,              # [N_src, H, F] this subset's source space
    attn_bank: torch.Tensor,      # [H, R, F]
    rel_bias: Optional[torch.Tensor],
    src: torch.Tensor,            # [E_sub] ids into h's rows
    dst: torch.Tensor,            # [E_sub] output rows
    etype: torch.Tensor,          # [E_sub]
    *,
    num_out: int,
    negative_slope: float = 0.2,
    attn_dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    edge_mask: Optional[torch.Tensor] = None,
    dropout_edge_ids: Optional[torch.Tensor] = None,
):
    """Un-normalized partials ``(acc [num_out, H, F], m, l [num_out, H],
    bias [num_out])`` of an edge subset, for ``merge_propagate_partials``
    (JAX ``relgat_propagate_partial``): the true per-dst max logit ``m``
    (-inf for rows without edges), ``l = sum exp(e - m)`` (un-dropped),
    ``acc = sum exp(e - m) * keep * h[src]`` and the relation-bias sum.
    ``edge_mask`` 0 drops an edge; ``dropout_edge_ids`` are the canonical
    ids the masks hash (default: positions). ``m`` is a shift the merged
    result does not depend on, so no gradient flows through it."""
    proj_src = h[src]                                      # [E, H, F]
    rel_att = attn_bank[:, etype].transpose(0, 1)          # [E, H, F]
    e = F.leaky_relu((proj_src * rel_att).sum(-1), negative_slope)
    if edge_mask is not None:
        e = torch.where(edge_mask[:, None] > 0, e, -torch.inf)
    m = segment_max(e.detach(), dst, num_out)              # [num_out, H]
    w = torch.exp(e - torch.where(torch.isfinite(m), m, 0.0)[dst])
    l = segment_sum(w, dst, num_out)
    w_acc = w
    if attn_dropout_rate > 0.0 and dropout_seed is not None:
        eids = (dropout_edge_ids if dropout_edge_ids is not None
                else torch.arange(src.shape[0], device=src.device))
        keep = edge_keep_mask_all_heads(
            eids, e.shape[1], dropout_seed, attn_dropout_rate
        )
        w_acc = w * keep / (1.0 - attn_dropout_rate)
    acc = segment_sum(proj_src * w_acc[..., None], dst, num_out)
    if rel_bias is not None:
        bias_e = rel_bias[etype]
        if edge_mask is not None:
            bias_e = bias_e * edge_mask
        bias_n = segment_sum(bias_e, dst, num_out)
    else:
        bias_n = h.new_zeros((num_out,), dtype=torch.float32)
    return acc, m, l, bias_n


# The max of a partial over a row its subset never touched: -inf from the
# plain route, JAX's ``_NEG`` from the kernels' (``unpack_partials``); a
# max at or below NEG / 2 is that neutral element.
NEG = -1e30


def merge_partial_states(parts, *, eps: float = STABLE_SOFTMAX_EPS):
    """``(out [N, H, F], m, l, bias)`` of ``(acc, m, l, bias)`` partials from
    disjoint edge subsets of the same destination rows: one softmax over
    the union (flash-attention state merging). Each subset's ``l`` and
    ``acc`` are rescaled by ``exp(m_subset - m)`` and normalized once with
    the ``eps`` clamp; a subset that never touched a row adds nothing."""
    m = parts[0][1]
    for p in parts[1:]:
        m = torch.maximum(m, p[1])
    m_fin = torch.where(m > NEG * 0.5, m, 0.0)
    l_tot = acc_tot = bias_tot = None
    for acc_p, m_p, l_p, bias_p in parts:
        s = torch.where(m_p > NEG * 0.5, torch.exp(m_p - m_fin), 0.0)
        l_c, acc_c = l_p * s, acc_p * s[..., None]
        l_tot = l_c if l_tot is None else l_tot + l_c
        acc_tot = acc_c if acc_tot is None else acc_tot + acc_c
        bias_tot = bias_p if bias_tot is None else bias_tot + bias_p
    out = acc_tot / l_tot.clamp_min(eps)[..., None]
    return out + bias_tot[:, None, None], m, l_tot, bias_tot


def merge_propagate_partials(
    parts, *, eps: float = STABLE_SOFTMAX_EPS,
) -> torch.Tensor:
    """The normalized aggregate ``[N, H, F]`` of ``(acc, m, l, bias)``
    partials (JAX ``merge_propagate_partials``)."""
    return merge_partial_states(parts, eps=eps)[0]
