"""The kernel-backed propagate as a ``torch.autograd.Function``.

Port of ``relgat_projector_tpu/ops/pallas/kernels.py`` (``_make_propagate``
with ``_segment_fwd``, ``_packed_stream`` and ``_bwd_from_packed``). The
forward runs ``relgat_fwd`` and saves ``out`` with the softmax statistics.
The backward computes, as plain reductions (XLA code in the JAX package),
``S = <out - bias, g>`` per (dst, head) and ``gsum = sum_{h,f} g`` per dst,
then runs ``relgat_bwd_src`` for dh and the per-(src row, relation) sums
``W`` (of the logit gradient) and ``B`` (of ``gsum[dst]``), and
``relgat_bwd_rel`` for ``dattn = W^T h`` per head and ``dbias = sum_s B[s]``.
On CPU tensors each kernel wrapper computes its plain version.

``kernel_precision="default"`` is the TPU kernels' bf16 mode: ``h`` is
rounded to bf16 once, at node size, before any gather, and that bf16 ``h``
is what the forward reads and the backward saves (half the fp32 residual);
``S`` and ``gsum`` come from the fp32 ``g``, then ``g`` is rounded to bf16
for ``relgat_bwd_src_bf16``. Arithmetic, ``out``, the statistics and the
gradients stay fp32; ``dh`` passes straight through the cast.

``OverlappedPropagate`` is the halo route's form (JAX
``_make_overlapped_propagate``): two subsets of one graph shard's edges,
each with its own source space, merged flash-style.
"""

from __future__ import annotations

from typing import Optional

import torch

from relgat_projector_tpu_torch.data.csr import CSRGraph
from relgat_projector_tpu_torch.ops.cuda import (
    relgat_bwd_rel,
    relgat_bwd_rel_bf16,
    relgat_bwd_src,
    relgat_bwd_src_bf16,
    relgat_fwd,
    relgat_fwd_bf16,
)
from relgat_projector_tpu_torch.ops.relgat_ops import (
    NEG,
    merge_partial_states,
)
from relgat_projector_tpu_torch.ops.segment import STABLE_SOFTMAX_EPS

# (forward, backward src pass, backward relation reduction), by bf16 streams
_KERNELS = {
    False: (relgat_fwd, relgat_bwd_src, relgat_bwd_rel),
    True: (relgat_fwd_bf16, relgat_bwd_src_bf16, relgat_bwd_rel_bf16),
}


def _rows(h: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``h [N, H, F]`` as the kernels' ``[N, H*F]`` rows (bf16 rounded once,
    at node size, in the bf16 mode)."""
    h2 = h.flatten(1)  # an empty halo buffer keeps its width
    return (h2.to(torch.bfloat16) if bf16 else h2).contiguous()


def _cotangent(g, out, bias, heads, bf16):
    """``(g rows, S, gsum)`` for the backward kernels: ``S = <out - bias, g>``
    per (dst, head) and ``gsum = sum_{h,f} g`` per dst, both from the fp32
    ``g``, which is then rounded to bf16 in the bf16 mode."""
    n = out.shape[0]
    g2 = g.reshape(n, -1).contiguous()
    s_dot = ((out - bias[:, None]) * g2).view(n, heads, -1).sum(-1)
    gsum = g2.sum(1)
    return (g2.to(torch.bfloat16) if bf16 else g2), s_dot, gsum


class RelGATPropagate(torch.autograd.Function):
    """``(h [N_src, H, F], attn [H, R, F], rel_bias [R]) -> out [N, H, F]``
    over a :class:`CSRGraph` (``N_src = csr.num_src``, ``N =
    csr.num_nodes``; equal on one device); ``seed``/``rate`` drive the
    attention dropout and ``bf16`` selects the kernels' bf16 row streams."""

    @staticmethod
    def forward(ctx, h, attn, rel_bias, csr, seed, rate, negative_slope, eps,
                bf16):
        heads, f = h.shape[1:]
        h2 = _rows(h, bf16)
        attn = attn.contiguous()
        out, m, l, bias = _KERNELS[bf16][0](
            h2, attn, rel_bias.contiguous(), csr, seed=seed, rate=rate,
            negative_slope=negative_slope, eps=eps,
        )
        ctx.save_for_backward(h2, attn, out, m, l, bias)
        ctx.cfg = (csr, seed, rate, negative_slope, eps, bf16)
        return out.view(-1, heads, f)

    @staticmethod
    def backward(ctx, g):
        h2, attn, out, m, l, bias = ctx.saved_tensors
        csr, seed, rate, negative_slope, eps, bf16 = ctx.cfg
        _, bwd_src, bwd_rel = _KERNELS[bf16]
        heads, _, f = attn.shape
        g2, s_dot, gsum = _cotangent(g, out, bias, heads, bf16)
        dh, w, b = bwd_src(
            h2, g2, attn, m, l, s_dot, gsum, csr, seed=seed, rate=rate,
            negative_slope=negative_slope, eps=eps,
        )
        dattn, dbias = bwd_rel(h2, w, b)
        drel = dbias if ctx.needs_input_grad[2] else None
        return (dh.view(-1, heads, f), dattn, drel) + (None,) * 6


def unpack_partials(out, m, l, bias, eps):
    """Flash-merge state ``(acc, m, l, bias)`` of one forward's outputs
    (JAX ``_unpack_block_partials``): ``acc`` un-normalizes ``out`` with the
    kernels' own denominator ``max(l, eps)``, so a row the subset never
    touched (``m = -inf``, ``l = 0``, ``out = 0``) recovers the neutral
    element (``m = -1e30``, ``l = acc = bias = 0``)."""
    heads = m.shape[1]
    acc = (out - bias[:, None]).view(out.shape[0], heads, -1)
    acc = acc * l.clamp_min(eps)[..., None]
    return acc, torch.where(torch.isfinite(m), m, NEG), l, bias


class OverlappedPropagate(torch.autograd.Function):
    """The halo route's propagate over two disjoint edge subsets of one
    shard's destination rows with separate source spaces (JAX
    ``_make_overlapped_propagate``): ``(h_own [rows, H, F], halo
    [G*Hp, H, F], attn, rel_bias) -> out [rows, H, F]``.

    The forward launches ``relgat_fwd`` once on the local subset (sources:
    the shard's own rows, which need no exchange) and once on the remote
    subset (sources: the received halo buffer), and merges the two
    partials flash-style (``unpack_partials``, then
    ``relgat_ops.merge_partial_states``; XLA code in JAX, plain PyTorch
    here). The backward runs ``relgat_bwd_src`` and
    ``relgat_bwd_rel`` once per subset against the MERGED statistics (each
    edge's alpha is the union's softmax, so the gradient splits additively
    over the subsets) and returns ``dh_own`` and ``dhalo`` apart; the
    exchange's backward sends ``dhalo`` to the rows' owners."""

    @staticmethod
    def forward(ctx, h_own, halo, attn, rel_bias, loc, rem, seed, rate,
                negative_slope, eps, bf16):
        heads, f = h_own.shape[1:]
        fwd = _KERNELS[bf16][0]
        attn, rel_bias = attn.contiguous(), rel_bias.contiguous()
        kw = dict(seed=seed, rate=rate, negative_slope=negative_slope,
                  eps=eps)
        own2, halo2 = _rows(h_own, bf16), _rows(halo, bf16)
        parts = [unpack_partials(*fwd(rows, attn, rel_bias, csr, **kw), eps)
                 for rows, csr in ((own2, loc), (halo2, rem))]
        out, m, l, bias = merge_partial_states(parts, eps=eps)
        out = out.reshape(out.shape[0], -1)
        ctx.save_for_backward(own2, halo2, attn, out, m, l, bias)
        ctx.cfg = (loc, rem, seed, rate, negative_slope, eps, bf16)
        return out.view(-1, heads, f)

    @staticmethod
    def backward(ctx, g):
        own2, halo2, attn, out, m, l, bias = ctx.saved_tensors
        loc, rem, seed, rate, negative_slope, eps, bf16 = ctx.cfg
        _, bwd_src, bwd_rel = _KERNELS[bf16]
        heads, _, f = attn.shape
        g2, s_dot, gsum = _cotangent(g, out, bias, heads, bf16)
        kw = dict(seed=seed, rate=rate, negative_slope=negative_slope,
                  eps=eps)
        grads = []
        for rows, csr in ((own2, loc), (halo2, rem)):
            dh, w, b = bwd_src(rows, g2, attn, m, l, s_dot, gsum, csr, **kw)
            grads.append((dh.view(-1, heads, f),) + bwd_rel(rows, w, b))
        (dh_own, dattn_l, dbias_l), (dhalo, dattn_r, dbias_r) = grads
        drel = dbias_l + dbias_r if ctx.needs_input_grad[3] else None
        return (dh_own, dhalo, dattn_l + dattn_r, drel) + (None,) * 7


def _kernel_args(attn, rel_bias, attn_dropout_rate, dropout_seed):
    """fp32 ``attn`` and ``rel_bias`` (a zero bias that takes no gradient
    when there is none) and the dropout rate the kernels run at."""
    attn = attn.float()
    rel_bias = (attn.new_zeros((attn.shape[1],)) if rel_bias is None
                else rel_bias.float())
    rate = float(attn_dropout_rate) if dropout_seed is not None else 0.0
    return attn, rel_bias, rate


def relgat_propagate_kernels(
    h: torch.Tensor,
    attn: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    csr: CSRGraph,
    *,
    negative_slope: float = 0.2,
    eps: float = STABLE_SOFTMAX_EPS,
    attn_dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    kernel_precision: str = "highest",
) -> torch.Tensor:
    """Counterpart of ``relgat_propagate_pallas``: no ``rel_bias`` adds a
    zero bias that takes no gradient; ``kernel_precision="default"`` runs
    the bf16 variants ("highest" and "high" the fp32 kernels). The kernels
    take fp32 ``attn`` and ``rel_bias``; parameters stored in bf16 are
    widened here, and autograd casts their gradients back to bf16 (JAX's
    Pallas route leaves ``rel_bias``'s gradient fp32, ``ROADMAP.md``
    Queue 3)."""
    attn, rel_bias, rate = _kernel_args(attn, rel_bias, attn_dropout_rate,
                                        dropout_seed)
    return RelGATPropagate.apply(
        h, attn, rel_bias, csr, dropout_seed, rate, float(negative_slope),
        float(eps), kernel_precision == "default",
    )


def relgat_propagate_kernels_overlapped(
    h_own: torch.Tensor,
    halo: torch.Tensor,
    attn: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    loc: CSRGraph,
    rem: CSRGraph,
    *,
    negative_slope: float = 0.2,
    eps: float = STABLE_SOFTMAX_EPS,
    attn_dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    kernel_precision: str = "highest",
) -> torch.Tensor:
    """Counterpart of ``relgat_propagate_pallas_overlapped``: the local
    subset ``loc`` (sources: ``h_own``) and the remote subset ``rem``
    (sources: ``halo``) of one shard's edges, merged; ``dropout_seed`` is
    the shard's own seed (``parallel/halo.py:shard_seed``)."""
    attn, rel_bias, rate = _kernel_args(attn, rel_bias, attn_dropout_rate,
                                        dropout_seed)
    return OverlappedPropagate.apply(
        h_own, halo, attn, rel_bias, loc, rem, dropout_seed, rate,
        float(negative_slope), float(eps), kernel_precision == "default",
    )
