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
"""

from __future__ import annotations

from typing import Optional

import torch

from relgat_projector_tpu_torch.data.csr import CSRGraph
from relgat_projector_tpu_torch.ops.cuda import (
    relgat_bwd_rel,
    relgat_bwd_src,
    relgat_fwd,
)
from relgat_projector_tpu_torch.ops.segment import STABLE_SOFTMAX_EPS


class RelGATPropagate(torch.autograd.Function):
    """``(h [N, H, F], attn [H, R, F], rel_bias [R]) -> out [N, H, F]`` over
    a :class:`CSRGraph`; ``seed``/``rate`` drive the attention dropout."""

    @staticmethod
    def forward(ctx, h, attn, rel_bias, csr, seed, rate, negative_slope, eps):
        n, heads, f = h.shape
        h2 = h.reshape(n, heads * f).contiguous()
        attn = attn.contiguous()
        out, m, l, bias = relgat_fwd(
            h2, attn, rel_bias.contiguous(), csr, seed=seed, rate=rate,
            negative_slope=negative_slope, eps=eps,
        )
        ctx.save_for_backward(h2, attn, out, m, l, bias)
        ctx.cfg = (csr, seed, rate, negative_slope, eps)
        return out.view(n, heads, f)

    @staticmethod
    def backward(ctx, g):
        h2, attn, out, m, l, bias = ctx.saved_tensors
        csr, seed, rate, negative_slope, eps = ctx.cfg
        heads, _, f = attn.shape
        n = h2.shape[0]
        g2 = g.reshape(n, heads * f).contiguous()
        s_dot = ((out - bias[:, None]) * g2).view(n, heads, f).sum(-1)
        gsum = g2.sum(1)
        dh, w, b = relgat_bwd_src(
            h2, g2, attn, m, l, s_dot, gsum, csr, seed=seed, rate=rate,
            negative_slope=negative_slope, eps=eps,
        )
        dattn, dbias = relgat_bwd_rel(h2, w, b)
        drel = dbias if ctx.needs_input_grad[2] else None
        return dh.view(n, heads, f), dattn, drel, None, None, None, None, None


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
) -> torch.Tensor:
    """Counterpart of ``relgat_propagate_pallas``: no ``rel_bias`` adds a
    zero bias that takes no gradient."""
    if rel_bias is None:
        rel_bias = attn.new_zeros((attn.shape[1],))
    rate = float(attn_dropout_rate) if dropout_seed is not None else 0.0
    return RelGATPropagate.apply(
        h, attn, rel_bias, csr, dropout_seed, rate, float(negative_slope),
        float(eps),
    )
