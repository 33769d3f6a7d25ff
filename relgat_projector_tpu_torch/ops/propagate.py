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
from relgat_projector_tpu_torch.ops.segment import STABLE_SOFTMAX_EPS

# (forward, backward src pass, backward relation reduction), by bf16 streams
_KERNELS = {
    False: (relgat_fwd, relgat_bwd_src, relgat_bwd_rel),
    True: (relgat_fwd_bf16, relgat_bwd_src_bf16, relgat_bwd_rel_bf16),
}


class RelGATPropagate(torch.autograd.Function):
    """``(h [N, H, F], attn [H, R, F], rel_bias [R]) -> out [N, H, F]`` over
    a :class:`CSRGraph`; ``seed``/``rate`` drive the attention dropout and
    ``bf16`` selects the kernels' bf16 row streams."""

    @staticmethod
    def forward(ctx, h, attn, rel_bias, csr, seed, rate, negative_slope, eps,
                bf16):
        n, heads, f = h.shape
        h2 = h.reshape(n, heads * f)
        h2 = (h2.to(torch.bfloat16) if bf16 else h2).contiguous()
        attn = attn.contiguous()
        out, m, l, bias = _KERNELS[bf16][0](
            h2, attn, rel_bias.contiguous(), csr, seed=seed, rate=rate,
            negative_slope=negative_slope, eps=eps,
        )
        ctx.save_for_backward(h2, attn, out, m, l, bias)
        ctx.cfg = (csr, seed, rate, negative_slope, eps, bf16)
        return out.view(n, heads, f)

    @staticmethod
    def backward(ctx, g):
        h2, attn, out, m, l, bias = ctx.saved_tensors
        csr, seed, rate, negative_slope, eps, bf16 = ctx.cfg
        _, bwd_src, bwd_rel = _KERNELS[bf16]
        heads, _, f = attn.shape
        n = h2.shape[0]
        g2 = g.reshape(n, heads * f).contiguous()
        s_dot = ((out - bias[:, None]) * g2).view(n, heads, f).sum(-1)
        gsum = g2.sum(1)
        if bf16:
            g2 = g2.to(torch.bfloat16)
        dh, w, b = bwd_src(
            h2, g2, attn, m, l, s_dot, gsum, csr, seed=seed, rate=rate,
            negative_slope=negative_slope, eps=eps,
        )
        dattn, dbias = bwd_rel(h2, w, b)
        drel = dbias if ctx.needs_input_grad[2] else None
        return (dh.view(n, heads, f), dattn, drel) + (None,) * 6


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
    attn = attn.float()
    rel_bias = (attn.new_zeros((attn.shape[1],)) if rel_bias is None
                else rel_bias.float())
    rate = float(attn_dropout_rate) if dropout_seed is not None else 0.0
    return RelGATPropagate.apply(
        h, attn, rel_bias, csr, dropout_seed, rate, float(negative_slope),
        float(eps), kernel_precision == "default",
    )
