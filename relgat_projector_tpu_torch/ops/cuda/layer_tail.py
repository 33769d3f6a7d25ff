"""The GAT layer's tail: output dropout, ELU and the next product's rounding.

``layer_tail`` is what ``models/layer.py`` runs on every layer's propagate
output ``agg [N, H*F]`` (fp32): ``agg * keep / (1 - rate)`` where the output
dropout is on (``keep`` the fp32 0/1 mask ``draw_layer_randomness`` drew),
then the ELU where another GAT layer follows, then the rounding to
``out_dtype``, the type the next product reads (``device.operand_dtype``,
``projection.head_operand``). On the card
it runs the hand-written kernels of ``csrc/layer_tail.cu`` as one autograd
function: ``layer_tail_fwd`` (one read of ``agg`` and ``keep``, one write of
the output) and ``layer_tail_bwd`` (one read of the cotangent and ``keep``,
of ``agg`` where the ELU ran, one fp32 write of ``dagg``). They take
contiguous fp32 ``agg`` and ``keep`` of one shape on one card; anything else
there is a ValueError (``check_tail``). On the CPU the tail is
``layer_tail_plain``, the eager composition. Both give the same bits: the
kernels do the eager chain's operations in its order, each rounded on its
own.

Counters, plain ints: ``layer_tail_fwd.launches`` and
``layer_tail_bwd.launches``; ``tail_counts()`` reads them and
``reset_tail_counts()`` zeroes them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from relgat_projector_tpu_torch.ops.cuda.build import entry_point
from relgat_projector_tpu_torch.ops.cuda.fused import (
    _aligned,
    _raise_on,
    _stream,
)

# csrc/layer_tail.cu dtype codes of the output and the cotangent
ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def layer_tail_plain(agg, keep, rate, elu, out_dtype) -> torch.Tensor:
    """The tail as eager PyTorch ops."""
    out = agg
    if keep is not None:
        out = out * keep / (1.0 - rate)
    if elu:
        out = F.elu(out)
    return out.to(out_dtype)


def layer_tail_fwd(agg: torch.Tensor, keep: Optional[torch.Tensor],
                   rate: float, elu: bool,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The output in ``out_dtype`` from fp32 ``agg`` and ``keep`` (None: no
    dropout), contiguous on the card."""
    _on_card(agg)
    check_tail(agg, keep, out_dtype)
    out = torch.empty(agg.shape, dtype=out_dtype, device=agg.device)
    ptrs = [t for t in (agg, keep, out) if t is not None]
    rc = entry_point("layer_tail_fwd")(
        agg.data_ptr(), 0 if keep is None else keep.data_ptr(),
        out.data_ptr(), agg.numel(), 1.0 - rate, int(elu),
        ROW_TYPES[out_dtype], int(_aligned(*ptrs)), _stream(),
    )
    _raise_on(rc, "layer_tail_fwd")
    layer_tail_fwd.launches += 1
    return out


def layer_tail_bwd(g: torch.Tensor, keep: Optional[torch.Tensor],
                   agg: Optional[torch.Tensor], rate: float,
                   elu: bool) -> torch.Tensor:
    """fp32 ``dagg`` from the cotangent ``g`` (fp32, bf16 or fp16),
    ``keep`` (None: no dropout) and, with ``elu``, the forward's ``agg``,
    contiguous on the card."""
    _on_card(g)
    check_cotangent(g, keep, agg if elu else None)
    dagg = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    ptrs = [t for t in (g, keep, agg if elu else None, dagg) if t is not None]
    rc = entry_point("layer_tail_bwd")(
        g.data_ptr(), 0 if keep is None else keep.data_ptr(),
        agg.data_ptr() if elu else 0, dagg.data_ptr(), g.numel(),
        1.0 - rate, int(elu), ROW_TYPES[g.dtype], int(_aligned(*ptrs)),
        _stream(),
    )
    _raise_on(rc, "layer_tail_bwd")
    layer_tail_bwd.launches += 1
    return dagg


class _LayerTail(torch.autograd.Function):
    """The tail over ``agg``; keeps ``keep`` and, where the ELU runs,
    ``agg`` for the backward (which recomputes the ELU's input)."""

    @staticmethod
    def forward(ctx, agg, keep, rate, elu, out_dtype):
        out = layer_tail_fwd(agg, keep, rate, elu, out_dtype)
        ctx.save_for_backward(keep, agg if elu else None)
        ctx.rate, ctx.elu = rate, elu
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        keep, agg = ctx.saved_tensors
        dagg = layer_tail_bwd(g.contiguous(), keep, agg, ctx.rate, ctx.elu)
        return dagg, None, None, None, None


def _on_card(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"layer_tail: the kernels run on a CUDA card, not "
                         f"on {t.device}")


def _check(t: torch.Tensor, name: str, like: torch.Tensor, types) -> None:
    if t.device != like.device or t.dtype not in types \
            or t.shape != like.shape or not t.is_contiguous():
        raise ValueError(
            f"layer_tail: {name} is {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ', not contiguous'}; the kernels "
            f"take a contiguous {' or '.join(map(str, types))} of shape "
            f"{tuple(like.shape)} on {like.device}")


def check_tail(agg, keep, out_dtype) -> None:
    """The forward kernel's gate: a ValueError naming what it does not
    take."""
    _check(agg, "agg", agg, (torch.float32,))
    if agg.numel() == 0:
        raise ValueError("layer_tail: agg is empty")
    if keep is not None:
        _check(keep, "keep", agg, (torch.float32,))
    if out_dtype not in ROW_TYPES:
        raise ValueError(
            f"layer_tail: output of {out_dtype}; the kernels write "
            f"{', '.join(map(str, ROW_TYPES))}")


def check_cotangent(g, keep, agg) -> None:
    """The backward kernel's gate."""
    _check(g, "the cotangent", g, tuple(ROW_TYPES))
    if g.numel() == 0:
        raise ValueError("layer_tail: the cotangent is empty")
    for name, t in (("keep", keep), ("agg", agg)):
        if t is not None:
            _check(t, name, g, (torch.float32,))


def layer_tail(
    agg: torch.Tensor, keep: Optional[torch.Tensor], rate: float, *,
    elu: bool, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``agg * keep / (1 - rate)`` (``keep`` None: no dropout), then the ELU
    where ``elu``, in ``out_dtype``. On the card: the kernels, for what
    ``check_tail`` passes; nothing launches where there is nothing to do
    (no dropout, no ELU, fp32 out). On the CPU: ``layer_tail_plain``."""
    if not agg.is_cuda:
        return layer_tail_plain(agg, keep, rate, elu, out_dtype)
    if keep is None and not elu and out_dtype == agg.dtype:
        return agg
    if torch.is_grad_enabled() and agg.requires_grad:
        return _LayerTail.apply(agg, keep, rate, elu, out_dtype)
    return layer_tail_fwd(agg, keep, rate, elu, out_dtype)


layer_tail_fwd.launches = 0
layer_tail_bwd.launches = 0


def tail_counts() -> dict:
    return {
        "layer_tail_fwd": layer_tail_fwd.launches,
        "layer_tail_bwd": layer_tail_bwd.launches,
    }


def reset_tail_counts() -> None:
    layer_tail_fwd.launches = 0
    layer_tail_bwd.launches = 0
