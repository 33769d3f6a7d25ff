"""The projection head's ``exact GELU -> LayerNorm(eps 1e-5)`` block.

``gelu_layer_norm`` is what ``models/projection.py`` calls for every hidden
block of the head. On the card it runs the hand-written kernels of
``csrc/gelu_layernorm.cu`` as one autograd function:
``gelu_layer_norm_fwd`` (z, and a mean and reciprocal standard deviation a
row, from one read of ``y``) and ``gelu_layer_norm_bwd`` (dy from one read
of dz and ``y``, with the scale and bias gradients summed in a fixed
order). They take a contiguous fp32 ``y`` at most ``MAX_WIDTH`` wide with
fp32, bf16 or fp16 ``scale`` and ``bias``; anything else on the card is a
ValueError naming the limit (``check_block``). On the CPU the block is
``gelu_layer_norm_plain``, the eager composition. Both compute in fp32;
the kernels write z already in the next product's operand type when that
is bf16 or fp16 (rounded to nearest even, as ``compute_matmul``'s cast
rounds), which saves the product's cast. The values differ from the plain
composition only through the order of the row sums.

Counters, plain ints: ``gelu_layer_norm_fwd.launches`` and
``gelu_layer_norm_bwd.launches``; ``head_counts()`` reads them and
``reset_head_counts()`` zeroes them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from relgat_projector_tpu_torch.ops.cuda.build import entry_point
from relgat_projector_tpu_torch.ops.cuda.fused import _raise_on, _stream

# csrc/gelu_layernorm.cu: 4 * kMaxChunks * kMaxThreads, kBwdMaxBlocks
MAX_WIDTH = 8192
BWD_MAX_BLOCKS = 2048
# csrc/gelu_layernorm.cu dtype codes of z and dz
ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias


def gelu_layer_norm_plain(y, scale, bias) -> torch.Tensor:
    """``LayerNorm(GELU(y))`` as eager PyTorch ops, fp32 for fp32 ``y``."""
    return _layer_norm(F.gelu(y, approximate="none"), scale, bias)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def gelu_layer_norm_fwd(
    y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(z [n, d] in out_dtype, mean [n], rstd [n])`` of fp32 ``y [n, d]``
    and fp32 ``scale``, ``bias [d]``, all contiguous on the card."""
    n, d = y.shape
    z = torch.empty((n, d), dtype=out_dtype, device=y.device)
    mean = torch.empty((n,), dtype=torch.float32, device=y.device)
    rstd = torch.empty_like(mean)
    vec = d % 4 == 0 and _aligned(y, scale, bias, z)
    rc = entry_point("gelu_ln_fwd")(
        y.data_ptr(), scale.data_ptr(), bias.data_ptr(), z.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), n, d, ROW_TYPES[out_dtype],
        int(vec), _stream(),
    )
    _raise_on(rc, "gelu_layer_norm_fwd")
    gelu_layer_norm_fwd.launches += 1
    return z, mean, rstd


def gelu_layer_norm_bwd(
    dz: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dy [n, d], dscale [d], dbias [d])``, fp32, from ``dz`` (fp32,
    bf16 or fp16), the forward's fp32 ``y``, fp32 ``scale`` and its
    ``mean`` and ``rstd``, all contiguous on the card."""
    n, d = y.shape
    dy = torch.empty_like(y)
    part = torch.empty((min(n, BWD_MAX_BLOCKS), 2, d), dtype=torch.float32,
                       device=y.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=y.device)
    dbias = torch.empty_like(dscale)
    vec = d % 4 == 0 and _aligned(dz, y, scale, dy, part)
    rc = entry_point("gelu_ln_bwd")(
        dz.data_ptr(), y.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dy.data_ptr(), part.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), n, d, ROW_TYPES[dz.dtype], int(vec), _stream(),
    )
    _raise_on(rc, "gelu_layer_norm_bwd")
    gelu_layer_norm_bwd.launches += 1
    return dy, dscale, dbias


class _GeluLayerNorm(torch.autograd.Function):
    """The fused block over ``y [n, d]``; ``scale`` and ``bias`` widened to
    fp32 as the plain composition widens them, their gradients returned
    in their own types."""

    @staticmethod
    def forward(ctx, y, scale, bias, out_dtype):
        z, mean, rstd = gelu_layer_norm_fwd(y, _widened(scale),
                                            _widened(bias), out_dtype)
        ctx.save_for_backward(y, scale, mean, rstd)
        ctx.bias_dtype = bias.dtype
        return z

    @staticmethod
    @once_differentiable
    def backward(ctx, dz):
        y, scale, mean, rstd = ctx.saved_tensors
        dy, dscale, dbias = gelu_layer_norm_bwd(
            dz.contiguous(), y, _widened(scale), mean, rstd)
        return dy, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


def _widened(t: torch.Tensor) -> torch.Tensor:
    """``scale`` or ``bias`` as the dense fp32 array the kernels read."""
    return t.float().contiguous()


def check_block(y, scale, bias, out_dtype) -> None:
    """The kernels' gate: a ValueError naming what they do not take."""
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError(
            f"gelu_layer_norm: y is {y.dtype}"
            f"{'' if y.is_contiguous() else ', not contiguous'}; the kernels "
            f"read a contiguous fp32 y (compute_matmul's output)")
    d = y.shape[-1] if y.dim() else 0
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(
            f"gelu_layer_norm: width {d} is outside the kernels' 1 to "
            f"{MAX_WIDTH}: a thread holds at most 4 * 8 values of a row of "
            f"at most 256 threads (csrc/gelu_layernorm.cu kMaxChunks)")
    if not 0 < y.numel() // d < 2**31:
        raise ValueError(
            f"gelu_layer_norm: {y.numel() // d} rows; the kernels take 1 "
            f"to 2**31 - 1")
    if out_dtype not in ROW_TYPES:
        raise ValueError(
            f"gelu_layer_norm: z of {out_dtype}; the kernels write "
            f"{', '.join(map(str, ROW_TYPES))}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != y.device or t.dtype not in ROW_TYPES \
                or t.shape != (d,):
            raise ValueError(
                f"gelu_layer_norm: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}; the kernels take fp32, bf16 or fp16 of shape "
                f"({d},) on {y.device}")


def gelu_layer_norm(
    y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``LayerNorm(GELU(y)) * scale + bias`` over ``y``'s last dimension.
    On the card: the fused kernels, z in ``out_dtype`` (fp32, bf16 or
    fp16), for what ``check_block`` passes. On the CPU:
    ``gelu_layer_norm_plain``, fp32."""
    if not y.is_cuda:
        return gelu_layer_norm_plain(y, scale, bias)
    check_block(y, scale, bias, out_dtype)
    y2 = y.view(-1, y.shape[-1])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, scale, bias)):
        z = _GeluLayerNorm.apply(y2, scale, bias, out_dtype)
    else:  # nothing to differentiate: keep nothing for a backward
        z = gelu_layer_norm_fwd(y2, _widened(scale), _widened(bias),
                                out_dtype)[0]
    return z.view(y.shape)


gelu_layer_norm_fwd.launches = 0
gelu_layer_norm_bwd.launches = 0


def head_counts() -> dict:
    return {
        "gelu_layer_norm_fwd": gelu_layer_norm_fwd.launches,
        "gelu_layer_norm_bwd": gelu_layer_norm_bwd.launches,
    }


def reset_head_counts() -> None:
    gelu_layer_norm_fwd.launches = 0
    gelu_layer_norm_bwd.launches = 0
