"""Device selection for the port's entry points.

An entry point given no device runs on the card. Without a card it raises:
the port never drops to the CPU on its own. Tests and CPU users pass
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_matmul_precision() -> None:
    """No TF32 anywhere for fp32 products (the Hopper form of the JAX
    package's rule to pass HIGHEST precision for fp32 parity), and bf16 and
    fp16 products summed in fp32 throughout: cuBLAS may otherwise round the
    partial sums of a split-K half-type product to the half type, where the
    JAX package asks for ``preferred_element_type=float32``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


HALF_TYPES = (torch.bfloat16, torch.float16)


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype):
    """The product of two matrices of one low-precision float type (or,
    in a float8 backward, of the fp32 cotangent and a widened float8
    operand), multiplied and summed in fp32 (two half-type operands
    multiply exactly) and returned as ``out_dtype`` (fp32, or rounded once
    to the low-precision type). A
    bf16 or fp16 product on the card is one tensor-core product, with an
    fp32 output through ``out_dtype``; elsewhere (the CPU, which has no
    kernel for ``out_dtype``, and float8, which ``torch.mm`` does not take)
    the product of the widened operands."""
    if a.is_cuda and a.dtype in HALF_TYPES:
        if out_dtype == torch.float32:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a, b)
    return (a.float() @ b.float()).to(out_dtype)


class _CastMatMul(torch.autograd.Function):
    """``x [M, K] @ w [K, N]`` on operands rounded to a low-precision float
    type (bf16, fp16 or a float8) with an fp32 result: the JAX package's
    ``dot(x.astype(t), w.astype(t), preferred_element_type=float32)`` and
    its VJP. In that VJP's jaxpr each backward product takes the cotangent
    against the other rounded operand, sums in fp32 and is rounded to ``t``
    (the type of the operand it differentiates) before the cast back to
    fp32; so are dx and dw here. For bf16 and fp16 the cotangent itself is
    rounded to ``t`` here, the operand type of the tensor cores (and of a
    TPU's one-pass product at default precision); JAX on the CPU keeps it
    fp32, the one rounding the two still differ by. A float8 product keeps
    the cotangent fp32, as JAX does."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        xq, wq = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xq, wq)
        return _mm(xq, wq, torch.float32)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        dtype = xq.dtype
        gq = g.to(dtype) if dtype in HALF_TYPES else g
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm(gq, wq.t().to(gq.dtype), dtype).float()
        if ctx.needs_input_grad[1]:
            dw = _mm(xq.t().to(gq.dtype), gq, dtype).float()
        return dx, dw, None


def _as_number(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` converted to the integer or boolean ``dtype`` as XLA converts
    it (NaN to 0, out-of-range values saturated, truncation toward zero;
    non-zero to true) and back to fp32. The conversion has no derivative,
    so no gradient flows through it, as in JAX."""
    if dtype == torch.bool:
        return (t != 0).float()
    info = torch.iinfo(dtype)
    q = t.double().nan_to_num(0.0).clamp(info.min, info.max).trunc()
    return q.float()


def compute_matmul(
    x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype
) -> torch.Tensor:
    """``x @ w`` as fp32, with the operands cast to ``compute_dtype`` as the
    JAX package casts them (``astype(compute_dtype)``, then a product with
    ``preferred_element_type=float32``). With a bf16 or fp16
    ``compute_dtype`` the operands are rounded to it and their product
    comes back in fp32, never rounded: on the card one tensor-core product
    summed in fp32 (``set_matmul_precision``), on the CPU the product of
    the widened operands; a float8 type is widened on the card too. A
    complex type holds the fp32 operands whole, so its product is the fp32
    one; an integer or boolean type converts them as XLA does and passes
    no gradient back. Leading dimensions of ``x`` are flattened for the
    product. Operands of another type (half-type parameters under an fp32
    ``compute_dtype``) are cast to ``compute_dtype`` first."""
    if compute_dtype in (torch.float32, torch.complex64):
        return x.float() @ w.float()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if compute_dtype.is_floating_point:
        y = _CastMatMul.apply(x2, w, compute_dtype)
    else:
        y = (_as_number(x2.detach(), compute_dtype)
             @ _as_number(w.detach(), compute_dtype))
    return y.view(*lead, w.shape[-1])
