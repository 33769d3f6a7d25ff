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
    package's rule to pass HIGHEST precision for fp32 parity), and bf16
    products summed in fp32 throughout: cuBLAS may otherwise round the
    partial sums of a split-K bf16 product to bf16, where the JAX package
    asks for ``preferred_element_type=float32``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype):
    """The product of two bf16 matrices, multiplied exactly (8-bit by 8-bit
    significands), summed in fp32 and returned as ``out_dtype`` (fp32, or
    rounded once to bf16). On the card one tensor-core product, with an
    fp32 output through ``out_dtype``; on the CPU, which has no kernel for
    ``out_dtype``, the product of the widened operands."""
    if a.is_cuda:
        if out_dtype == torch.float32:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a, b)
    return (a.float() @ b.float()).to(out_dtype)


class _Bf16MatMul(torch.autograd.Function):
    """``x [M, K] @ w [K, N]`` on bf16 operands with an fp32 result: the
    JAX package's ``dot(x.astype(bf16), w.astype(bf16),
    preferred_element_type=float32)`` and its VJP. In that VJP's jaxpr each
    backward product takes the cotangent against the other bf16 operand,
    sums in fp32 and is rounded to bf16 (the type of the operand it
    differentiates) before the cast back to fp32; so are dx and dw here.
    The cotangent itself is rounded to bf16 here, the operand type of the
    tensor cores (and of a TPU's one-pass product at default precision);
    JAX on the CPU keeps it fp32, the one rounding the two still differ
    by."""

    @staticmethod
    def forward(ctx, x, w):
        x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(x16, w16)
        return _mm(x16, w16, torch.float32)

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm(g16, w16.t(), torch.bfloat16).float()
        if ctx.needs_input_grad[1]:
            dw = _mm(x16.t(), g16, torch.bfloat16).float()
        return dx, dw


def compute_matmul(
    x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype
) -> torch.Tensor:
    """``x @ w`` as fp32. With a bf16 ``compute_dtype`` the operands are
    rounded to bf16 and their product comes back in fp32, never rounded to
    bf16, as the JAX package's ``preferred_element_type=float32`` product:
    on the card one tensor-core product summed in fp32
    (``set_matmul_precision``), on the CPU the product of the widened
    operands. Leading dimensions of ``x`` are flattened for the product."""
    if compute_dtype == torch.float32:
        return x @ w
    lead = x.shape[:-1]
    y = _Bf16MatMul.apply(x.reshape(-1, x.shape[-1]), w)
    return y.view(*lead, w.shape[-1])
