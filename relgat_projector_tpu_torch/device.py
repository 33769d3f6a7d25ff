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


def compute_matmul(
    x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype
) -> torch.Tensor:
    """``x @ w`` as fp32. With a bf16 ``compute_dtype`` the operands are
    rounded to bf16 and the product runs on the tensor cores, summed in fp32
    (``set_matmul_precision``); it comes back as bf16 and is widened, one
    rounding more than the JAX package's fp32-typed product."""
    if compute_dtype == torch.float32:
        return x @ w
    return (x.to(compute_dtype) @ w.to(compute_dtype)).float()
