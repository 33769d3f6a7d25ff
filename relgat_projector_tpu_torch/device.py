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


def set_fp32_matmul_highest() -> None:
    """fp32 "highest" mode: no TF32 anywhere (the Hopper form of the JAX
    package's rule to pass HIGHEST precision for fp32 parity)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
