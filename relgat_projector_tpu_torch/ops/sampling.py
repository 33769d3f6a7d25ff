"""Negative sampling on the device (port of ``ops/sampling.py``).

Uniform over the ``num_nodes - 1`` nodes other than the true destination,
by the shift trick: draw ``c ~ U[0, N-1)`` and add 1 where ``c >= dst``.
"""

from __future__ import annotations

import torch


def sample_negative_dst(
    generator: torch.Generator,
    dst: torch.Tensor,  # [B] true destination ids (< num_nodes)
    num_nodes: int,
    num_neg: int,
) -> torch.Tensor:
    """Corrupted destinations ``[B, num_neg]`` with ``neg != dst``."""
    c = torch.randint(
        0, num_nodes - 1, (dst.shape[0], num_neg),
        generator=generator, device=dst.device, dtype=dst.dtype,
    )
    return c + (c >= dst[:, None]).to(dst.dtype)
