"""Deterministic per-(edge, head) attention-dropout masks.

Port of ``relgat_projector_tpu/ops/dropout.py``, bit for bit: an fmix32 hash
of ``(seed, canonical edge id, head)``. The JAX code uses int32 with wrapping
multiplies and logical right shifts; here the same bits are computed as
uint32 values held in int64 tensors (``>>`` on a non-negative int64 is a
logical shift), with every product reduced mod 2**32 before it can overflow.
The CUDA kernels replay the same hash in ``csrc/relgat_common.cuh``.

The JAX package derives the seed from a PRNG key (``seed_from_key``); the
port draws its int32 seed from its own generator (``utils/rng.py``).
"""

from __future__ import annotations

import torch

_GOLD = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF
_MASK31 = 0x7FFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for ``a`` in ``[0, 2**32)``, without int64
    overflow: split ``b`` into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """31-bit keep threshold for a drop probability ``rate``."""
    return int((1.0 - float(rate)) * _MASK31)


def edge_keep_mask_all_heads(
    edge_ids: torch.Tensor,  # [E] integer
    heads: int,
    seed: int,
    rate: float,
) -> torch.Tensor:
    """``[E, H]`` float32 keep mask, equal to the JAX function's."""
    eids = edge_ids.to(torch.int64) & _MASK32
    h_idx = torch.arange(heads, dtype=torch.int64, device=edge_ids.device)
    x = (
        _mul32(eids, _GOLD)[:, None]
        + (int(seed) & _MASK32)
        + _mul32(h_idx, _MIX2)[None, :]
    ) & _MASK32
    u = _fmix(x) & _MASK31
    return (u < keep_threshold(rate)).to(torch.float32)
