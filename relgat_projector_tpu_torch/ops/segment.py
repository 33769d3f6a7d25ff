"""Segment sum, max and softmax over edge destinations (plain PyTorch).

Port of ``relgat_projector_tpu/ops/segment.py``: the stable softmax
subtracts the true per-destination max, a segment whose scores are all
``-inf`` takes a max of 0 (so ``exp(-inf - 0) = 0``, not NaN), and the
denominator is clamped at ``STABLE_SOFTMAX_EPS``. These are the model's
plain route: the CPU path, and on the card the route without the kernels
(``use_pallas=False``, the ``gspmd`` route).

Every op here gives the same bits on every call, as XLA's do: on the card
``segment_sum`` accumulates in sorted order (``index_put_``), since
``index_add_`` adds with atomics in whatever order the threads reach them.
A run that differs in its last bits can put an attention logit near 0 on
the other side of LeakyReLU's kink, and so move a whole block of the
attention bank's gradient.
"""

from __future__ import annotations

import torch

STABLE_SOFTMAX_EPS = 1e-16


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets; empty ones are 0."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    if data.is_cuda:
        return out.index_put_((segment_ids,), data, accumulate=True)
    return out.index_add_(0, segment_ids, data)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment max; empty segments are ``-inf``."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), -torch.inf)
    idx = segment_ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amax", include_self=True)


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    eps: float = STABLE_SOFTMAX_EPS,
) -> torch.Tensor:
    """``exp(s - max_d) / max(sum_d, eps)`` per segment, on ``[E]`` or
    ``[E, H]`` scores. The max is a shift the result does not depend on, so
    no gradient flows through it."""
    max_seg = segment_max(scores.detach(), segment_ids, num_segments)
    max_safe = torch.where(torch.isfinite(max_seg), max_seg, 0.0)
    w = torch.exp(scores - max_safe[segment_ids])
    denom = segment_sum(w, segment_ids, num_segments).clamp_min(eps)
    return w / denom[segment_ids]
