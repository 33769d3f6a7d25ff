"""Projection head: GAT output space -> frozen input-embedding space.

Port of ``relgat_projector_tpu/models/projection.py``: no layers and equal
dims is the identity; one layer is a bias-free linear; ``k >= 2`` layers are
``k - 1`` blocks of ``linear -> exact GELU -> LayerNorm(eps 1e-5)`` then a
final linear; trailing dropout. Weights are ``[in, out]`` (``x @ W``); each
linear takes its operands in ``compute_dtype`` and gives fp32, and GELU,
LayerNorm and dropout run in fp32. On the card each GELU -> LayerNorm is
one fused function (``ops/cuda/gelu_layernorm.py``) that writes its output
already in a bf16 or fp16 ``compute_dtype``, the next linear's operand.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from relgat_projector_tpu_torch.device import compute_matmul, operand_dtype
from relgat_projector_tpu_torch.models.initializers import torch_linear_uniform
from relgat_projector_tpu_torch.ops.cuda.gelu_layernorm import gelu_layer_norm
from relgat_projector_tpu_torch.utils.profiling import span
from relgat_projector_tpu_torch.utils.rng import RngStreams


def _resolved_hidden(in_dim: int, hidden_dim: int) -> int:
    return hidden_dim if hidden_dim and hidden_dim > 0 else in_dim


def init_projection_head(
    generator: torch.Generator,
    in_dim: int,
    out_dim: int,
    num_layers: int,
    *,
    hidden_dim: int = 0,
) -> Dict[str, list]:
    num_layers = max(0, int(num_layers))
    hidden = _resolved_hidden(in_dim, hidden_dim)
    if num_layers == 0 and in_dim == out_dim:
        return {"linears": [], "ln_scale": [], "ln_bias": []}
    if num_layers <= 1:
        return {
            "linears": [
                torch_linear_uniform(generator, (in_dim, out_dim), fan_in=in_dim)
            ],
            "ln_scale": [],
            "ln_bias": [],
        }
    linears = [torch_linear_uniform(generator, (in_dim, hidden), fan_in=in_dim)]
    for _ in range(num_layers - 2):
        linears.append(
            torch_linear_uniform(generator, (hidden, hidden), fan_in=hidden)
        )
    linears.append(
        torch_linear_uniform(generator, (hidden, out_dim), fan_in=hidden)
    )
    n_ln = num_layers - 1
    return {
        "linears": linears,
        "ln_scale": [torch.ones((hidden,)) for _ in range(n_ln)],
        "ln_bias": [torch.zeros((hidden,)) for _ in range(n_ln)],
    }


def head_operand(params: Dict[str, list],
                 compute_dtype: torch.dtype) -> torch.dtype:
    """The type the head reads its input in: its first linear's operand
    type, or fp32 where it has no linear (the identity)."""
    return operand_dtype(compute_dtype) if params["linears"] else torch.float32


def apply_projection_head(
    params: Dict[str, list],
    x: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    train: bool = False,
    rng: Optional[RngStreams] = None,
    compute_dtype: torch.dtype = torch.float32,
    rows: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """The head over ``x``'s rows. ``rows = (total, lo, hi)``: ``x`` holds
    rows ``[lo, hi)`` of ``total`` (a graph shard's), and the dropout mask
    is drawn for all of them and sliced."""
    with span("relgat/head"):
        n_ln = len(params["ln_scale"])
        operand = operand_dtype(compute_dtype)
        y = x
        for i, w in enumerate(params["linears"]):
            y = compute_matmul(y, w, compute_dtype)
            if i < n_ln:  # every layer but the last: GELU -> LayerNorm
                y = gelu_layer_norm(y, params["ln_scale"][i],
                                    params["ln_bias"][i], operand)
        if train and dropout_rate > 0.0 and rng is not None:
            shape = y.shape if rows is None else (rows[0], y.shape[1])
            keep = y.new_empty(shape).bernoulli_(
                1.0 - dropout_rate, generator=rng.device
            )
            if rows is not None:
                keep = keep[rows[1]:rows[2]]
            y = y * keep / (1.0 - dropout_rate)
        return y
