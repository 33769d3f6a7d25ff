"""Parameter initializers with torch fan semantics (port of
``models/initializers.py``): the distributions match the JAX package's, the
bits do not (``params_from_jax`` carries exact weights across)."""

from __future__ import annotations

import math

import torch


def xavier_uniform(
    generator: torch.Generator, shape, fan_in: int, fan_out: int
) -> torch.Tensor:
    """U(-a, a) with ``a = sqrt(6 / (fan_in + fan_out))``."""
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-a, a, generator=generator)


def torch_linear_uniform(
    generator: torch.Generator, shape, fan_in: int
) -> torch.Tensor:
    """torch ``nn.Linear`` default weight init: U(-1/sqrt(fan_in), +)."""
    a = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape).uniform_(-a, a, generator=generator)
