"""Train state and a hand-written Adam (port of ``train/state.py``).

The JAX package chains optax transforms; here the same chain is one plain
function on tensors, in the same order and with the same formulas:

1. optional global-norm clipping, optax's formula: ``g * max_norm / ||g||``
   when ``||g|| >= max_norm`` (``clip_grad_norm_`` would add 1e-6);
2. ``adam``: L2 folded into the gradient BEFORE the moments (torch-Adam
   semantics); ``adamw``: decay added after the Adam direction;
3. Adam with b1 0.9, b2 0.999, eps 1e-8 and bias correction at the
   incremented count;
4. ``-lr(count)`` times the update, ``count`` counting applied updates.

``torch.optim.Adam`` is not used: its step count advances on every call,
while a skipped non-finite step here must leave the count (and with it the
bias correction and the schedule) where it was.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from relgat_projector_tpu_torch.config import TrainConfig
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    mu: Any
    nu: Any
    count: torch.Tensor  # int32, updates applied


@dataclasses.dataclass(frozen=True)
class Optimizer:
    kind: str                       # "adam" | "adamw"
    weight_decay: float
    grad_clip_norm: Optional[float]
    lr_schedule: Callable

    def init(self, params: Any) -> AdamState:
        device = tree_leaves(params)[0].device
        return AdamState(
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(self, grads: Any, state: AdamState, params: Any):
        """``(new_params, new_state)``; nothing is modified in place."""
        if self.grad_clip_norm is not None:
            g_norm = global_norm(grads)
            max_norm = float(self.grad_clip_norm)
            grads = tree_map(
                lambda g: torch.where(g_norm < max_norm, g, g / g_norm * max_norm),
                grads,
            )
        wd = float(self.weight_decay)
        if self.kind == "adam" and wd:
            grads = tree_map(lambda g, p: g + wd * p, grads, params)
        mu = tree_map(lambda g, m: (1 - _B1) * g + _B1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - _B2) * g.square() + _B2 * v, grads, state.nu)
        count = state.count + 1
        c = count.to(torch.float32)
        # A Python base, not a tensor made on the device: copying a host
        # value to the card would wait for the stream every step.
        bc1 = 1 - torch.pow(_B1, c)
        bc2 = 1 - torch.pow(_B2, c)
        upd = tree_map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + _EPS), mu, nu
        )
        if self.kind == "adamw" and wd:
            upd = tree_map(lambda u, p: u + wd * p, upd, params)
        step_size = -self.lr_schedule(state.count)
        new_params = tree_map(lambda p, u: p + step_size * u, params, upd)
        return new_params, AdamState(mu=mu, nu=nu, count=count)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(g.square().sum() for g in tree_leaves(tree)))


def make_optimizer(cfg: TrainConfig, lr_schedule: Callable) -> Optimizer:
    kind = cfg.optimizer.lower()
    if kind not in ("adam", "adamw"):
        raise ValueError(f"Unknown optimizer: {cfg.optimizer}")
    return Optimizer(
        kind=kind,
        weight_decay=float(cfg.weight_decay or 0.0),
        grad_clip_norm=cfg.grad_clip_norm,
        lr_schedule=lr_schedule,
    )


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: AdamState
    step: torch.Tensor             # int32 count of successful steps
    rng: RngStreams
    nonfinite_steps: torch.Tensor  # int32 count of skipped steps


def create_train_state(
    params: Any, optimizer: Optimizer, *, seed: int = 0, step: int = 0
) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.tensor(step, dtype=torch.int32, device=device),
        rng=RngStreams.from_seed(seed, device),
        nonfinite_steps=torch.zeros((), dtype=torch.int32, device=device),
    )
