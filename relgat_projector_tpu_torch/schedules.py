"""Learning-rate schedules with linear warmup (port of ``schedules.py``).

``schedule(step)`` maps the 0-indexed optimizer step (an int or a 0-d
tensor, on any device) to the absolute learning rate as a float32 tensor:
linear / cosine / constant after warmup, times an optional
``lr_decay ** max(0, step - warmup)``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from relgat_projector_tpu_torch.config import Defaults


def compute_total_and_warmup_steps(
    num_train_examples: int,
    batch_size: int,
    epochs: int,
    warmup_steps: Optional[int],
    warmup_ratio: float = Defaults.DEFAULT_WARMUP_RATIO,
):
    steps_per_epoch = max(1, math.ceil(num_train_examples / batch_size))
    total_steps = steps_per_epoch * max(1, int(epochs))
    if warmup_steps is None:
        warmup_steps = int(warmup_ratio * total_steps)
    warmup_steps = min(int(warmup_steps), max(0, total_steps - 1))
    return total_steps, warmup_steps


def make_lr_schedule(
    base_lr: float,
    scheduler_type: str,
    total_steps: int,
    warmup_steps: int,
    lr_decay: float = 1.0,
) -> Callable:
    scheduler_type = scheduler_type.lower()
    if scheduler_type not in ("linear", "cosine", "constant"):
        raise ValueError(f"Unknown lr_scheduler type: {scheduler_type}")
    ws = float(warmup_steps)
    ts = float(total_steps)

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(1.0, ws)
        if scheduler_type == "linear":
            after = ((ts - step) / max(1.0, ts - ws)).clamp_min(0.0)
        elif scheduler_type == "cosine":
            progress = ((step - ws) / max(1.0, ts - ws)).clamp(0.0, 1.0)
            after = 0.5 * (1.0 + torch.cos(math.pi * progress))
        else:
            after = torch.ones_like(step)
        mult = torch.where(step < ws, warm, after)
        if lr_decay != 1.0:
            mult = mult * torch.pow(float(lr_decay), (step - ws).clamp_min(0.0))
        return base_lr * mult

    return schedule
