"""Deterministic seeding (reference ``utils/random_seed.py:9-25``).

``RandomSeed(seed)`` seeds Python's ``random`` and numpy for host-side work
(splits, synthetic data) and hands out the seeds of the port's generators.
The JAX package splits one root key ``PRNGKey(seed)`` into an init key and
a train key; no torch generator reproduces those streams, so the port
derives independent seeds from ``seed`` instead, each a 32-bit word of
numpy's ``SeedSequence`` over a fixed entropy tuple:

- ``init_seed``  = ``SeedSequence([seed, 0])``: ``init_model(..., seed=)``;
- ``train_seed`` = ``SeedSequence([seed, 1])``: ``create_train_state(...,
  seed=)``, whose ``RngStreams`` draw dropout and negatives;
- ``eval_seed(step)`` = ``SeedSequence([seed, 2**30, step])``: the
  negatives of an evaluation at ``step``. The train streams are never drawn
  from during evaluation, so an evaluation leaves training unchanged (the
  JAX package folds ``2**30`` into the train key for the same reason).
"""

from __future__ import annotations

import random

import numpy as np

_EVAL_TAG = 2**30


def _derive(*words: int) -> int:
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint32
    )
    return int(state[0])


class RandomSeed:
    def __init__(self, seed: int, auto_set_seed: bool = True):
        self.seed = int(seed)
        if auto_set_seed:
            self.set_random_state()

    def set_random_state(self) -> None:
        random.seed(self.seed)
        np.random.seed(self.seed)

    @property
    def init_seed(self) -> int:
        return _derive(self.seed, 0)

    @property
    def train_seed(self) -> int:
        return _derive(self.seed, 1)

    def eval_seed(self, step: int) -> int:
        return _derive(self.seed, _EVAL_TAG, step)
