"""The port's attention-dropout hash is bit-exact against the JAX one.

The JAX hash uses wrapping int32 multiplies and logical shifts; the port
computes the same uint32 bits in int64. Equality is exact: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.ops.dropout import (
    edge_keep_mask_all_heads as jax_mask,
    keep_threshold as jax_threshold,
)
from relgat_projector_tpu_torch.ops.dropout import (
    edge_keep_mask_all_heads,
    keep_threshold,
)

SEEDS = (-(2**31), -123456789, -1, 0, 1, 987654321, 2**31 - 1)


@pytest.mark.parametrize("rate", (0.1, 0.3, 0.9))
@pytest.mark.parametrize("seed", SEEDS)
def test_mask_bit_exact(rate, seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    eids = np.concatenate([
        rng.integers(0, 2**31 - 1, 3000),
        np.arange(64),
        [2**31 - 1, 2**31 - 2],
    ]).astype(np.int32)
    heads = 16
    want = np.asarray(jax_mask(jnp.asarray(eids), heads, jnp.int32(seed), rate))
    got = edge_keep_mask_all_heads(
        torch.from_numpy(eids), heads, seed, rate
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1.0 - rate)) < 0.02


@pytest.mark.parametrize("rate", (0.0, 0.1, 0.3, 0.5, 0.9, 1.0))
def test_keep_threshold_matches(rate):
    assert keep_threshold(rate) == jax_threshold(rate)
