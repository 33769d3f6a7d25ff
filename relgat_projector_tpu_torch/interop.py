"""Carry parameters from the JAX package into this one.

``params_from_jax(tree)`` takes the pytree that ``relgat_projector_tpu``'s
``init_model`` returns (or a trained one), as numpy arrays or anything
``np.asarray`` accepts, and returns this package's parameters: the same
nested layout, float32 tensors on ``device``. Both packages then compute the
same function on the same weights. Nothing of JAX is imported here; convert
with ``jax.device_get`` first.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from relgat_projector_tpu_torch.device import DeviceLike, resolve_device
from relgat_projector_tpu_torch.utils.tree import tree_map


def params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(
            np.array(a, dtype=np.float32, copy=True)
        ).to(dev),
        tree,
    )
