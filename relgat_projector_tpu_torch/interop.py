"""Carry parameters from the JAX package into this one.

``params_from_jax(tree)`` takes the pytree that ``relgat_projector_tpu``'s
``init_model`` returns (or a trained one), as numpy arrays or anything
``np.asarray`` accepts, and returns this package's parameters: the same
nested layout, tensors on ``device``, each leaf in its own floating type:
float32 stays float32, and bfloat16 (``ml_dtypes.bfloat16`` in numpy) comes
across as ``torch.bfloat16`` through float32, which holds every bf16 value
exactly. Both packages then compute the same function on the same weights.
Nothing of JAX is imported here; convert with ``jax.device_get`` first.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from relgat_projector_tpu_torch.device import DeviceLike, resolve_device
from relgat_projector_tpu_torch.utils.tree import tree_map


def _leaf(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.to(dev, torch.bfloat16 if bf16 else torch.float32)


def params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree)
