"""The reference's ``state_dict`` key map, both ways.

The reference ecosystem saves its trained model as a flat torch
``state_dict`` named ``relgat-model.pt``. This module maps that dict onto
the parameter tree and back, in the reference's exact key layout
(reference module attribute -> tree)::

    gat_layer[s.{li}].proj.{h}.weight   layers[li]["proj"][h].T
    gat_layer[s.{li}].attn_vec.{h}      layers[li]["attn"][h]
    gat_layer[s.{li}].rel_bias          layers[li]["rel_bias"]
    projection.net[.{i}].weight         projection["linears"][j].T
    projection.net.{i}.weight/bias      LayerNorm scale/bias (i = 2, 5, ...)
    scorer.rel_emb.weight               scorer["rel_emb"]
    node_emb_fixed (buffer)             ignored: embeddings come from data

``gat_layer.`` names a one-layer model, ``gat_layers.{li}.`` a deeper one;
``projection.net.weight`` is the bare linear of a one-layer head. Leaves
keep their type both ways. ``models.model.save_pretrained`` /
``load_from_pretrained`` and the converters in ``interop`` all go through
here.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from relgat_projector_tpu_torch.config import Defaults

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> Any:
    """What ``relgat-model.pt`` (the file, or its checkpoint directory)
    holds, as CPU tensors of their saved types."""
    if os.path.isdir(path):
        path = os.path.join(path, Defaults.OUT_MODEL_NAME)
    return torch.load(path, map_location="cpu", weights_only=True)


def _layer_prefixes(sd: StateDict) -> list:
    """Ordered per-layer key prefixes (single- and multi-layer models)."""
    if any(k.startswith("gat_layer.") for k in sd):
        return ["gat_layer."]
    idx = sorted({
        int(m.group(1)) for k in sd if (m := re.match(r"gat_layers\.(\d+)\.", k))
    })
    if not idx:
        raise ValueError("No RelGAT layer weights found in state_dict")
    return [f"gat_layers.{i}." for i in idx]


def _projection_head(sd: StateDict) -> Optional[dict]:
    """The head's tree: a bare ``projection.net.weight``, or a Sequential of
    Linear (no bias) at 0, 3, ... and LayerNorm (with bias) at 2, 5, ..."""
    if "projection.net.weight" in sd:
        return {"linears": [sd["projection.net.weight"].T],
                "ln_scale": [], "ln_bias": []}
    seq_idx = sorted({
        int(m.group(1)) for k in sd
        if (m := re.match(r"projection\.net\.(\d+)\.weight", k))
    })
    if not seq_idx:
        return None
    names = [f"projection.net.{i}." for i in seq_idx]
    return {
        "linears": [sd[n + "weight"].T for n in names if n + "bias" not in sd],
        "ln_scale": [sd[n + "weight"] for n in names if n + "bias" in sd],
        "ln_bias": [sd[n + "bias"] for n in names if n + "bias" in sd],
    }


def params_from_state_dict(sd: StateDict) -> dict:
    """The parameter tree of a reference ``state_dict``: its tensors as they
    are (type and device), laid out as this package's."""
    layers = []
    for pre in _layer_prefixes(sd):
        h_idx = sorted({
            int(m.group(1)) for k in sd
            if (m := re.match(re.escape(pre) + r"proj\.(\d+)\.weight", k))
        })
        if not h_idx:
            raise ValueError(f"No per-head proj weights under {pre}")
        # torch Linear weight is [out, in]; the tree's is [in, out].
        layer = {
            "proj": torch.stack([sd[f"{pre}proj.{h}.weight"].T for h in h_idx]),
            "attn": torch.stack([sd[f"{pre}attn_vec.{h}"] for h in h_idx]),
        }
        if f"{pre}rel_bias" in sd:
            layer["rel_bias"] = sd[f"{pre}rel_bias"]
        layers.append(layer)
    params: dict = {"layers": layers}
    head = _projection_head(sd)
    if head is not None:
        params["projection"] = head
    if "scorer.rel_emb.weight" not in sd:
        raise ValueError("No scorer weights (scorer.rel_emb.weight) found")
    params["scorer"] = {"rel_emb": sd["scorer.rel_emb.weight"]}
    return params


def export_torch_state_dict(
    params: dict,
    *,
    node_emb: Optional[Any] = None,
) -> StateDict:
    """The reference module's exact ``state_dict`` for ``params``: CPU
    tensors, each leaf in its own type and in storage of its own, so
    ``torch.save`` writes no more than the dict holds. ``node_emb``
    (``[N, in_dim]``) fills the reference's ``node_emb_fixed`` buffer so
    ``load_state_dict(strict=True)`` succeeds on a model built with the same
    graph; without it the key is left out."""

    def t(a: torch.Tensor) -> torch.Tensor:
        return a.detach().to("cpu").clone(memory_format=torch.contiguous_format)

    sd: StateDict = {}
    if node_emb is not None:
        emb = (node_emb if isinstance(node_emb, torch.Tensor)
               else torch.from_numpy(np.asarray(node_emb, np.float32)))
        sd["node_emb_fixed"] = t(emb.float())
    layers = params["layers"]
    for li, layer in enumerate(layers):
        pre = f"gat_layers.{li}." if len(layers) > 1 else "gat_layer."
        for h in range(layer["proj"].shape[0]):
            sd[f"{pre}proj.{h}.weight"] = t(layer["proj"][h].T)
            sd[f"{pre}attn_vec.{h}"] = t(layer["attn"][h])
        if "rel_bias" in layer:
            sd[f"{pre}rel_bias"] = t(layer["rel_bias"])

    linears = params.get("projection", {}).get("linears", [])
    if len(linears) == 1:
        # A one-layer head (or a bare dim change): the Linear named ``net``.
        sd["projection.net.weight"] = t(linears[0].T)
    else:
        # Blocks Linear(3j) -> GELU(3j+1) -> LayerNorm(3j+2), then a Linear.
        head = params.get("projection", {})
        for j, w in enumerate(linears):
            sd[f"projection.net.{3 * j}.weight"] = t(w.T)
            if j < len(linears) - 1:
                sd[f"projection.net.{3 * j + 2}.weight"] = t(head["ln_scale"][j])
                sd[f"projection.net.{3 * j + 2}.bias"] = t(head["ln_bias"][j])

    sd["scorer.rel_emb.weight"] = t(params["scorer"]["rel_emb"])
    return sd
