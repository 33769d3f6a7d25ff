"""RelGAT layer: multi-head relational graph attention, heads vectorized.

Port of ``relgat_projector_tpu/models/layer.py``. Parameters keep the JAX
layout: ``proj [H, in, F]``, ``attn [H, R, F]``, optional ``rel_bias [R]``.
One ``[N, in] x [in, H*F]`` product projects every head; it stays
``torch.matmul`` (the JAX package leaves it to XLA), with its operands in
``compute_dtype`` and an fp32 result. The layer's random draws are made by
``draw_layer_randomness`` before it runs and passed in, so that remat can
recompute it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from relgat_projector_tpu_torch.data.graph import GraphData
from relgat_projector_tpu_torch.device import compute_matmul
from relgat_projector_tpu_torch.models.initializers import xavier_uniform
from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate
from relgat_projector_tpu_torch.utils.rng import RngStreams


def init_relgat_layer(
    generator: torch.Generator,
    in_dim: int,
    out_dim: int,
    num_rel: int,
    heads: int,
    *,
    use_bias: bool = True,
) -> Dict[str, torch.Tensor]:
    params = {
        "proj": xavier_uniform(
            generator, (heads, in_dim, out_dim), fan_in=in_dim, fan_out=out_dim
        ),
        "attn": xavier_uniform(
            generator, (heads, num_rel, out_dim), fan_in=out_dim,
            fan_out=num_rel,
        ),
    }
    if use_bias:
        params["rel_bias"] = torch.zeros((num_rel,))
    return params


def draw_layer_randomness(
    rng: Optional[RngStreams],
    shape,
    *,
    dropout_rate: float,
    attn_dropout_rate: float,
    train: bool,
    device: torch.device,
) -> Tuple[Optional[int], Optional[torch.Tensor]]:
    """The layer's random draws, made before the layer runs: the
    attention-dropout seed from the host generator and the output-dropout
    keep mask ``[N, H*F]`` (fp32 0/1) from the device generator, each None
    where that dropout is off. In the order the layer has always drawn
    them, so a layer run under remat (``torch.utils.checkpoint``, whose
    recompute would otherwise draw again from these custom generators) and
    one run without it draw the same numbers and leave both generators in
    the same state; JAX passes ``keys[li]`` into ``jax.checkpoint`` alike."""
    if not (train and rng is not None):
        return None, None
    seed = rng.int32_seed() if attn_dropout_rate > 0.0 else None
    keep = None
    if dropout_rate > 0.0:
        keep = torch.empty(shape, device=device).bernoulli_(
            1.0 - dropout_rate, generator=rng.device
        )
    return seed, keep


def apply_relgat_layer(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,              # [N, in_dim]
    graph: GraphData,
    *,
    dropout_rate: float = 0.0,
    attn_dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    keep: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    kernel_precision: str = "highest",
) -> torch.Tensor:
    """One message-passing step; returns ``[N, heads * out_dim]``. The
    attention dropout runs when ``dropout_seed`` is given and the output
    dropout when ``keep`` is (``draw_layer_randomness``). Parameters of any
    storage type enter as JAX promotes them: ``proj`` cast to
    ``compute_dtype``, ``attn`` widened to fp32, ``rel_bias`` as stored."""
    proj = params["proj"]
    heads, in_dim, out_dim = proj.shape
    n = x.shape[0]
    w = proj.permute(1, 0, 2).reshape(in_dim, heads * out_dim)
    h = compute_matmul(x, w, compute_dtype).view(n, heads, out_dim)

    agg = relgat_propagate(
        h,
        params["attn"].float(),
        params.get("rel_bias"),
        graph.src,
        graph.dst,
        graph.etype,
        num_nodes=graph.num_nodes,
        attn_dropout_rate=attn_dropout_rate,
        dropout_seed=dropout_seed,
        use_pallas=use_pallas,
        csr=graph.csr,
        kernel_precision=kernel_precision,
    )
    out = agg.reshape(n, heads * out_dim)

    # Output dropout on the concatenated heads (reference ``layer.py:322``).
    if keep is not None:
        out = out * keep / (1.0 - dropout_rate)
    return out
