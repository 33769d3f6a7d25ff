"""RelGAT model: stacked layers, optional projection head, scorer.

Port of ``relgat_projector_tpu/models/model.py``. Parameters are a pytree of
tensors in the JAX layout::

    {"layers": [{"proj", "attn", "rel_bias"}, ...],
     "projection": {"linears": [...], "ln_scale": [...], "ln_bias": [...]},
     "scorer": {"rel_emb"}}

and every apply function is a plain function of them. Stacked layers have
ELU between them (not after the last); the projection head maps back to the
input dim; ``single_gat_step`` computes every node's representation.

``save_pretrained`` / ``load_from_pretrained`` keep the JAX package's
directory: ``config.json`` and the ``add_files`` JSON sidecars. The weights
are ``relgat-model.pt``, the reference's artifact: its flat ``state_dict``
(``models/state_dict.py``, each leaf in its own type), read back
with ``weights_only=True``. ``load_from_pretrained`` also reads the nested
parameter tree that earlier versions of this package wrote under that name,
and a JAX package directory (``relgat-model.msgpack``, read by
``utils/msgpack.py`` without flax).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from relgat_projector_tpu_torch.config import Defaults, ModelConfig, torch_dtype
from relgat_projector_tpu_torch.data.graph import GraphData
from relgat_projector_tpu_torch.device import (
    DeviceLike,
    operand_dtype,
    resolve_device,
    set_matmul_precision,
)
from relgat_projector_tpu_torch.models import scorer as scorer_mod
from relgat_projector_tpu_torch.models.layer import (
    apply_relgat_layer,
    draw_layer_randomness,
    init_relgat_layer,
)
from relgat_projector_tpu_torch.models.projection import (
    apply_projection_head,
    head_operand,
    init_projection_head,
)
from relgat_projector_tpu_torch.models.state_dict import (
    export_torch_state_dict,
    load_torch_state_dict,
    params_from_state_dict,
)
from relgat_projector_tpu_torch.utils import msgpack
from relgat_projector_tpu_torch.utils.profiling import span
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map

Params = Dict[str, Any]


def init_model(
    cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = "cuda"
) -> Params:
    """Random parameters drawn on the host from ``seed``, stored as
    ``cfg.param_dtype`` and moved to ``device`` (the same numbers on every
    device)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator().manual_seed(int(seed))
    layers = []
    in_dim = cfg.in_dim
    for _ in range(cfg.gat_num_layers):
        layers.append(
            init_relgat_layer(
                gen, in_dim=in_dim, out_dim=cfg.gat_out_dim,
                num_rel=cfg.num_rel, heads=cfg.gat_heads,
                use_bias=cfg.use_rel_bias,
            )
        )
        in_dim = cfg.gat_concat_dim
    params: Params = {"layers": layers}
    if cfg.project_to_input_size:
        params["projection"] = init_projection_head(
            gen, in_dim=cfg.gat_concat_dim, out_dim=cfg.in_dim,
            num_layers=cfg.projection_layers,
            hidden_dim=cfg.projection_hidden_dim,
        )
    params["scorer"] = scorer_mod.init_scorer(gen, cfg.num_rel, cfg.scorer_dim)
    return tree_map(lambda t: t.to(dev, dtype), params)


def single_gat_step(
    params: Params,
    cfg: ModelConfig,
    node_emb: torch.Tensor,   # [N_pad, in_dim] frozen
    graph: GraphData,
    *,
    train: bool = False,
    rng: Optional[RngStreams] = None,
) -> torch.Tensor:
    """Representations of ALL nodes ``[N_pad, scorer_dim]``. With
    ``cfg.remat`` each GAT layer runs under ``torch.utils.checkpoint`` (JAX:
    ``jax.checkpoint``): its activations are not kept for the backward,
    which runs the layer again. Its random draws are made before it and
    passed in, so the second run draws nothing.

    On a graph shard (``graph.halo`` a ``parallel.HaloShard``) ``node_emb``
    and the result are the shard's rows; the output-dropout masks are drawn
    for every node and sliced, so every rank's generators stay in step."""
    if node_emb.is_cuda:
        set_matmul_precision()
    compute_dtype = torch_dtype(cfg.compute_dtype)
    num_layers = cfg.gat_num_layers
    width = cfg.gat_concat_dim

    # Each layer's output is written in the type of the product that reads
    # it next: the next layer's projection, or the head (fp32 without one).
    hidden_out = operand_dtype(compute_dtype)
    last_out = (head_operand(params["projection"], compute_dtype)
                if cfg.project_to_input_size else torch.float32)

    def layer_fn(layer_params, x_in, seed, keep, last):
        return apply_relgat_layer(
            layer_params, x_in, graph,
            dropout_rate=cfg.dropout,
            attn_dropout_rate=cfg.rel_attn_dropout,
            dropout_seed=seed,
            keep=keep,
            use_pallas=cfg.use_pallas,
            compute_dtype=compute_dtype,
            kernel_precision=cfg.kernel_precision,
            elu=not last,
            out_dtype=last_out if last else hidden_out,
        )

    rows = None
    if graph.halo is not None:
        lo, hi = graph.halo.row_range
        rows = (graph.num_nodes, lo, hi)
    x = node_emb
    for li in range(num_layers):
        with span("relgat/gat_layer"):
            seed, keep = draw_layer_randomness(
                rng, (x.shape[0] if rows is None else rows[0], width),
                dropout_rate=cfg.dropout,
                attn_dropout_rate=cfg.rel_attn_dropout, train=train,
                device=x.device,
            )
            if rows is not None and keep is not None:
                keep = keep[rows[1]:rows[2]]
            last = li == num_layers - 1
            if cfg.remat and torch.is_grad_enabled():
                # preserve_rng_state would save and restore the default
                # generators, which the layer does not draw from.
                x = checkpoint(
                    layer_fn, params["layers"][li], x, seed, keep, last,
                    use_reentrant=False, preserve_rng_state=False,
                )
            else:
                x = layer_fn(params["layers"][li], x, seed, keep, last)
    if cfg.project_to_input_size:
        x = apply_projection_head(
            params["projection"], x, dropout_rate=cfg.projection_dropout,
            train=train, rng=rng, compute_dtype=compute_dtype, rows=rows,
        )
    return x


def forward(
    params: Params,
    cfg: ModelConfig,
    node_emb: torch.Tensor,
    graph: GraphData,
    src_ids: torch.Tensor,
    rel_ids: torch.Tensor,
    dst_ids: torch.Tensor,
    *,
    transform_to_input_if_possible: bool = True,
    train: bool = False,
    rng: Optional[RngStreams] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Scores, relation-transformed sources (or None) and dst vectors for a
    batch of triplets (reference ``model.py:99-142``)."""
    x = single_gat_step(params, cfg, node_emb, graph, train=train, rng=rng)
    src_vec = x[src_ids]
    dst_vec = x[dst_ids]
    transformed = None
    if cfg.project_to_input_size and transform_to_input_if_possible:
        transformed = scorer_mod.transform(
            params["scorer"], cfg.scorer_type, src_vec, rel_ids
        )
    scores = scorer_mod.score_triplets(
        params["scorer"], cfg.scorer_type, src_vec, rel_ids, dst_vec
    )
    return scores, transformed, dst_vec


@torch.no_grad()
def get_node_repr(
    params: Params, cfg: ModelConfig, node_emb: torch.Tensor, graph: GraphData
) -> torch.Tensor:
    """Representations of the real nodes, for export and indexing."""
    x = single_gat_step(params, cfg, node_emb, graph, train=False)
    return x[: graph.num_real_nodes]


def transform_from_vectors(
    params: Params, cfg: ModelConfig, src_vectors: torch.Tensor,
    rel_ids: torch.Tensor,
) -> torch.Tensor:
    """Relation operator on vectors in scorer space; a single relation id
    broadcasts over the batch."""
    rel_ids = torch.atleast_1d(rel_ids)
    if rel_ids.shape[0] == 1 and src_vectors.shape[0] > 1:
        rel_ids = rel_ids.expand(src_vectors.shape[0])
    return scorer_mod.transform(
        params["scorer"], cfg.scorer_type, src_vectors, rel_ids
    )


def transform(
    params: Params, cfg: ModelConfig, node_emb: torch.Tensor,
    graph: GraphData, src_ids: torch.Tensor, rel_ids: torch.Tensor,
) -> torch.Tensor:
    """Gather node representations, then apply the relation operator."""
    x = single_gat_step(params, cfg, node_emb, graph, train=False)
    return transform_from_vectors(params, cfg, x[src_ids], rel_ids)


# ---------------------------------------------------------------------------
# Persistence (HF-style directory: config.json + weights)
# ---------------------------------------------------------------------------

JAX_WEIGHTS_NAME = "relgat-model.msgpack"  # the JAX package's weights


def save_pretrained(
    output_dir: str,
    params: Params,
    cfg: ModelConfig,
    add_files: Optional[list] = None,
) -> None:
    """Write ``config.json``, the ``(file name, JSON content)`` pairs of
    ``add_files`` and the weights as the reference's ``state_dict``
    (reference ``model.py:196-215``)."""
    os.makedirs(output_dir, exist_ok=True)
    files = list(add_files or [])
    files.append((Defaults.MODEL_CONFIG_FILE_NAME, cfg.to_dict()))
    for fname, content in files:
        with open(os.path.join(output_dir, fname), "w", encoding="utf-8") as f:
            json.dump(content, f, ensure_ascii=False, indent=2)
    torch.save(export_torch_state_dict(params),
               os.path.join(output_dir, Defaults.OUT_MODEL_NAME))


def _read_weights(input_dir: str, template: Params) -> Params:
    """The parameter tree in ``input_dir``: this package's ``relgat-model.pt``
    (the reference's flat keys, or the nested tree of earlier versions), else
    the JAX package's ``relgat-model.msgpack``."""
    w_path = os.path.join(input_dir, Defaults.OUT_MODEL_NAME)
    if os.path.isfile(w_path):
        saved = load_torch_state_dict(w_path)
        if "layers" in saved:  # the nested tree, as it is
            return saved
        return params_from_state_dict(saved)
    jax_path = os.path.join(input_dir, JAX_WEIGHTS_NAME)
    if os.path.isfile(jax_path):
        with open(jax_path, "rb") as f:
            return msgpack.from_bytes(template, f.read())
    raise FileNotFoundError(f"Weights file not found: {w_path} (nor "
                            f"{JAX_WEIGHTS_NAME})")


def load_from_pretrained(
    input_dir: str,
    *,
    node_emb: Any,
    device: DeviceLike = "cuda",
) -> Tuple[Params, ModelConfig]:
    """Read config and weights onto ``device``, checking the input dim
    against the embeddings that will be fed (reference ``model.py:217-272``)
    and every weight's shape against the config's; each leaf is stored in
    the config's ``param_dtype``."""
    dev = resolve_device(device)
    cfg_path = os.path.join(input_dir, Defaults.MODEL_CONFIG_FILE_NAME)
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"Config file not found: {cfg_path}")
    with open(cfg_path, "r", encoding="utf-8") as f:
        cfg = ModelConfig.from_dict(json.load(f))
    in_dim = int(node_emb.shape[1])
    if int(cfg.in_dim) != in_dim:
        raise ValueError(
            f"Input dim mismatch: config={cfg.in_dim} vs node_emb={in_dim}"
        )
    template = init_model(cfg, device="cpu")
    params = _read_weights(input_dir, template)
    want = [tuple(t.shape) for t in tree_leaves(template)]
    got = [tuple(t.shape) for t in tree_leaves(params)]
    if got != want:
        raise ValueError(
            f"weights in {input_dir} do not fit {cfg_path}: shapes {got} "
            f"against {want}"
        )
    return tree_map(lambda t, w: t.to(dev, w.dtype), params, template), cfg
