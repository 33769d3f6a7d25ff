"""Carry models between this package, the JAX package and the reference.

``params_from_jax(tree)`` takes the pytree that ``relgat_projector_tpu``'s
``init_model`` returns (or a trained one), as numpy arrays or anything
``np.asarray`` accepts, and returns this package's parameters: the same
nested layout, tensors on ``device``, each leaf in its own floating type:
float32 stays float32, and bfloat16 (``ml_dtypes.bfloat16`` in numpy) comes
across as ``torch.bfloat16`` through float32, which holds every bf16 value
exactly. Both packages then compute the same function on the same weights.
Nothing of JAX is imported here; convert with ``jax.device_get`` first.

The rest is the port of ``relgat_projector_tpu/interop.py``: the reference
ecosystem's trained artifact is a torch ``state_dict`` saved as
``relgat-model.pt`` beside ``training-config.json`` and
``relations-map.json``. Its key map lives in ``models/state_dict.py``
(``load_torch_state_dict`` and ``export_torch_state_dict`` are re-exported
here). ``import_torch_state_dict`` also reads the architecture from the
shapes; only ``scorer_type`` (DistMult and TransE have the same shapes)
comes from the caller. ``export_torch_checkpoint_dir`` widens the leaves
to float32 for the reference, as the JAX exporter does.

CLIs: ``python -m relgat_projector_tpu_torch.interop --checkpoint REF_DIR
--out DIR`` imports a reference checkpoint into this package's directory;
``python -m relgat_projector_tpu_torch.interop export --checkpoint DIR
--out REF_DIR`` exports this package's (or the JAX package's) directory to
the reference's. Both take ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from typing import Any, Optional, Tuple

import numpy as np
import torch

from relgat_projector_tpu_torch.config import Defaults, ModelConfig
from relgat_projector_tpu_torch.device import DeviceLike, resolve_device
from relgat_projector_tpu_torch.models.model import (
    load_from_pretrained,
    save_pretrained,
)
from relgat_projector_tpu_torch.models.state_dict import (
    StateDict,
    export_torch_state_dict,
    load_torch_state_dict,
    params_from_state_dict,
)
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map


def _leaf(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.to(dev, torch.bfloat16 if bf16 else torch.float32)


def params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree)


# ---------------------------------------------------------------------------
# Import: reference state_dict -> parameter tree and config
# ---------------------------------------------------------------------------

def import_torch_state_dict(
    sd: StateDict,
    *,
    scorer_type: str = "distmult",
    device: DeviceLike = "cuda",
) -> Tuple[dict, ModelConfig]:
    """Map a reference ``state_dict`` to ``(params, ModelConfig)``, the
    tensors on ``device``. The leaves keep their type when all of them are
    bfloat16 (the config then says ``param_dtype="bfloat16"``); otherwise
    they become float32, as in the JAX package."""
    dev = resolve_device(device)
    params = params_from_state_dict(sd)
    layers = params["layers"]
    heads, in_dim, out_dim = layers[0]["proj"].shape
    linears = params.get("projection", {}).get("linears", [])
    projection_layers = len(linears)
    bf16 = all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
    cfg = ModelConfig(
        in_dim=int(in_dim),
        num_rel=int(layers[0]["attn"].shape[1]),
        gat_out_dim=int(out_dim),
        gat_heads=int(heads),
        gat_num_layers=len(layers),
        use_rel_bias="rel_bias" in layers[0],
        scorer_type=scorer_type,
        project_to_input_size=projection_layers > 0,
        projection_layers=projection_layers,
        projection_hidden_dim=(int(linears[0].shape[1])
                               if projection_layers > 1 else 0),
        param_dtype="bfloat16" if bf16 else "float32",
    )
    rel_dim = params["scorer"]["rel_emb"].shape[1]
    if rel_dim != cfg.scorer_dim:
        raise ValueError(
            f"scorer rel_dim {rel_dim} != derived scorer space "
            f"{cfg.scorer_dim} (projection inference wrong?)"
        )
    dtype = torch.bfloat16 if bf16 else torch.float32
    return tree_map(lambda t: t.to(dev, dtype).contiguous(), params), cfg


def _read_json(path: str) -> Optional[Any]:
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def import_torch_checkpoint_dir(
    ckpt_dir: str,
    out_dir: str,
    weights_file: Optional[str] = None,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[dict, ModelConfig]:
    """Convert a reference checkpoint directory into this package's
    (``save_pretrained``: ``config.json`` and ``relgat-model.pt``, with
    ``relations-map.json`` copied when present). ``weights_file`` overrides
    ``relgat-model.pt`` inside the directory. Returns ``(params, cfg)``,
    the tensors on ``device``."""
    sd = load_torch_state_dict(weights_file or ckpt_dir)
    tc = _read_json(os.path.join(ckpt_dir, Defaults.TRAINING_CONFIG_FILE_NAME))
    scorer_type = "distmult"
    if tc is not None:
        scorer_type = str(
            tc.get("scorer", tc.get("scorer_type", "distmult"))).lower()
    params, cfg = import_torch_state_dict(sd, scorer_type=scorer_type,
                                          device=device)
    rels = _read_json(os.path.join(ckpt_dir,
                                   Defaults.TRAINING_CONFIG_REL_TO_IDX))
    add_files = ([] if rels is None
                 else [(Defaults.TRAINING_CONFIG_REL_TO_IDX, rels)])
    save_pretrained(out_dir, params, cfg, add_files=add_files)
    return params, cfg


# ---------------------------------------------------------------------------
# Export: checkpoint directory -> reference directory
# ---------------------------------------------------------------------------

def export_torch_checkpoint_dir(
    ckpt_dir: str,
    out_dir: str,
    *,
    node_emb: Optional[Any] = None,
    device: DeviceLike = "cuda",
) -> None:
    """Convert a checkpoint directory of this package or of the JAX package
    (``load_from_pretrained`` reads both, onto ``device``) into the
    reference's:

    - ``relgat-model.pt``, the trainer's artifact, and ``pytorch_model.bin``
      with ``config.json``, the surface of the reference's
      ``RelGATModel.load_from_pretrained``; every tensor float32;
    - ``training-config.json`` and ``relations-map.json`` copied through
      when present.
    """
    if node_emb is None:
        # Only the dim check reads the embeddings: a [0, in_dim] stand-in.
        cfg_json = _read_json(os.path.join(ckpt_dir,
                                           Defaults.MODEL_CONFIG_FILE_NAME))
        in_dim = int(cfg_json["in_dim"]) if cfg_json else 0
        params, cfg = load_from_pretrained(
            ckpt_dir, node_emb=np.zeros((0, in_dim), np.float32),
            device=device)
    else:
        params, cfg = load_from_pretrained(ckpt_dir, node_emb=node_emb,
                                           device=device)
    sd = {k: v.float() for k, v in
          export_torch_state_dict(params, node_emb=node_emb).items()}
    os.makedirs(out_dir, exist_ok=True)
    torch.save(sd, os.path.join(out_dir, Defaults.OUT_MODEL_NAME))
    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))

    # The keys the reference's RelGATModel.load_from_pretrained reads.
    ref_cfg = {
        "input_dim": int(cfg.in_dim),
        "num_rel": int(cfg.num_rel),
        "scorer_type": cfg.scorer_type,
        "gat_out_dim": int(cfg.gat_out_dim),
        "gat_heads": int(cfg.gat_heads),
        "dropout": float(cfg.dropout),
        "relation_attn_dropout": float(cfg.rel_attn_dropout),
        "gat_num_layers": int(cfg.gat_num_layers),
        "project_to_input_size": bool(cfg.project_to_input_size),
        "projection_layers": int(cfg.projection_layers),
        "projection_dropout": float(cfg.projection_dropout),
        "projection_hidden_dim": int(cfg.projection_hidden_dim),
    }
    with open(os.path.join(out_dir, Defaults.MODEL_CONFIG_FILE_NAME), "w",
              encoding="utf-8") as f:
        json.dump(ref_cfg, f, ensure_ascii=False, indent=2)

    for sidecar in (Defaults.TRAINING_CONFIG_FILE_NAME,
                    Defaults.TRAINING_CONFIG_REL_TO_IDX):
        src = os.path.join(ckpt_dir, sidecar)
        if os.path.isfile(src):
            with open(src, encoding="utf-8") as fi, open(
                os.path.join(out_dir, sidecar), "w", encoding="utf-8"
            ) as fo:
                fo.write(fi.read())


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def _device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="device the weights are loaded onto: 'cuda' "
                         "(default) or 'cpu'")


def main_export(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Export a checkpoint of this package or of the JAX "
        "package into the reference ecosystem's torch format "
        "(relgat-model.pt / pytorch_model.bin + config.json)."
    )
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint dir (config.json + relgat-model.pt or "
                         "relgat-model.msgpack)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--nodes-embeddings-path", default=None,
                    help="optional node2emb pickle; fills the reference's "
                         "node_emb_fixed buffer for strict=True loads")
    _device_flag(ap)
    args = ap.parse_args(argv)
    node_emb = None
    if args.nodes_embeddings_path:
        with open(args.nodes_embeddings_path, "rb") as f:
            node2emb = pickle.load(f)
        n = max(int(k) for k in node2emb) + 1
        dim = len(next(iter(node2emb.values())))
        node_emb = np.zeros((n, dim), np.float32)
        for k, v in node2emb.items():
            node_emb[int(k)] = np.asarray(v, np.float32)
    export_torch_checkpoint_dir(args.checkpoint, args.out, node_emb=node_emb,
                                device=args.device)
    print(f"Exported {args.checkpoint} -> {args.out} (torch format)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Import a reference torch checkpoint (relgat-model.pt) "
        "into this package's format."
    )
    ap.add_argument("--checkpoint", required=True,
                    help="reference checkpoint dir (or the .pt file)")
    ap.add_argument("--out", required=True, help="output directory")
    _device_flag(ap)
    args = ap.parse_args(argv)
    ckpt, weights_file = args.checkpoint, None
    if os.path.isfile(ckpt):
        # Keep the exact file (it may not be named relgat-model.pt); the
        # directory around it still gives the JSON sidecars.
        weights_file = ckpt
        ckpt = os.path.dirname(ckpt) or "."
    params, cfg = import_torch_checkpoint_dir(
        ckpt, args.out, weights_file=weights_file, device=args.device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(
        f"Imported {cfg.gat_num_layers}-layer/{cfg.gat_heads}-head model "
        f"({n_params} params) -> {args.out}"
    )


if __name__ == "__main__":
    if sys.argv[1:2] == ["export"]:
        main_export(sys.argv[2:])
    else:
        main()
