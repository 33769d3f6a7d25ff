"""Export / inference CLI of the PyTorch/CUDA port.

Loads a checkpoint directory (this package's, with ``relgat-model.pt``, or
the JAX package's, with ``relgat-model.msgpack``) and the dataset files,
rebuilds the message-passing graph from ALL the triplets (inference: the
reference reloads with the caller's edge_index, ``model.py:217-272``), and
runs the helpers of ``inference.py``:

    # the node-representation matrix -> .npy
    python -m relgat_projector_tpu_torch.export --checkpoint CKPT \\
        --nodes-embeddings-path nodes.pkl --relations-mapping rels.json \\
        --relations-triplets triplets.json --out repr.npy

    # query expansion: the top-k nodes for (node, relation), printed as JSON
    python -m relgat_projector_tpu_torch.export ... --query-node 123 \\
        --query-relation hypernym --top-k 10

The flags are the JAX package's ``export.py``'s, plus ``--device`` (default
``cuda``). The forward always takes the kernel route (``use_pallas``): on
the card the Hopper kernels are this package's propagate, and on
``--device cpu`` the same route runs their plain versions. The saved
``use_pallas`` chooses between the JAX package's TPU routes, which agree at
the parity bar on the real rows returned here. A checkpoint saved in the
bf16 mode (``kernel_precision="default"``) serves through the bf16 kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from relgat_projector_tpu_torch import inference
from relgat_projector_tpu_torch.data.dataset import RelGATData
from relgat_projector_tpu_torch.data.io import load_embeddings_and_edges
from relgat_projector_tpu_torch.device import resolve_device
from relgat_projector_tpu_torch.models import model as model_lib


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="Checkpoint dir (config.json + relgat-model.pt or "
                        "relgat-model.msgpack)")
    p.add_argument("--nodes-embeddings-path", required=True)
    p.add_argument("--relations-mapping", required=True)
    p.add_argument("--relations-triplets", required=True)
    p.add_argument("--out", default=None,
                   help="Write the [N, D] node-representation matrix here "
                        "(.npy)")
    p.add_argument("--query-node", type=int, default=None,
                   help="Raw node id for query expansion")
    p.add_argument("--query-relation", type=str, default=None,
                   help="Relation name (or integer id) for query expansion")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = get_args(argv)
    device = resolve_device(args.device)
    node2emb, rel2idx, triplets = load_embeddings_and_edges(
        args.nodes_embeddings_path,
        args.relations_mapping,
        args.relations_triplets,
    )
    # All triplets feed the inference graph (train_ratio=1.0).
    data = RelGATData(node2emb, rel2idx, triplets, train_ratio=1.0, csr=True,
                      device=device)
    params, cfg = model_lib.load_from_pretrained(
        args.checkpoint, node_emb=data.node_emb[: data.num_nodes],
        device=device,
    )
    cfg = dataclasses.replace(cfg, use_pallas=True)

    node_emb = torch.from_numpy(data.node_emb).to(device)
    repr_ = inference.export_node_representations(
        params, cfg, node_emb, data.graph, args.out
    )
    print(f"node representations: {tuple(repr_.shape)}"
          + (f" -> {args.out}" if args.out else ""))

    if args.query_node is not None and args.query_relation is not None:
        rel = args.query_relation
        rel_id = rel2idx[rel] if rel in rel2idx else int(rel)
        idx = data.id2idx[int(args.query_node)]
        ids, scores = inference.query_expansion(
            params, cfg, repr_, repr_[idx], rel_id=rel_id, top_k=args.top_k,
        )
        inv = {v: k for k, v in data.id2idx.items()}
        hits = [
            {"node_id": int(inv[int(i)]), "score": float(s)}
            for i, s in zip(ids[0].tolist(), scores[0].tolist())
        ]
        print(json.dumps(
            {"query_node": args.query_node, "relation": rel, "top": hits},
            indent=2,
        ))


if __name__ == "__main__":
    main()
