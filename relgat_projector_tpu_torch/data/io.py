"""Dataset ingestion in the reference's on-disk formats.

Parity with reference ``handlers/models/relgat.py:11-41``:
- node embeddings: pickle ``{node_id: vector}``,
- relation mapping: JSON ``{rel_name: rel_idx}``,
- triplets: JSON list ``[src_id, dst_id, rel_name]``, filtered to pairs where
  both endpoints have embeddings.

The pickle is unpickled as it is: load only files you trust.
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, List, Tuple

import numpy as np


def load_embeddings_and_edges(
    path_to_nodes: str, path_to_rels: str, path_to_edges: str
) -> Tuple[Dict[int, np.ndarray], Dict[str, int], List[Tuple[int, int, str]]]:
    print("Loading", path_to_nodes)
    with open(path_to_nodes, "rb") as f:
        node2emb = pickle.load(f)
    node2emb = {int(k): np.asarray(v, dtype=np.float32) for k, v in node2emb.items()}
    print(f"  - number of loaded nodes: {len(node2emb)}")

    print("Loading", path_to_rels)
    with open(path_to_rels, "r") as f:
        rel2idx = json.load(f)
    rel2idx = {str(k): int(v) for k, v in rel2idx.items()}
    print(f"  - number of loaded rel2idx: {len(rel2idx)}")

    print("Loading", path_to_edges)
    with open(path_to_edges, "r") as f:
        edge_index_raw = json.load(f)
    print(f"  - number of loaded edges: {len(edge_index_raw)}")
    edge_index_raw = [
        (int(s), int(d), str(r))
        for s, d, r in edge_index_raw
        if int(s) in node2emb and int(d) in node2emb
    ]
    print(f"  - number of edges after filtering: {len(edge_index_raw)}")
    return node2emb, rel2idx, edge_index_raw
