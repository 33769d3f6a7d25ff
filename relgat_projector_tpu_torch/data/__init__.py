"""Data layer: graph substrate, the kernels' CSR layout, the dataset, IO
and the synthetic KG generator."""

from relgat_projector_tpu_torch.data.csr import CSRGraph, build_csr_graph  # noqa: F401
from relgat_projector_tpu_torch.data.dataset import Batch, RelGATData  # noqa: F401
from relgat_projector_tpu_torch.data.graph import (  # noqa: F401
    GraphData,
    build_graph,
    pad_node_embeddings,
)
from relgat_projector_tpu_torch.data.io import load_embeddings_and_edges  # noqa: F401
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg  # noqa: F401
