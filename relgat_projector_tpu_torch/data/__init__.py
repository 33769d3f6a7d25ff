"""Graph substrate: padded COO and the kernels' CSR layout."""

from relgat_projector_tpu_torch.data.csr import CSRGraph, build_csr_graph  # noqa: F401
from relgat_projector_tpu_torch.data.graph import (  # noqa: F401
    GraphData,
    build_graph,
    pad_node_embeddings,
)
