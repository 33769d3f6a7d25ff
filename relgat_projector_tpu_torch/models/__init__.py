"""Model layer: RelGAT layers, projection head, scorers."""

from relgat_projector_tpu_torch.models.model import (  # noqa: F401
    forward,
    get_node_repr,
    init_model,
    load_from_pretrained,
    save_pretrained,
    single_gat_step,
    transform,
    transform_from_vectors,
)
