"""Ops layer: segment primitives, dropout hash, sampling and the propagate."""

from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate  # noqa: F401
from relgat_projector_tpu_torch.ops.segment import (  # noqa: F401
    STABLE_SOFTMAX_EPS,
    segment_max,
    segment_softmax,
    segment_sum,
)
