"""Hand-written Hopper kernels of the propagate and their plain versions."""

from relgat_projector_tpu_torch.ops.cuda.fused import (  # noqa: F401
    BF16_KERNELS,
    FP32_KERNELS,
    KERNELS,
    launch_counts,
    max_num_rel,
    relgat_bwd_rel,
    relgat_bwd_rel_bf16,
    relgat_bwd_rel_bf16_plain,
    relgat_bwd_rel_plain,
    relgat_bwd_src,
    relgat_bwd_src_bf16,
    relgat_bwd_src_bf16_plain,
    relgat_bwd_src_plain,
    relgat_fwd,
    relgat_fwd_bf16,
    relgat_fwd_bf16_plain,
    relgat_fwd_plain,
    relgat_fwd_split_plain,
    reset_launch_counts,
)
