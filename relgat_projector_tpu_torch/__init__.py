"""PyTorch/CUDA port of relgat_projector_tpu for NVIDIA Hopper (H100).

Single-device, full-graph RelGAT training: the frozen-embedding GAT stack
with its two propagate kernels written by hand in CUDA for sm_90a
(``csrc/``, built with nvcc at first use), the projection head, the
scorers, the multi-objective loss and a hand-written Adam, driven by the
trainer (``train/trainer.py``: checkpoints, resume, eval, early stopping)
and its CLI (``python -m relgat_projector_tpu_torch.cli``) over the
reference dataset formats or a synthetic KG. The JAX package
``relgat_projector_tpu`` is the reference; this package imports nothing of
it, nor JAX. Entry points run on the card unless given ``device="cpu"``,
which runs the kernels' plain PyTorch versions.
"""

from relgat_projector_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    RunConfig,
    TrainConfig,
)

__version__ = "0.1.0"
