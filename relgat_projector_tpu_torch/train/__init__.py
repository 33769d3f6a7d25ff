"""Training layer: optimizer, train state, train and eval steps,
checkpoints and the trainer."""

from relgat_projector_tpu_torch.train.checkpoint import (  # noqa: F401
    RelGATStorage,
    load_train_state,
    save_train_state,
)
from relgat_projector_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import (  # noqa: F401
    batch_forward,
    make_eval_step,
    make_scan_train_step,
    make_train_step,
    score_batch,
)
from relgat_projector_tpu_torch.train.trainer import RelGATTrainer  # noqa: F401
