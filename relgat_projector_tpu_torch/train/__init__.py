"""Training layer: optimizer, train state, train and eval steps."""

from relgat_projector_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import (  # noqa: F401
    make_eval_step,
    make_train_step,
    score_batch,
)
