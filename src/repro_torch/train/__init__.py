"""Training: the optimizers and the train step (trainable / frozen by a
``TrainPolicy``, gradient accumulation, int8 gradient compression)."""

from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: F401
                                         apply_updates, init_opt_state)
from repro_torch.train.train_step import (TrainState,  # noqa: F401
                                          init_train_state, make_train_step,
                                          train_state)
