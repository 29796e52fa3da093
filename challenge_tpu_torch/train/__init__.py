from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.state import (
    TrainState, init_state, make_eval_step, make_train_step, swa_update)

__all__ = ['TrainLoop', 'TrainState', 'init_state', 'make_eval_step',
           'make_train_step', 'swa_update']
