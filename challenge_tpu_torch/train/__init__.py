from challenge_tpu_torch.train.callbacks import (
    NO_SWA_ERROR, SWA, Callback, CSVLogger, EarlyStopping, EvalCallback,
    LearningRateScheduler, ModelCheckpoint, ReduceLROnPlateau, TensorBoard,
    TerminateOnNaN)
from challenge_tpu_torch.train.checkpoint import load_weights, save_weights
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.optim import custom_scheduler
from challenge_tpu_torch.train.state import (
    TrainState, init_state, make_eval_step, make_train_step, swa_update)

__all__ = ['NO_SWA_ERROR', 'SWA', 'Callback', 'CSVLogger', 'EarlyStopping',
           'EvalCallback', 'LearningRateScheduler', 'ModelCheckpoint',
           'ReduceLROnPlateau', 'TensorBoard', 'TerminateOnNaN',
           'load_weights', 'save_weights', 'TrainLoop', 'custom_scheduler',
           'TrainState', 'init_state', 'make_eval_step', 'make_train_step',
           'swa_update']
