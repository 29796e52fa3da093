from challenge_tpu_torch.train.callbacks import (
    NO_SWA_ERROR, SWA, Callback, CSVLogger, EarlyStopping, EvalCallback,
    LearningRateScheduler, ModelCheckpoint, ReduceLROnPlateau, TensorBoard,
    TerminateOnNaN, TrainStateCheckpoint)
from challenge_tpu_torch.train.checkpoint import (
    checkpoint_steps, load_weights, restore_train_state, save_train_state,
    save_weights)
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.optim import custom_scheduler
from challenge_tpu_torch.train.state import (
    TrainState, init_state, make_eval_step, make_train_step, swa_update)

__all__ = ['NO_SWA_ERROR', 'SWA', 'Callback', 'CSVLogger', 'EarlyStopping',
           'EvalCallback', 'LearningRateScheduler', 'ModelCheckpoint',
           'ReduceLROnPlateau', 'TensorBoard', 'TerminateOnNaN',
           'TrainStateCheckpoint', 'checkpoint_steps', 'load_weights',
           'restore_train_state', 'save_train_state', 'save_weights', 'TrainLoop', 'custom_scheduler',
           'TrainState', 'init_state', 'make_eval_step', 'make_train_step',
           'swa_update']
