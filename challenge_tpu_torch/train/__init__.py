from challenge_tpu_torch.train.callbacks import (
    NO_SWA_ERROR, SWA, Callback, CSVLogger, EarlyStopping, EvalCallback,
    LearningRateScheduler, ModelCheckpoint, ReduceLROnPlateau, TensorBoard,
    TerminateOnNaN, TrainStateCheckpoint)
from challenge_tpu_torch.train.checkpoint import (
    checkpoint_steps, load_weights, restore_train_state, save_train_state,
    save_weights)
from challenge_tpu_torch.train.losses import (
    binary_crossentropy, density_loss, get_loss, mae, se_loss,
    sigmoid_focal_crossentropy)
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.metrics import (
    batch_metrics, cos_sim, er_score, f1_counts, f1_from_counts)
from challenge_tpu_torch.train.optim import (
    adaptive_clip_grad, custom_scheduler, make_optimizer, set_learning_rate,
    unitwise_norm)
from challenge_tpu_torch.train.state import (
    EvalStep, TrainState, TrainStep, init_state, make_eval_step,
    make_grad_update, make_train_step, swa_update)

__all__ = ['NO_SWA_ERROR', 'SWA', 'Callback', 'CSVLogger', 'EarlyStopping',
           'EvalCallback', 'LearningRateScheduler', 'ModelCheckpoint',
           'ReduceLROnPlateau', 'TensorBoard', 'TerminateOnNaN',
           'TrainStateCheckpoint', 'checkpoint_steps', 'load_weights',
           'restore_train_state', 'save_train_state', 'save_weights',
           'binary_crossentropy', 'density_loss', 'get_loss', 'mae',
           'se_loss', 'sigmoid_focal_crossentropy', 'TrainLoop',
           'batch_metrics', 'cos_sim', 'er_score', 'f1_counts',
           'f1_from_counts', 'adaptive_clip_grad', 'custom_scheduler',
           'make_optimizer', 'set_learning_rate', 'unitwise_norm',
           'EvalStep', 'TrainState', 'TrainStep', 'init_state',
           'make_eval_step', 'make_grad_update', 'make_train_step',
           'swa_update']
