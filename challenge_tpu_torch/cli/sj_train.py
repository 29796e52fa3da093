"""Main training entry (counterpart: ``challenge_tpu/cli/sj_train.py``;
reference: sj_train.py:406-529).

    python -m challenge_tpu_torch.cli.sj_train --model_type vad --v 8 \
        --bank_dtype int8 [--device cpu] ...

The flags are the reference's (and the JAX CLI's), plus ``--device``: the
run goes to ``cuda`` unless given ``--device cpu``, and raises without a
card. The run name, the checkpoint trio ({run}.h5, _SWA.h5, _sample.h5),
the CSV log, the monitors and the callback order match the reference. The
banks are always slim, as on the JAX CLI's accelerator path: only the flat
layout of ``--bank_dtype`` goes to the device.

The se v9 family trains in two runs. ``--pretrain True`` trains the U-Net
and names its run ``..._weight``. Without the flag (the reference's
``type=bool`` flag makes ``--pretrain False`` True) the run fine-tunes the
head: it first loads ``{run}.h5`` under its own run name, as the
reference does (sj_train.py:467-469), so the pretrain checkpoint must be
put there.
"""

from __future__ import annotations

import os

import numpy as np

from challenge_tpu_torch.config import Config, config_from_args
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.train import (
    NO_SWA_ERROR, SWA, CSVLogger, EarlyStopping, EvalCallback,
    LearningRateScheduler, ModelCheckpoint, TensorBoard, TerminateOnNaN,
    TrainLoop, custom_scheduler, save_weights)
from challenge_tpu_torch.train.checkpoint import load_weights
from challenge_tpu_torch.utils.io import load_data

DEVICE_FLAG = {'--device': dict(type=str, default=None,
                                help="'cpu', or a CUDA device (default)")}


def make_banks(config: Config, training: bool = True, n_classes: int = 3,
               device=None):
    """Load the pickled spec sets and build device banks
    (reference: sj_train.py:74-90)."""
    for flag, on in (('stream_chunks', training and config.stream_chunks >= 2),
                     ('bank_shard', bool(config.bank_shard))):
        if on:
            raise NotImplementedError(
                f'--{flag} is not ported yet (ROADMAP A14)')
    datapath = config.datapath if os.path.exists(config.datapath) else ''
    prefix = '' if training else 'test_'
    backgrounds = load_data(os.path.join(
        datapath, getattr(config, prefix + 'background_sounds')))
    voices = load_data(os.path.join(datapath, getattr(config,
                                                      prefix + 'voices')))
    labels = load_data(os.path.join(datapath, getattr(config,
                                                      prefix + 'labels')))
    noises = load_data(os.path.join(datapath, config.noises))
    return build_banks(backgrounds, voices, np.asarray(labels), noises,
                       n_classes=n_classes, one_hot=True,
                       n_frame=config.n_frame, flat_dtype=config.bank_dtype,
                       device=device)


def select_monitors(config: Config):
    """Reference monitor selection (sj_train.py:475-486)."""
    if config.model_type == 'se' and config.v == 9:
        if config.pretrain:
            return 'val_speech_loss', 'val_speech_loss'
        return 'val_class_loss', 'val_class_er'
    return 'val_loss', 'val_er'


def main(argv=None) -> str:
    """Train; returns the run name."""
    config = config_from_args(argv, extra=DEVICE_FLAG)
    for flag, on in (('ckpt_dir', bool(config.ckpt_dir)),
                     ('resume', config.resume),
                     ('keras_ckpt', config.keras_ckpt)):
        if on:
            raise NotImplementedError(
                f'--{flag} is not ported yet (ROADMAP A15)')
    config.loss = config.loss.upper()
    if config.loss != 'MSE':
        config.mse_multiplier = 1
    print(config)
    device = resolve_device(config.extra_args['device'])

    name = config.run_name()
    name = name if name.endswith('.h5') else name + '.h5'

    bundle = get_model(config, device=device)
    loop = TrainLoop(bundle, seed=config.seed,
                     banks=make_banks(config, True, device=device),
                     val_banks=make_banks(config, False, device=device))
    n_params = sum(p.numel() for p in bundle.module.parameters())
    print(f'{type(bundle.module).__name__}: {n_params} parameters')
    print(name)

    if config.model_type == 'se' and config.v == 9 and not config.pretrain:
        loop.set_weights(load_weights(name, device))
        print('loaded pretrained model')

    earlystop_monitor, checkpoint_monitor = select_monitors(config)
    callbacks = [
        CSVLogger(name.replace('.h5', '.csv')),
        SWA(start_epoch=config.epochs // 4, swa_freq=2),
        ModelCheckpoint(name, monitor=checkpoint_monitor, verbose=1),
        TerminateOnNaN(),
        TensorBoard(log_dir=os.path.join('tensorboard_log',
                                         name.split('.h5')[0])),
        EarlyStopping(monitor=earlystop_monitor, patience=config.patience,
                      restore_best_weights=True),
        EvalCallback(config, name),
        LearningRateScheduler(
            custom_scheduler(4096, config.epochs / 12, config.lr_div)),
    ]
    try:
        loop.fit(epochs=config.epochs,
                 steps_per_epoch=config.steps_per_epoch,
                 validation_steps=16, callbacks=callbacks)
        print('best model:', name.replace('.h5', '_SWA.h5'))
        save_weights(name.replace('.h5', '_SWA.h5'),
                     loop.state.module.state_dict())
    except NO_SWA_ERROR:
        pass
    print(name.split('.h5')[0])
    return name.split('.h5')[0]


if __name__ == '__main__':
    main()
