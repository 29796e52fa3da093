"""Main training entry (counterpart: ``challenge_tpu/cli/sj_train.py``;
reference: sj_train.py:406-529).

    python -m challenge_tpu_torch.cli.sj_train --model_type vad --v 8 \
        --bank_dtype int8 [--device cpu] ...

The flags are the reference's (and the JAX CLI's), plus ``--device``: the
run goes to ``cuda`` unless given ``--device cpu``, and raises without a
card. The run name, the checkpoint trio ({run}.h5, _SWA.h5, _sample.h5),
the CSV log, the monitors and the callback order match the reference. The
banks are always slim, as on the JAX CLI's accelerator path: only the flat
layout of ``--bank_dtype`` goes to the device. The loop trains in banks
mode, JAX's fused step (``parallel.train``): one CUDA graph a step on the
card, eager with ``--device cpu``; ``--steps_per_call``, ``--grad_accum``
and ``--remat`` shape that step as they shape JAX's.

``--n_devices`` and ``--bank_shard`` follow JAX's device policy
(``parallel.mesh.mesh_for_config``): where more than one card is visible
and the global batch divides them, the run trains over a data-parallel
mesh, one process a card (``parallel.launch``: this process is rank 0 and
starts the others, which meet through a rendezvous file in the working
directory; under ``torchrun`` each process joins its ranks instead).
Every rank trains on its share of each batch; rank 0 writes the files.
``--bank_shard`` builds the banks on the host and gives each rank only
its block of their clip axis.
``--stream_chunks N`` (N >= 2) rotates the training spec set through the
card in N chunks, ``--chunk_steps`` dispatches each
(``data.streaming``). ``--ckpt_dir`` saves the full train state every
``--ckpt_every_epochs`` epochs and at the end; ``--resume True`` restores
the latest one and continues from its epoch. ``--keras_ckpt True`` writes
the trio as Keras HDF5 files (``interop.keras_h5``) instead of
``torch.save`` files; the full train state stays ``torch.save``.

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
from challenge_tpu_torch.data.streaming import build_streaming_banks
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.parallel import launch
from challenge_tpu_torch.parallel.mesh import (
    current, is_writer, mesh_for_config)
from challenge_tpu_torch.train import (
    NO_SWA_ERROR, SWA, CSVLogger, EarlyStopping, EvalCallback,
    LearningRateScheduler, ModelCheckpoint, TensorBoard, TerminateOnNaN,
    TrainLoop, TrainStateCheckpoint, custom_scheduler, save_weights)
from challenge_tpu_torch.train.checkpoint import (
    load_weights, restore_train_state)
from challenge_tpu_torch.utils.io import load_data

DEVICE_FLAG = {'--device': dict(type=str, default=None,
                                help="'cpu', or a CUDA device (default)")}


def make_banks(config: Config, training: bool = True, n_classes: int = 3,
               device=None):
    """Load the pickled spec sets and build device banks
    (reference: sj_train.py:74-90), or for training with ``stream_chunks``
    >= 2 a rotation of host chunks (``data.streaming``), as JAX's
    ``make_banks`` does."""
    datapath = config.datapath if os.path.exists(config.datapath) else ''
    prefix = '' if training else 'test_'
    backgrounds = load_data(os.path.join(
        datapath, getattr(config, prefix + 'background_sounds')))
    voices = load_data(os.path.join(datapath, getattr(config,
                                                      prefix + 'voices')))
    labels = load_data(os.path.join(datapath, getattr(config,
                                                      prefix + 'labels')))
    noises = load_data(os.path.join(datapath, config.noises))
    if training and config.stream_chunks >= 2:
        return build_streaming_banks(
            backgrounds, voices, np.asarray(labels), noises,
            n_chunks=config.stream_chunks, n_classes=n_classes, one_hot=True,
            n_frame=config.n_frame, flat_dtype=config.bank_dtype,
            seed=config.seed, chunk_steps=config.chunk_steps, device=device)
    return build_banks(backgrounds, voices, np.asarray(labels), noises,
                       n_classes=n_classes, one_hot=True,
                       n_frame=config.n_frame, flat_dtype=config.bank_dtype,
                       device=device)


def resume(config: Config, loop: TrainLoop) -> int:
    """With ``--ckpt_dir`` and ``--resume``, restore the latest full train
    state into ``loop`` and return the epoch it reached, as JAX's CLIs do
    (cli/sj_train.py:117-132); else 0."""
    if not (config.ckpt_dir and config.resume):
        return 0
    try:
        restore_train_state(config.ckpt_dir, loop.state)
    except FileNotFoundError:
        print(f'no checkpoint under {config.ckpt_dir!r}; starting fresh')
        return 0
    step = loop.state.step
    initial_epoch = step // loop.steps_per_fused_epoch(config.steps_per_epoch)
    print(f'resumed from step {step} (epoch {initial_epoch})')
    return initial_epoch


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
    config.loss = config.loss.upper()
    if config.loss != 'MSE':
        config.mse_multiplier = 1
    print(config)
    device = resolve_device(config.extra_args['device'])
    mesh = mesh_for_config(config, device)
    if mesh is not None:
        print(f'data-parallel mesh over {mesh.size} devices'
              + (' (banks sharded)' if config.bank_shard else ''))
        if not mesh.joined:
            return launch.run('challenge_tpu_torch.cli.sj_train:train',
                              (config,), mesh.devices, workdir='.')[0]
    return train(config, device, mesh)


def train(config: Config, device=None, mesh=None) -> str:
    """The training run of ``config`` on ``device``, or as a rank of
    ``mesh`` (default: the mesh this process is a rank of); returns the
    run name."""
    mesh = mesh if mesh is not None else current()
    if mesh is not None:
        device = mesh.device
    name = config.run_name()
    name = name if name.endswith('.h5') else name + '.h5'

    bundle = get_model(config, device=device)
    # --bank_shard on a mesh: built on the host, only each rank's block
    # goes to its card (cli/sj_train.py:57-64)
    bank_device = 'cpu' if mesh is not None and config.bank_shard else device
    loop = TrainLoop(bundle, seed=config.seed,
                     banks=make_banks(config, True, device=bank_device),
                     val_banks=make_banks(config, False, device=bank_device),
                     mesh=mesh)
    n_params = sum(p.numel() for p in bundle.module.parameters())
    print(f'{type(bundle.module).__name__}: {n_params} parameters')
    print(name)

    if config.model_type == 'se' and config.v == 9 and not config.pretrain:
        loop.set_weights(load_weights(name, device, bundle))
        print('loaded pretrained model')
    initial_epoch = resume(config, loop)

    earlystop_monitor, checkpoint_monitor = select_monitors(config)
    callbacks = [
        CSVLogger(name.replace('.h5', '.csv')),
        SWA(start_epoch=config.epochs // 4, swa_freq=2),
        ModelCheckpoint(name, monitor=checkpoint_monitor, verbose=1,
                        keras=config.keras_ckpt),
        TerminateOnNaN(),
        TensorBoard(log_dir=os.path.join('tensorboard_log',
                                         name.split('.h5')[0])),
        EarlyStopping(monitor=earlystop_monitor, patience=config.patience,
                      restore_best_weights=True),
        EvalCallback(config, name, keras=config.keras_ckpt),
        LearningRateScheduler(
            custom_scheduler(4096, config.epochs / 12, config.lr_div)),
    ]
    if config.ckpt_dir:
        callbacks.append(TrainStateCheckpoint(
            config.ckpt_dir, every_epochs=config.ckpt_every_epochs))
    try:
        loop.fit(epochs=config.epochs,
                 steps_per_epoch=config.steps_per_epoch,
                 validation_steps=16, callbacks=callbacks,
                 initial_epoch=initial_epoch)
        print('best model:', name.replace('.h5', '_SWA.h5'))
        if is_writer():
            save_weights(name.replace('.h5', '_SWA.h5'),
                         loop.state.module.state_dict(),
                         keras=config.keras_ckpt, bundle=bundle)
    except NO_SWA_ERROR:
        pass
    print(name.split('.h5')[0])
    return name.split('.h5')[0]


if __name__ == '__main__':
    main()
