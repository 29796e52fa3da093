"""Keras-style callbacks for the train loop (counterpart:
``challenge_tpu/train/callbacks.py``; reference: sj_train.py:489-503,
swa.py, metrics.py:14-28).

Callbacks receive the :class:`~challenge_tpu_torch.train.loop.TrainLoop`
(which owns the TrainState) and a ``logs`` dict of floats per epoch. Order
matters and mirrors the reference: SWA's ``on_train_end`` overwrites the
live weights with the SWA average after EarlyStopping may have restored
the best weights (reference: sj_train.py:489-500 callback order).
:class:`TrainStateCheckpoint`, which the CLIs add after the others when
given ``--ckpt_dir``, saves the full train state for ``--resume``.

On a data-parallel mesh every rank runs the callbacks on the same logs
(the steps reduce their metrics over the ranks), so EarlyStopping, the
learning-rate schedules, SWA and TerminateOnNaN decide alike everywhere,
but only rank 0 writes files (``parallel.mesh.is_writer``): the CSV log,
the checkpoints, TensorBoard's events and the eval callback's. The eval
callback scores the dev set on rank 0 and broadcasts the score.
"""

from __future__ import annotations

import copy
import csv
import os
from typing import Callable

import numpy as np

from challenge_tpu_torch.parallel import mesh as mesh_lib
from challenge_tpu_torch.train import checkpoint
from challenge_tpu_torch.train.optim import set_learning_rate
from challenge_tpu_torch.train.state import swa_update


class NO_SWA_ERROR(Exception):
    """Raised when training ends before SWA ever folded
    (reference: swa.py:5-10)."""

    def __init__(self, msg="Didn't use SWA") -> None:
        super().__init__(msg)
        self.msg = msg

    def __str__(self) -> str:
        return self.msg


class Callback:
    loop = None

    def set_loop(self, loop):
        self.loop = loop

    def on_train_begin(self):
        pass

    def on_epoch_begin(self, epoch):
        pass

    def on_epoch_end(self, epoch, logs):
        pass

    def on_train_end(self, logs=None):
        pass


class CSVLogger(Callback):
    """Append per-epoch logs to ``filename``, with a header line when the
    file is new or empty (reference: sj_train.py:490, Keras
    ``append=True``)."""

    def __init__(self, filename: str):
        self.filename = filename
        self._keys = None

    def on_epoch_end(self, epoch, logs):
        if not mesh_lib.is_writer():
            return
        new_file = (not os.path.exists(self.filename)
                    or os.path.getsize(self.filename) == 0)
        if self._keys is None:
            self._keys = sorted(logs)
        with open(self.filename, 'a', newline='') as f:
            w = csv.writer(f)
            if new_file:
                w.writerow(['epoch'] + self._keys)
            w.writerow([epoch] + [logs.get(k, '') for k in self._keys])


class ModelCheckpoint(Callback):
    """Save the weights whenever ``monitor`` reaches a new minimum
    (reference: sj_train.py:492, ``save_best_only=True``), as a Keras HDF5
    file with ``keras=True``."""

    def __init__(self, filepath: str, monitor: str = 'val_loss',
                 verbose: int = 0, keras: bool = False):
        self.filepath = filepath
        self.monitor = monitor
        self.best = np.inf
        self.verbose = verbose
        self.keras = keras

    def on_epoch_end(self, epoch, logs):
        value = logs.get(self.monitor)
        if value is None or not value < self.best:
            return
        self.best = value
        if not mesh_lib.is_writer():
            return
        checkpoint.save_weights(self.filepath,
                                self.loop.state.module.state_dict(),
                                keras=self.keras, bundle=self.loop.bundle)
        if self.verbose:
            print(f'\nEpoch {epoch}: {self.monitor} improved to '
                  f'{value:.5f}, saving to {self.filepath}')


class EarlyStopping(Callback):
    """Stop after ``patience`` epochs without a new minimum of ``monitor``;
    optionally restore the best weights (reference: sj_train.py:495)."""

    def __init__(self, monitor: str = 'val_loss', patience: int = 10,
                 restore_best_weights: bool = True):
        self.monitor = monitor
        self.patience = patience
        self.restore = restore_best_weights
        self.best = np.inf
        self.wait = 0
        self.best_weights = None

    def on_epoch_end(self, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        if value < self.best:
            self.best = value
            self.wait = 0
            if self.restore:
                self.best_weights = self.loop.get_weights()
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.loop.stop_training = True
                if self.restore and self.best_weights is not None:
                    self.loop.set_weights(self.best_weights)


class TerminateOnNaN(Callback):
    """Halt on a non-finite loss (reference: sj_train.py:493)."""

    def on_epoch_end(self, epoch, logs):
        loss = logs.get('loss')
        if loss is not None and not np.isfinite(loss):
            print(f'\nEpoch {epoch}: invalid loss, terminating training')
            self.loop.stop_training = True


class SWA(Callback):
    """Stochastic weight averaging (reference: swa.py:13-44): from epoch
    ``start_epoch - 1``, every ``swa_freq`` epochs fold the live weights
    and BN statistics into the running average; on train end, swap the
    average in without recomputing the BN statistics (the reference's
    'Please Reset BN' behaviour, preserved)."""

    def __init__(self, start_epoch: int, swa_freq: int = 1,
                 verbose: bool = True):
        self.start_epoch = start_epoch - 1
        self.swa_freq = swa_freq
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs):
        rel = epoch - self.start_epoch
        if rel == 0 or (rel > 0 and rel % self.swa_freq == 0):
            if self.verbose:
                print('\nSaving Weights... ', epoch)
            swa_update(self.loop.state)

    def on_train_end(self, logs=None):
        print('\nFinal Model Has Been Saved... Please Reset BN')
        if self.loop.state.swa_count == 0:
            raise NO_SWA_ERROR()
        self.loop.set_weights(self.loop.state.swa)


class LearningRateScheduler(Callback):
    """Set the learning rate of every parameter group at each epoch start
    (reference: sj_train.py:501-503), in place in its device tensor, which
    a captured step reads (``optim.KerasAdam``)."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def on_epoch_begin(self, epoch):
        set_learning_rate(self.loop.state.optimizer, self.schedule(epoch))


class ReduceLROnPlateau(Callback):
    """Multiply the learning rate of every parameter group by ``factor``
    after ``patience`` epochs without a new minimum of ``monitor``, then
    wait ``patience`` epochs again (counterpart: ``callbacks.py:208-235``,
    mode 'min'; reference: trainer.py:278-279, the pretrain branch). As in
    JAX, the float32 rate times ``factor`` is taken in float64 and stored
    in float32, in place in its device tensor."""

    def __init__(self, monitor: str = 'loss', factor: float = 0.9,
                 patience: int = 5):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.best = np.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        if value < self.best:
            self.best = value
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            optimizer = self.loop.state.optimizer
            set_learning_rate(optimizer, float(
                optimizer.param_groups[0]['lr']) * self.factor)


class EvalCallback(Callback):
    """Challenge eval every 5th epoch (epoch % 5 == 2): evaluate the current
    best checkpoint ``name`` on ``./*.wav`` against
    ``./sample_answer.json`` and keep the best-scoring weights as
    ``*_sample.h5`` (reference: metrics.py:14-28), as a Keras HDF5 file
    with ``keras=True``. The eval runs on a copy of the model, so the
    training module is untouched."""

    def __init__(self, config, name: str, keras: bool = False):
        self.config = config
        self.name = name
        self.score = np.inf
        self.keras = keras

    def on_epoch_end(self, epoch, logs):
        if epoch % 5 != 2:
            return
        mesh = mesh_lib.current()
        score = self._score() if mesh_lib.is_writer() else None
        if mesh is not None:
            score = mesh.broadcast_object(score)
        if score is not None:
            logs['challenge_er'] = score

    def _score(self):
        """The dev-set score of the checkpoint, after keeping its weights
        as ``_sample`` when they score best; None before a checkpoint."""
        if not os.path.exists(self.name):
            return None
        from challenge_tpu_torch.evaluate.infer import evaluate
        module = self.loop.state.module
        weights = checkpoint.load_weights(self.name,
                                          next(module.parameters()).device,
                                          bundle=self.loop.bundle)
        model = copy.deepcopy(module)
        model.load_state_dict(weights)
        score = float(np.mean(evaluate(self.config, model, verbose=True)))
        if score <= self.score:
            self.score = score
            checkpoint.save_weights(
                os.path.splitext(self.name)[0] + '_sample.h5', weights,
                keras=self.keras, bundle=self.loop.bundle)
        return score


class TrainStateCheckpoint(Callback):
    """The full train state (weights, BN statistics, optimizer state, SWA
    average, step) under ``ckpt_dir`` every ``every_epochs`` epochs and at
    train end (counterpart: ``callbacks.py:274-289``), for
    ``checkpoint.restore_train_state``. The train-end save of a step
    already saved is skipped, as Orbax skips it; otherwise, after SWA's
    ``on_train_end``, it holds the swapped-in average."""

    def __init__(self, ckpt_dir: str, every_epochs: int = 10):
        self.ckpt_dir = ckpt_dir
        self.every = max(every_epochs, 1)

    def on_epoch_end(self, epoch, logs):
        if (epoch + 1) % self.every == 0 and mesh_lib.is_writer():
            checkpoint.save_train_state(self.ckpt_dir, self.loop.state)

    def on_train_end(self, logs=None):
        if mesh_lib.is_writer():
            checkpoint.save_train_state(self.ckpt_dir, self.loop.state)


class TensorBoard(Callback):
    """Scalar logging to TensorBoard event files through
    ``torch.utils.tensorboard`` (reference: sj_train.py:494). Where that
    writer cannot be made (no ``tensorboard`` package, an unwritable log
    dir) it says so once on stdout and does nothing, as the JAX callback
    does. A rank other than 0 makes no writer."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = None
        if not mesh_lib.is_writer():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(log_dir)
        except Exception as e:   # logging must not stop a training run
            print(f'WARNING: TensorBoard logging disabled '
                  f'(writer for {log_dir!r} failed: {e!r})')

    def on_epoch_end(self, epoch, logs):
        if self._writer is None:
            return
        for k, v in logs.items():
            self._writer.add_scalar(k, float(v), epoch)
        self._writer.flush()

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
