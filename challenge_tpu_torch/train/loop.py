"""The training loop, ``model.fit`` (counterpart: ``challenge_tpu/train/loop.py``;
reference: sj_train.py:513-519).

One epoch is ``steps_per_epoch`` train steps, then ``validation_steps``
eval steps. Metrics are summed on the device and read once per epoch, so
the host does not wait on the card between steps. Two sources of batches:

* iterator mode: ``fit(train_iter, ...)`` consumes (x, y) batches, e.g.
  from a :class:`~challenge_tpu_torch.data.pipeline.DevicePipeline`;
* banks mode: ``TrainLoop(bundle, banks=, val_banks=)`` runs a
  ``DevicePipeline`` over the banks for each (epoch, phase), seeded by
  (seed, epoch, phase), so a given epoch always draws the same batches.
  The values are those of JAX's fused mode (synthesis, then features, then
  the step), whose one-XLA-program form is a TPU device and is not ported.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from challenge_tpu_torch.data.mixture import Banks
from challenge_tpu_torch.data.pipeline import DevicePipeline
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.train.callbacks import Callback
from challenge_tpu_torch.train.metrics import f1_from_counts
from challenge_tpu_torch.train.state import (
    init_state, make_eval_step, make_train_step)


def _refuse_unported(config) -> None:
    """The loop's scale-out settings of ROADMAP A14 (the CLI refuses the
    bank ones, ``stream_chunks`` and ``bank_shard``)."""
    for flag in ('steps_per_call', 'grad_accum'):
        if getattr(config, flag) > 1:
            raise NotImplementedError(
                f'{flag}={getattr(config, flag)} is not ported yet '
                '(ROADMAP A14)')


class TrainLoop:
    """Owns the TrainState and drives epochs, with Keras-style callbacks."""

    def __init__(self, bundle: ModelBundle, seed: int = 0,
                 banks: Optional[Banks] = None,
                 val_banks: Optional[Banks] = None):
        _refuse_unported(bundle.config)
        self.bundle = bundle
        self.config = bundle.config
        self.seed = seed
        self.train_step = make_train_step(bundle)
        self.eval_step = make_eval_step(bundle)
        self.state = init_state(bundle, seed)
        self.banks, self.val_banks = banks, val_banks
        self.stop_training = False
        self.history: List[dict] = []

    # Keras-model-like surface used by callbacks
    def get_weights(self) -> dict:
        """A copy of the module's weights and BN statistics."""
        return {k: v.detach().clone()
                for k, v in self.state.module.state_dict().items()}

    def set_weights(self, weights) -> None:
        """Copy ``weights`` (a state_dict) into the module; no tensor of
        ``weights`` is aliased, so it may be the state's own SWA average."""
        self.state.module.load_state_dict(weights)

    def _pipeline(self, epoch: int, training: bool) -> DevicePipeline:
        """Banks mode's batches of (seed, epoch, phase) (loop.py:135-142)."""
        seed = np.random.SeedSequence([self.seed, epoch, int(training)])
        return DevicePipeline(self.banks if training else self.val_banks,
                              self.config, training,
                              seed=int(seed.generate_state(1)[0]),
                              device=self.bundle.device)

    def _finalize(self, sums, count):
        # a multi-output model logs its class head's metrics under Keras'
        # per-head names (loop.py:120-133): class_er, class_f1_score, ...
        prefix = 'class_' if self.bundle.multi_output else ''
        logs = {}
        for k, v in sums.items():
            if k == 'f1_counts':
                logs[prefix + 'f1_score'] = float(f1_from_counts(v.tolist()))
            elif k in ('cos_sim', 'er'):
                logs[prefix + k] = float(v) / count
            else:
                logs[k] = float(v) / count
        return logs

    def _batches(self, data_iter, steps: int, training: bool, epoch: int):
        if data_iter is None:
            data_iter = iter(self._pipeline(epoch, training))
        for _ in range(steps):
            yield next(data_iter)

    def run_epoch(self, data_iter, steps: int, training: bool,
                  epoch: int = 0):
        sums, count = {}, 0
        for batch in self._batches(data_iter, steps, training, epoch):
            if training:
                metrics = self.train_step(self.state, batch)
            else:
                metrics = self.eval_step(self.state, batch)
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
            count += 1
        return self._finalize(sums, count)

    def fit(self, train_iter=None, epochs: int = 1, steps_per_epoch: int = 100,
            validation_iter=None, validation_steps: int = 16,
            callbacks: Sequence[Callback] = (), verbose: int = 1,
            initial_epoch: int = 0):
        """Reference defaults: 100 steps/epoch, 16 validation steps
        (sj_train.py:513-519). In banks mode the iterators are not used and
        validation runs iff ``val_banks`` were given. ``initial_epoch``
        starts the epoch count (and the epoch-indexed callbacks) later.
        Returns this run's per-epoch logs."""
        if self.banks is None and train_iter is None:
            raise ValueError('fit needs train_iter, or banks at construction')
        # per-run state (Keras resets both at the top of every fit): a stale
        # stop_training would end a reused loop after one epoch, and the
        # returned history covers this run only
        self.stop_training = False
        run_history: List[dict] = []
        for cb in callbacks:
            cb.set_loop(self)
            cb.on_train_begin()
        train_it = iter(train_iter) if train_iter is not None else None
        val_it = iter(validation_iter) if validation_iter is not None else None
        validate = val_it is not None or (self.banks is not None
                                          and self.val_banks is not None)
        for epoch in range(initial_epoch, epochs):
            t0 = time.time()
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            logs = self.run_epoch(train_it, steps_per_epoch, True, epoch)
            if validate:
                val_logs = self.run_epoch(val_it, validation_steps, False,
                                          epoch)
                logs.update({f'val_{k}': v for k, v in val_logs.items()})
            logs['time'] = time.time() - t0
            self.history.append(logs)
            run_history.append(logs)
            if verbose:
                msg = ' - '.join(f'{k}: {v:.4f}' for k, v in logs.items())
                print(f'Epoch {epoch + 1}/{epochs} - {msg}', flush=True)
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        for cb in callbacks:
            cb.on_train_end()
        return run_history
