"""The training loop, ``model.fit`` (counterpart: ``challenge_tpu/train/loop.py``
in its iterator mode; reference: sj_train.py:513-519).

One epoch is ``steps_per_epoch`` train steps over (x, y) batches, e.g. from
a :class:`~challenge_tpu_torch.data.pipeline.DevicePipeline`, then
``validation_steps`` eval steps. Metrics are summed on the device and read
once per epoch, so the host does not wait on the card between steps.
"""

from __future__ import annotations

import time
from typing import List

from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.train.metrics import f1_from_counts
from challenge_tpu_torch.train.state import (
    init_state, make_eval_step, make_train_step)


class TrainLoop:
    """Owns the TrainState and drives epochs over device-batch iterators.
    Callbacks, checkpoints and ``initial_epoch`` come with the CLI
    (ROADMAP A8)."""

    def __init__(self, bundle: ModelBundle, seed: int = 0):
        self.bundle = bundle
        self.config = bundle.config
        self.train_step = make_train_step(bundle)
        self.eval_step = make_eval_step(bundle)
        self.state = init_state(bundle, seed)
        self.history: List[dict] = []

    @staticmethod
    def _finalize(sums, count):
        logs = {}
        for k, v in sums.items():
            if k == 'f1_counts':
                logs['f1_score'] = float(f1_from_counts(v.tolist()))
            else:
                logs[k] = float(v) / count
        return logs

    def run_epoch(self, data_iter, steps: int, training: bool):
        sums, count = {}, 0
        for _ in range(steps):
            batch = next(data_iter)
            if training:
                metrics = self.train_step(self.state, batch)
            else:
                metrics = self.eval_step(self.state, batch)
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
            count += 1
        return self._finalize(sums, count)

    def fit(self, train_iter, epochs: int = 1, steps_per_epoch: int = 100,
            validation_iter=None, validation_steps: int = 16,
            verbose: int = 1):
        """Reference defaults: 100 steps/epoch, 16 validation steps
        (sj_train.py:513-519). Returns this run's per-epoch logs."""
        run_history: List[dict] = []
        train_it = iter(train_iter)
        val_it = iter(validation_iter) if validation_iter is not None else None
        for epoch in range(epochs):
            t0 = time.time()
            logs = self.run_epoch(train_it, steps_per_epoch, training=True)
            if val_it is not None:
                val_logs = self.run_epoch(val_it, validation_steps,
                                          training=False)
                logs.update({f'val_{k}': v for k, v in val_logs.items()})
            logs['time'] = time.time() - t0
            self.history.append(logs)
            run_history.append(logs)
            if verbose:
                msg = ' - '.join(f'{k}: {v:.4f}' for k, v in logs.items())
                print(f'Epoch {epoch + 1}/{epochs} - {msg}', flush=True)
        return run_history
