"""The training loop, ``model.fit`` (counterpart: ``challenge_tpu/train/loop.py``;
reference: sj_train.py:513-519).

One epoch is ``steps_per_epoch`` train steps, then ``validation_steps``
eval steps. Metrics are summed on the device and read once per epoch, so
the host does not wait on the card between steps. Two sources of batches:

* iterator mode: ``fit(train_iter, ...)`` consumes (x, y) batches, e.g.
  from a :class:`~challenge_tpu_torch.data.pipeline.DevicePipeline`, one
  train step each (``config.steps_per_call`` does not apply, and
  ``config.grad_accum`` > 1 raises, as in JAX);
* banks mode: ``TrainLoop(bundle, banks=, val_banks=)`` runs JAX's fused
  step (``parallel.train``): draws, synthesis, features, forward,
  backward and the update of ``config.grad_accum`` microbatches a step,
  ``config.steps_per_call`` steps a call, one CUDA graph a step on the
  card and eager on the CPU. A training epoch is ``ceil(steps /
  steps_per_call)`` calls (:meth:`TrainLoop.steps_per_fused_epoch`), and
  its logs are the mean over calls of each call's mean. Each phase draws
  from one generator, reseeded by (seed, epoch, phase) at each epoch, so
  a given epoch always draws the same batches. ``banks`` may be a
  :class:`~challenge_tpu_torch.data.streaming.StreamingBanks` rotation:
  each training call takes its ``next_banks()``, and ``fit`` first puts
  its cursor where the state's step has it (loop.py:199-207), so a
  restored run trains on the chunks the uninterrupted one would.

A model with stochastic depth (the eff family) trains each epoch with its
generator reseeded by (seed, epoch) on a stream of its own
(:meth:`TrainLoop.dropout_gen`), so a given epoch drops the same samples
after a restart, as JAX's per-epoch keys do (loop.py:135-142).

On a data-parallel mesh (``mesh=``, banks mode only; counterpart:
loop.py:40-95) every rank runs the loop: rank 0's initial state is
broadcast to the others, each rank takes its block of the banks'
clip axis with ``config.bank_shard`` (``parallel.mesh.shard_banks``) or
a whole copy on its device otherwise, a rotation uploads every chunk to
each rank's device, and the phase and stochastic-depth generators are
seeded by the rank too, so the ranks draw different shares of each
batch. The steps return the global batch's metrics, so every rank logs
the same values and its callbacks take the same decisions.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from challenge_tpu_torch.data.mixture import Banks
from challenge_tpu_torch.data.streaming import StreamingBanks, map_banks
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.parallel.mesh import replicate, shard_banks
from challenge_tpu_torch.parallel.train import (
    make_fused_eval_step, make_fused_train_step)
from challenge_tpu_torch.train.callbacks import Callback
from challenge_tpu_torch.train.metrics import f1_from_counts
from challenge_tpu_torch.train.state import (
    init_state, make_eval_step, make_train_step)


class TrainLoop:
    """Owns the TrainState and drives epochs, with Keras-style callbacks.
    ``loss_fn`` replaces ``get_loss(config)`` in the train and eval steps
    (``state.make_grad_update``); ``variant`` is the banks mode's batch
    (``'sj'`` or the density trainer's ``'density'``); ``mesh`` the
    joined data-parallel mesh this process is a rank of, if any."""

    def __init__(self, bundle: ModelBundle, seed: int = 0,
                 banks: Optional[Union[Banks, StreamingBanks]] = None,
                 val_banks: Optional[Banks] = None, loss_fn=None,
                 variant: str = 'sj', mesh=None):
        self.bundle = bundle
        self.config = bundle.config
        self.seed = seed
        self.mesh = mesh
        self.fused = banks is not None
        self.streaming = isinstance(banks, StreamingBanks)
        bank_shard = bool(self.config.bank_shard) and mesh is not None
        if mesh is not None and not self.fused:
            raise ValueError('a mesh trains in banks mode (pass banks=)')
        if self.streaming and bank_shard:
            raise ValueError(
                'streaming bank rotation and bank_shard are exclusive: '
                'sharded chunks would re-upload per-device slices every '
                'rotation — pick one capacity axis')
        if self.fused:
            self.train_step = make_fused_train_step(
                bundle, self.config, loss_fn, variant, mesh=mesh,
                bank_sharded=bank_shard)
            self.eval_step = make_fused_eval_step(
                bundle, self.config, loss_fn, variant, mesh=mesh,
                bank_sharded=bank_shard)
            self.steps_per_call = self.train_step.steps_per_call
        else:
            if max(int(self.config.grad_accum), 1) > 1:
                raise ValueError(
                    'grad_accum > 1 needs fused banks mode (pass banks=): '
                    'iterator-mode batches arrive one at a time, so the '
                    'loop cannot accumulate microbatches inside the step')
            self.train_step = make_train_step(bundle, loss_fn)
            self.eval_step = make_eval_step(bundle, loss_fn)
            self.steps_per_call = 1
        self.state = init_state(bundle, seed)
        if mesh is not None:
            replicate(self.state.module, mesh)
            if self.streaming:
                banks.set_placement(mesh.device)
            else:
                banks = self._place(banks, bank_shard)
            if val_banks is not None:
                val_banks = self._place(val_banks, bank_shard)
        self.banks, self.val_banks = banks, val_banks
        self.stop_training = False
        self.history: List[dict] = []
        self._gens = {}      # banks mode's phase generators, then dropout's
        self.gen = None      # the last training epoch's dropout generator

    def _place(self, banks: Banks, shard: bool) -> Banks:
        """The rank's block of ``banks`` (``shard``), or all of them on the
        rank's device."""
        if shard:
            return shard_banks(banks, self.mesh)
        return map_banks(banks, lambda t: t.to(self.mesh.device))

    def _rank_key(self) -> list:
        """The rank, in the generators' seeds on a mesh."""
        return [] if self.mesh is None else [self.mesh.rank]

    def steps_per_fused_epoch(self, steps_per_epoch: int) -> int:
        """The optimizer steps a training epoch advances: in banks mode
        ``ceil(steps / steps_per_call)`` whole calls (loop.py:97-108)."""
        n_calls = max(-(-int(steps_per_epoch) // self.steps_per_call), 1)
        return n_calls * self.steps_per_call

    # Keras-model-like surface used by callbacks
    def get_weights(self) -> dict:
        """A copy of the module's weights and BN statistics."""
        return {k: v.detach().clone()
                for k, v in self.state.module.state_dict().items()}

    def set_weights(self, weights) -> None:
        """Copy ``weights`` (a state_dict) into the module in place: no
        tensor of ``weights`` is aliased, so it may be the state's own SWA
        average, and the module's tensors keep the addresses a captured
        step reads."""
        self.state.module.load_state_dict(weights)

    def _generator(self, key, seed: np.random.SeedSequence):
        """The loop's generator ``key`` on the model's device, reseeded."""
        gen = self._gens.get(key)
        if gen is None:
            gen = self._gens[key] = torch.Generator(device=self.bundle.device)
        gen.manual_seed(int(seed.generate_state(1)[0]))
        return gen

    def phase_gen(self, epoch: int, training: bool) -> torch.Generator:
        """Banks mode's generator of (seed, epoch, phase) (loop.py:135-142):
        one per phase, reseeded for each epoch."""
        seed = np.random.SeedSequence([self.seed, epoch, int(training)]
                                      + self._rank_key())
        return self._generator(training, seed)

    def dropout_gen(self, epoch: int):
        """The stochastic-depth generator reseeded for a training epoch, or
        None for a model without stochastic depth."""
        if not self.bundle.needs_dropout_gen:
            return None
        seed = np.random.SeedSequence([self.seed, epoch] + self._rank_key(),
                                      spawn_key=(1,))
        return self._generator('dropout', seed)

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

    def _train_banks(self) -> Banks:
        return self.banks.next_banks() if self.streaming else self.banks

    def _val_banks(self) -> Banks:
        """``val_banks``, else the training banks (a rotation's current
        chunk), as JAX's ``run_epoch`` picks them."""
        if self.val_banks is not None:
            return self.val_banks
        return self.banks.peek() if self.streaming else self.banks

    def run_epoch(self, data_iter, steps: int, training: bool,
                  epoch: int = 0):
        sums, count = {}, 0
        if training:
            # kept, so a caller can see how far it was drawn
            self.gen = self.dropout_gen(epoch)
        if self.fused:
            gen = self.phase_gen(epoch, training)
            n_calls = (max(-(-steps // self.steps_per_call), 1)
                       if training else steps)
            calls = (self.train_step(self.state, self._train_banks(), gen,
                                     self.gen)
                     if training else
                     self.eval_step(self.state, self._val_banks(), gen)
                     for _ in range(n_calls))
        else:
            calls = (self.train_step(self.state, next(data_iter), self.gen)
                     if training else
                     self.eval_step(self.state, next(data_iter))
                     for _ in range(steps))
        for metrics in calls:
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
        if self.streaming:
            # the cursor is a function of the optimizer step, so a restored
            # state continues the chunk schedule; for a fresh loop, or one
            # continuing its own run, this changes nothing
            self.banks.restore_cursor(self.state.step // self.steps_per_call)
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
