"""The fused training step (counterpart:
``challenge_tpu/parallel/train.py``: ``make_fused_train_step``,
``make_fused_eval_step``).

JAX runs the draws, synthesis, features and labels, the forward and
backward, AGC, the se freeze mask and the optimizer of a step as one XLA
program, ``steps_per_call`` steps to a dispatch, each step of
``config.grad_accum`` microbatches. The port runs the same composition:

* eager on the CPU. This is the fused step's plain version
  (:meth:`FusedTrainStep.plain`), and it runs on the card too, for the
  checks;
* on CUDA as one CUDA graph of one optimizer step, captured at the first
  call and replayed ``steps_per_call`` times a call, so that a step costs
  the host one replay instead of some thousands of launches. The
  synthesis kernel of the run's mode and bank dtype (B1-B3,
  ``ops/synth.py``) launches inside it. The graph reads the phase's
  generator and the stochastic-depth generator as registered generator
  states, so a replay draws what the eager step would draw from their
  state, and reseeding them (``manual_seed``) between replays holds.

The eval step (:class:`FusedEvalStep`: draws, synthesis, features and the
eval-mode forward, loss and metrics) is one CUDA graph too, with the
phase's generator registered. Both use ``train.graph.StepGraphs``, the
scheme of the iterator-mode steps. There is no fallback: a failure to
capture or replay raises.

With a ``mesh`` (``parallel.mesh``; JAX: ``shard_map`` synthesis, then the
step partitioned over the mesh) each rank draws and synthesizes its own
``batch_size // W`` share with its phase generator, which the loop seeds
by the rank too (JAX: the step key folded with ``axis_index``), through
the synthesis kernel of its bank dtype on its device, then runs the step
with cross-replica BN statistics and the ranks' gradients summed
(``train.state``). With ``bank_sharded`` the banks it is given are the
rank's block of the clip axis (``mesh.shard_banks``). On an NCCL mesh
(``Mesh.capturable``) both steps are CUDA graphs as on one card, the
step's collectives captured with it (``train.graph``); the train step's
metrics are reduced over the ranks once a call, after its replays, as
:meth:`FusedTrainStep.plain` reduces them, the eval step's inside its
graph. On a gloo mesh they run eagerly (:meth:`FusedTrainStep.plain`,
:meth:`FusedEvalStep.plain`): gloo's collectives cannot be captured.
"""

from __future__ import annotations

from typing import Optional

import dataclasses

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import FeatureFn
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.train.graph import StepGraphs, capturable, on_cuda
from challenge_tpu_torch.train.state import (
    accumulate_grads, make_eval_step, make_grad_update, make_train_step,
    mean_metrics, reduce_metrics)


def make_sharded_feature_fn(config: Config, mesh, training: bool = True,
                            variant: str = 'sj', device=None):
    """The feature function of a rank's share of the batch, ``batch_size //
    mesh.size`` samples (JAX's ``shard_map`` body), or None when the batch
    does not divide the mesh. The rank's generator decides its draws; its
    banks may be replicated or its block (``bank_sharded``)."""
    if config.batch_size % mesh.size != 0:
        return None
    local = dataclasses.replace(config,
                                batch_size=config.batch_size // mesh.size)
    return FeatureFn(local, training, device or mesh.device, variant=variant)


def _mesh_features(config: Config, mesh, training: bool, variant: str,
                   device, bank_sharded: bool) -> FeatureFn:
    """The fused steps' feature function: the rank's share on a mesh, else
    the whole batch; JAX's ``ValueError`` for sharded banks without a
    mesh. A batch that does not divide the mesh raises too: JAX then
    synthesizes the global batch partitioned by XLA, which no rank can do
    alone."""
    if mesh is None:
        if bank_sharded:
            raise ValueError('bank_sharded requires a mesh')
        return FeatureFn(config, training, device, variant=variant)
    features = make_sharded_feature_fn(config, mesh, training, variant,
                                       device)
    if features is None:
        if bank_sharded:
            raise ValueError(
                'bank_sharded requires batch_size divisible by the mesh '
                f'({config.batch_size} % {mesh.size} != 0)')
        raise ValueError(f'a mesh step needs batch_size divisible by the '
                         f'mesh ({config.batch_size} % {mesh.size} != 0)')
    return features


def make_sharded_train_step(bundle: ModelBundle, mesh, loss_fn=None):
    """``step(state, (x, y), gen=None) -> metrics``: the train step over
    the mesh, ``(x, y)`` the rank's share of the global batch
    (``mesh.shard_batch``), the state replicated; the metrics are the
    global batch's."""
    return make_train_step(bundle, loss_fn, mesh)


def make_sharded_eval_step(bundle: ModelBundle, mesh, loss_fn=None):
    """The eval step over the mesh, as :func:`make_sharded_train_step`."""
    return make_eval_step(bundle, loss_fn, mesh)


class FusedTrainStep:
    """``step(state, banks, gen, dropout_gen=None) -> metrics``: runs
    ``steps_per_call`` optimizer steps on ``state`` in place, each over
    ``config.grad_accum`` microbatches drawn from ``banks`` with ``gen``
    (the phase's generator) and accumulated as
    ``state.accumulate_grads`` does; ``dropout_gen`` is the
    stochastic-depth generator of a model that takes one. Returns each
    metric's mean over the call's steps (parallel/train.py:211-216).

    On a CUDA device, alone or on an NCCL mesh, one step (:meth:`one`) is
    a CUDA graph (``train.graph``), bound to the state, banks and
    generators it was captured with; a call with others captures anew.
    The first call runs its first step eagerly on the graph's stream and
    captures it, then replays it for the rest of the call. Each replay
    adds the kernel launches it captured to ``ops.cuda.LAUNCHES`` and one
    to ``state.step``. On a mesh the call then reduces the mean of its
    steps' metrics over the ranks, as :meth:`plain` does; on the CPU and
    on a gloo mesh the call is :meth:`plain`."""

    def __init__(self, bundle: ModelBundle, config: Config, loss_fn=None,
                 variant: str = 'sj', steps_per_call: Optional[int] = None,
                 mesh=None, bank_sharded: bool = False):
        self.mesh = mesh
        self.grad_fn, self.update_fn = make_grad_update(bundle, loss_fn,
                                                        mesh)
        self.features = _mesh_features(config, mesh, True, variant,
                                       bundle.device, bank_sharded)
        self.grad_accum = max(int(config.grad_accum), 1)
        if steps_per_call is None:
            steps_per_call = config.steps_per_call
        self.steps_per_call = max(int(steps_per_call), 1)
        self.graphs = StepGraphs(lambda refs: refs[1:])

    def one(self, state, banks, gen, dropout_gen=None):
        """One optimizer step, eager; returns its metrics."""
        batches = (self.features(gen, banks) for _ in range(self.grad_accum))
        grads, metrics = accumulate_grads(self.grad_fn, state.module,
                                          batches, dropout_gen)
        self.update_fn(state, grads)
        return metrics

    def plain(self, state, banks, gen, dropout_gen=None):
        """The plain version: ``steps_per_call`` eager steps; on a mesh
        the global batch's metrics."""
        return reduce_metrics(
            mean_metrics([self.one(state, banks, gen, dropout_gen)
                          for _ in range(self.steps_per_call)]), self.mesh)

    def body(self, state, _batch, banks, gen, dropout_gen=None):
        """What a graph holds: :meth:`one` (the fused steps take no
        batch)."""
        return self.one(state, banks, gen, dropout_gen)

    def __call__(self, state, banks, gen, dropout_gen=None):
        if not (on_cuda(state) and capturable(self.mesh)):
            return self.plain(state, banks, gen, dropout_gen)
        steps = [self.graphs(self.body, state, None, banks, gen, dropout_gen)
                 for _ in range(self.steps_per_call)]
        return reduce_metrics(mean_metrics(steps), self.mesh)


class FusedEvalStep:
    """``step(state, banks, gen) -> metrics``: one validation batch drawn
    from ``banks`` with ``gen`` (on a mesh the rank's share), then the
    inference-mode forward, loss and metrics (the global batch's). On a
    CUDA device, alone or on an NCCL mesh, the draws, the synthesis
    kernel and the eval step, the metrics' reduction over the ranks
    included, are one CUDA graph with ``gen`` registered, bound as
    :class:`FusedTrainStep`'s; eager on the CPU and on a gloo mesh
    (:meth:`plain`)."""

    def __init__(self, bundle: ModelBundle, config: Config, loss_fn=None,
                 variant: str = 'sj', mesh=None, bank_sharded: bool = False):
        self.mesh = mesh
        self.features = _mesh_features(config, mesh, False, variant,
                                       bundle.device, bank_sharded)
        self.eval_step = make_eval_step(bundle, loss_fn, mesh)
        self.graphs = StepGraphs(lambda refs: refs[1:])

    def plain(self, state, banks, gen):
        """The plain version, eager."""
        return self.eval_step.plain(state, self.features(gen, banks))

    def body(self, state, _batch, banks, gen):
        """What the graph holds: :meth:`plain`."""
        return self.plain(state, banks, gen)

    def __call__(self, state, banks, gen):
        if not (on_cuda(state) and capturable(self.mesh)):
            return self.plain(state, banks, gen)
        return self.graphs(self.body, state, None, banks, gen)


def make_fused_train_step(bundle: ModelBundle, config: Config, loss_fn=None,
                          variant: str = 'sj',
                          steps_per_call: Optional[int] = None, mesh=None,
                          bank_sharded: bool = False) -> FusedTrainStep:
    """The fused train step of ``config`` (its ``steps_per_call`` unless
    given, its ``grad_accum`` and ``remat``); ``variant`` the batch's
    (``'sj'`` or ``'density'``), ``loss_fn`` as for
    ``state.make_grad_update``. On a ``mesh`` the rank's share of each
    batch, from the rank's block of the banks with ``bank_sharded``
    (which needs a mesh and a batch that divides it, JAX's
    ``ValueError``s)."""
    return FusedTrainStep(bundle, config, loss_fn, variant, steps_per_call,
                          mesh, bank_sharded)


def make_fused_eval_step(bundle: ModelBundle, config: Config, loss_fn=None,
                         variant: str = 'sj', mesh=None,
                         bank_sharded: bool = False) -> FusedEvalStep:
    """The fused eval step: a validation batch, then the eval step; the
    mesh as for :func:`make_fused_train_step`."""
    return FusedEvalStep(bundle, config, loss_fn, variant, mesh,
                         bank_sharded)
