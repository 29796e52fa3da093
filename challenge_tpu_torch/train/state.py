"""Train state and the train/eval steps (counterpart:
``challenge_tpu/train/state.py``; reference: ``CustomModel.train_step``,
sj_train.py:158-188).

The step is the reference's: training-mode forward (batch-statistics BN,
running statistics updated), loss, gradients, adaptive gradient clipping
(vad and se families), the se cascade's freeze mask, then the optimizer
(clipvalue + Keras Adam, or AdaBelief for the density trainer). As in the
JAX package it is split at the gradient (``make_grad_update``), so the
gradients can be inspected or accumulated (:func:`accumulate_grads`).
Metrics read the first output and target of a multi-output model, the se
cascade's class head (state.py:60).

On a data-parallel mesh (``mesh=``, ``parallel.mesh``) each rank runs the
step on its equal share of the global batch, its BatchNorms under
``models.layers.cross_replica``. The global loss is the mean of the
shares' means, so the update sums the ranks' gradients and divides by
their count before AGC, the freeze mask and the optimizer, which then
move every rank's weights alike (AGC's clipped gradients are rank 0's,
broadcast). A penalty that every rank adds (the
kernel regularizer) is counted once by that division. The metrics are
reduced as JAX's global-batch metrics are (:func:`reduce_metrics`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from challenge_tpu_torch.models.layers import cross_replica, remat_contexts
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.train import metrics as metrics_lib
from challenge_tpu_torch.train.graph import StepGraphs, capturable, on_cuda
from challenge_tpu_torch.train.losses import get_loss
from challenge_tpu_torch.train.optim import (
    adaptive_clip_grad, make_optimizer, transposed_weights)


@dataclasses.dataclass
class TrainState:
    """The module holds the weights and BN statistics; ``swa`` holds their
    running average (reference swa.py:36-44), keyed like its state_dict."""
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    swa: Optional[Dict[str, torch.Tensor]] = None
    swa_count: int = 0


def init_state(bundle: ModelBundle, seed: int = 0) -> TrainState:
    """Fresh weights from ``seed`` and a fresh optimizer."""
    bundle.init(seed)
    module = bundle.module
    optimizer = make_optimizer(bundle.config, module.parameters())
    swa = {k: torch.zeros_like(v) for k, v in module.state_dict().items()}
    return TrainState(module, optimizer, 0, swa, 0)


def _first(x):
    return x[0] if isinstance(x, (tuple, list)) else x


def _metrics(metric_fns, loss, parts, y, out):
    metrics = {'loss': loss.detach(),
               **{k: v.detach() for k, v in parts.items()}}
    for name, fn in metric_fns.items():
        metrics[name] = fn(_first(y), _first(out).detach())
    return metrics


def _loss_of(loss_fn, y, out, module):
    """``loss_fn(y, out)``, or ``loss_fn(y, out, module)`` for a loss that
    carries ``needs_params`` (a kernel regularizer, state.py:94-97)."""
    if getattr(loss_fn, 'needs_params', False):
        return loss_fn(y, out, module)
    return loss_fn(y, out)


def reduce_metrics(metrics: dict, mesh) -> dict:
    """The global batch's metrics from each rank's over its equal share:
    the F1 counts summed, every other metric (a mean over the share) the
    mean over the ranks. Without a mesh, ``metrics`` as they are."""
    if mesh is None:
        return metrics
    out = {k: v.clone() for k, v in metrics.items()}
    mesh.all_reduce_(list(out.values()))
    return {k: v if k == 'f1_counts' else v / mesh.size
            for k, v in out.items()}


def reduce_grads(grads, mesh):
    """The ranks' gradients summed and divided by their count."""
    grads = [g.clone() for g in grads]
    mesh.all_reduce_(grads)
    return [g / mesh.size for g in grads]


def make_grad_update(bundle: ModelBundle, loss_fn=None, mesh=None):
    """The train step split at the gradient boundary. ``loss_fn`` is
    ``(y, out) -> (loss, parts)``, by default ``get_loss(config)`` (see
    :func:`_loss_of` for one that needs the module). Returns
    ``(grad_fn, update_fn)``:

    * ``grad_fn(module, batch, gen=None) -> (grads, metrics)``:
      training-mode forward (which moves the BN running statistics), loss
      and backward over one batch; ``grads`` follow
      ``module.parameters()``. ``gen`` is the generator of the eff
      family's stochastic depth (``bundle.needs_dropout_gen``), which
      raises without one; the other families take none;
    * ``update_fn(state, grads)``: AGC, the se freeze mask, then the
      optimizer, in place.

    With ``config.remat`` the forward and the loss run under a
    non-reentrant ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint`` of
    ``loss_of``, state.py:99-106), which keeps no activation and runs the
    forward again in the backward; ``models.layers.remat_contexts`` keeps
    that recompute from moving the BN statistics again or drawing new
    keep masks, so the step equals the one without remat.

    AGC applies to the families built on the reference's CustomModel
    ('vad' and 'se'); the others only get the optimizer's clipvalue. The
    freeze mask multiplies the frozen half's gradients by 0 after AGC
    (state.py:115-127), so Keras Adam's moments of those weights stay 0
    and their update is exactly 0: the weights stay bit-identical.

    With a ``mesh``, ``grad_fn`` runs its forward and backward with
    cross-replica BN statistics, and ``update_fn`` first reduces the
    gradients over the ranks (:func:`reduce_grads`)."""
    config = bundle.config
    loss_fn = loss_fn or get_loss(config)
    metric_fns = metrics_lib.batch_metrics(config)
    use_agc = config.model_type in ('vad', 'se')
    transposed = transposed_weights(bundle.module)
    mask = bundle.trainable_mask() if config.model_type == 'se' else None

    needs_gen = bundle.needs_dropout_gen
    remat = bool(getattr(config, 'remat', False))

    def grad_fn(module: nn.Module, batch, gen=None):
        if mesh is None:
            return local_grad_fn(module, batch, gen)
        with cross_replica(mesh):
            return local_grad_fn(module, batch, gen)

    def local_grad_fn(module: nn.Module, batch, gen=None):
        x, y = batch
        module.train()

        def loss_of(x):
            out = module(x, gen) if needs_gen else module(x)
            loss, parts = _loss_of(loss_fn, y, out, module)
            return loss, parts, out

        if remat:
            loss, parts, out = checkpoint(
                loss_of, x, use_reentrant=False, preserve_rng_state=False,
                context_fn=remat_contexts)
        else:
            loss, parts, out = loss_of(x)
        grads = torch.autograd.grad(loss, list(module.parameters()))
        with torch.no_grad():
            return grads, _metrics(metric_fns, loss, parts, y, out)

    @torch.no_grad()
    def update_fn(state: TrainState, grads) -> None:
        params = list(state.module.parameters())
        if mesh is not None:
            grads = reduce_grads(grads, mesh)
        if use_agc:
            grads = adaptive_clip_grad(params, grads, transposed=transposed)
            if mesh is not None:
                # the unit norms are reductions whose rounding may follow
                # a buffer's address, which differs from rank to rank:
                # rank 0's clipped gradients keep the ranks identical
                mesh.broadcast_(grads)
        if mask is not None:
            grads = [g * float(m) for g, m in zip(grads, mask)]
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()
        state.step += 1

    return grad_fn, update_fn


def _mean(values):
    """The mean over a list of equal-shaped tensors, as ``jnp.mean(axis=0)``
    of their stack."""
    return torch.stack(values).mean(dim=0)


def mean_metrics(metrics):
    """A list of metric dicts -> each metric's mean; one dict as it is."""
    if len(metrics) == 1:
        return metrics[0]
    return {k: _mean([m[k] for m in metrics]) for k in metrics[0]}


def accumulate_grads(grad_fn, module: nn.Module, batches: Iterable,
                     gen=None):
    """JAX's microbatch scan (parallel/train.py:188-208): ``grad_fn`` over
    each batch in order (each forward moves the BN statistics, so they
    thread through the microbatches), the gradients summed in that order
    and divided by their count k, each metric the mean over the
    microbatches. Returns ``(grads, metrics)``; one batch gives its own."""
    grads, metrics = None, []
    for batch in batches:
        g, m = grad_fn(module, batch, gen)
        grads = list(g) if grads is None else [a + b
                                               for a, b in zip(grads, g)]
        metrics.append(m)
    k = len(metrics)
    if k > 1:
        grads = [g / k for g in grads]
    return grads, mean_metrics(metrics)


class TrainStep:
    """``step(state, (x, y), gen=None) -> metrics``, the iterator-mode
    train step (counterpart: ``make_train_step``'s ``jax.jit``,
    state.py:132-150); updates ``state`` in place. On a CUDA module,
    alone or on an NCCL ``mesh``, it is a CUDA graph a batch signature
    (``train.graph``), with the stochastic-depth generator ``gen``
    registered; the graph holds the whole of :meth:`plain`, the mesh's
    collectives and the metrics' reduction included, so a replay returns
    the global batch's metrics. On the CPU and on a gloo mesh (gloo's
    collectives cannot be captured) it runs :meth:`plain`. The mode
    (training) and the loss's ``needs_params`` penalty are fixed before
    the capture, so the graph holds them."""

    def __init__(self, bundle: ModelBundle, loss_fn=None, mesh=None):
        self.grad_fn, self.update_fn = make_grad_update(bundle, loss_fn,
                                                        mesh)
        self.mesh = mesh
        self.needs_gen = bundle.needs_dropout_gen
        self.graphs = StepGraphs(lambda refs: refs)

    def run(self, state, batch, gen=None):
        """One eager step; on a mesh the rank's metrics."""
        grads, metrics = self.grad_fn(state.module, batch, gen)
        self.update_fn(state, grads)
        return metrics

    def plain(self, state, batch, gen=None):
        """The eager step; on a mesh the global batch's metrics."""
        return reduce_metrics(self.run(state, batch, gen), self.mesh)

    def __call__(self, state, batch, gen=None):
        if not (on_cuda(state) and capturable(self.mesh)):
            return self.plain(state, batch, gen)
        return self.graphs(self.plain, state, batch,
                           gen if self.needs_gen else None)


class EvalStep:
    """``step(state, (x, y)) -> metrics``, the validation step
    (counterpart: ``make_eval_step``'s ``jax.jit``, state.py:153-172):
    inference-mode forward, loss and metrics; the loss of a
    ``needs_params`` ``loss_fn`` includes its penalty, as JAX's does. As
    :class:`TrainStep`: on a ``mesh`` the batch is the rank's share and
    the metrics the global batch's; a CUDA graph a batch signature on the
    card, alone or on an NCCL mesh, captured in eval mode; eager
    (:meth:`plain`) on the CPU and on a gloo mesh."""

    def __init__(self, bundle: ModelBundle, loss_fn=None, mesh=None):
        self.loss_fn = loss_fn or get_loss(bundle.config)
        self.metric_fns = metrics_lib.batch_metrics(bundle.config)
        self.mesh = mesh
        self.graphs = StepGraphs()

    @torch.no_grad()
    def run(self, state, batch):
        """One eager step; on a mesh the rank's metrics."""
        x, y = batch
        state.module.eval()
        out = state.module(x)
        loss, parts = _loss_of(self.loss_fn, y, out, state.module)
        return _metrics(self.metric_fns, loss, parts, y, out)

    def plain(self, state, batch):
        """The eager step; on a mesh the global batch's metrics."""
        return reduce_metrics(self.run(state, batch), self.mesh)

    def __call__(self, state, batch):
        if not (on_cuda(state) and capturable(self.mesh)):
            return self.plain(state, batch)
        return self.graphs(self.plain, state, batch)


def make_train_step(bundle: ModelBundle, loss_fn=None,
                    mesh=None) -> TrainStep:
    """The train step, :class:`TrainStep`; ``gen``, ``loss_fn`` and
    ``mesh`` as for :func:`make_grad_update`; on a mesh ``(x, y)`` is the
    rank's share and the metrics are the global batch's."""
    return TrainStep(bundle, loss_fn, mesh)


def make_eval_step(bundle: ModelBundle, loss_fn=None,
                   mesh=None) -> EvalStep:
    """The validation step, :class:`EvalStep`."""
    return EvalStep(bundle, loss_fn, mesh)


@torch.no_grad()
def swa_update(state: TrainState) -> None:
    """Fold the current weights and BN statistics into the SWA running
    average (reference: swa.py:36-44)."""
    cnt = float(state.swa_count)
    for k, w in state.module.state_dict().items():
        state.swa[k] = (state.swa[k] * cnt + w) / (cnt + 1.0)
    state.swa_count += 1
