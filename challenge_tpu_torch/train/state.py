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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from challenge_tpu_torch.models.layers import remat_contexts
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.train import metrics as metrics_lib
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


def make_grad_update(bundle: ModelBundle, loss_fn=None):
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
    and their update is exactly 0: the weights stay bit-identical."""
    config = bundle.config
    loss_fn = loss_fn or get_loss(config)
    metric_fns = metrics_lib.batch_metrics(config)
    use_agc = config.model_type in ('vad', 'se')
    transposed = transposed_weights(bundle.module)
    mask = bundle.trainable_mask() if config.model_type == 'se' else None

    needs_gen = bundle.needs_dropout_gen
    remat = bool(getattr(config, 'remat', False))

    def grad_fn(module: nn.Module, batch, gen=None):
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
        if use_agc:
            grads = adaptive_clip_grad(params, grads, transposed=transposed)
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


def make_train_step(bundle: ModelBundle, loss_fn=None):
    """``train_step(state, (x, y), gen=None) -> metrics``; updates
    ``state`` in place. ``gen`` and ``loss_fn`` as for
    :func:`make_grad_update`."""
    grad_fn, update_fn = make_grad_update(bundle, loss_fn)

    def train_step(state: TrainState, batch, gen=None):
        grads, metrics = grad_fn(state.module, batch, gen)
        update_fn(state, grads)
        return metrics

    return train_step


def make_eval_step(bundle: ModelBundle, loss_fn=None):
    """Validation step: inference-mode forward + loss + metrics; the loss
    of a ``needs_params`` ``loss_fn`` includes its penalty, as JAX's
    does."""
    config = bundle.config
    loss_fn = loss_fn or get_loss(config)
    metric_fns = metrics_lib.batch_metrics(config)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        x, y = batch
        state.module.eval()
        out = state.module(x)
        loss, parts = _loss_of(loss_fn, y, out, state.module)
        return _metrics(metric_fns, loss, parts, y, out)

    return eval_step


@torch.no_grad()
def swa_update(state: TrainState) -> None:
    """Fold the current weights and BN statistics into the SWA running
    average (reference: swa.py:36-44)."""
    cnt = float(state.swa_count)
    for k, w in state.module.state_dict().items():
        state.swa[k] = (state.swa[k] * cnt + w) / (cnt + 1.0)
    state.swa_count += 1
