"""Train state and the train/eval steps (counterpart:
``challenge_tpu/train/state.py``; reference: ``CustomModel.train_step``,
sj_train.py:158-188).

The step is the reference's: training-mode forward (batch-statistics BN,
running statistics updated), loss, gradients, adaptive gradient clipping
(vad and se families), the se cascade's freeze mask, then the optimizer
(clipvalue + Keras Adam). As in the JAX package it is split at the
gradient (``make_grad_update``), so the gradients can be inspected or,
later, accumulated. Metrics read the first output and target of a
multi-output model, the se cascade's class head (state.py:60).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

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


def make_grad_update(bundle: ModelBundle):
    """The train step split at the gradient boundary. Returns
    ``(grad_fn, update_fn)``:

    * ``grad_fn(module, batch) -> (grads, metrics)``: training-mode
      forward (which moves the BN running statistics), loss and backward
      over one batch; ``grads`` follow ``module.parameters()``;
    * ``update_fn(state, grads)``: AGC, the se freeze mask, then the
      optimizer, in place.

    AGC applies to the families built on the reference's CustomModel
    ('vad' and 'se'); the others only get the optimizer's clipvalue. The
    freeze mask multiplies the frozen half's gradients by 0 after AGC
    (state.py:115-127), so Keras Adam's moments of those weights stay 0
    and their update is exactly 0: the weights stay bit-identical."""
    config = bundle.config
    loss_fn = get_loss(config)
    metric_fns = metrics_lib.batch_metrics(config)
    use_agc = config.model_type in ('vad', 'se')
    transposed = transposed_weights(bundle.module)
    mask = bundle.trainable_mask() if config.model_type == 'se' else None

    def grad_fn(module: nn.Module, batch):
        x, y = batch
        module.train()
        out = module(x)
        loss, parts = loss_fn(y, out)
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


def make_train_step(bundle: ModelBundle):
    """``train_step(state, (x, y)) -> metrics``; updates ``state`` in
    place."""
    grad_fn, update_fn = make_grad_update(bundle)

    def train_step(state: TrainState, batch):
        grads, metrics = grad_fn(state.module, batch)
        update_fn(state, grads)
        return metrics

    return train_step


def make_eval_step(bundle: ModelBundle):
    """Validation step: inference-mode forward + loss + metrics."""
    config = bundle.config
    loss_fn = get_loss(config)
    metric_fns = metrics_lib.batch_metrics(config)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        x, y = batch
        state.module.eval()
        out = state.module(x)
        loss, parts = loss_fn(y, out)
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
