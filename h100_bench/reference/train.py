"""The training step of the fit cells, plain: the training-mode forward,
the loss, the gradients, AGC (the vad family), the elementwise clip at
``clipvalue`` and Keras Adam or AdaBelief; and the validation loss.

Losses: Keras' BCE (the prediction clipped to [1e-7, 1 - 1e-7]); the
density trainer's count + total-variation loss (alpha 0.8, weight 1) plus
``l2`` times the sum of squares of every conv and Dense kernel. AGC
(NFNet, clip factor 0.01, eps 1e-3) scales each output unit's gradient
down to 0.01 times its weight's unit norm. Keras Adam adds eps to the
uncorrected root and folds the bias correction into the step size;
AdaBelief tracks (g - m)^2 in place of g^2.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

KERAS_EPS = 1e-7


def bce(y, p):
    p = torch.clamp(p, KERAS_EPS, 1.0 - KERAS_EPS)
    return -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p)).mean()


def _abs(x):
    return torch.where(x >= 0, x, -x)


def density_loss(y, p, alpha: float = 0.8, weight: float = 1.0):
    t_true = y.reshape(y.shape[:-1] + (3, -1))
    t_pred = p.reshape(p.shape[:-1] + (3, -1))
    loss = tv = 0.0
    for w, axis in ((alpha, -2), (1 - alpha, -1)):
        true, pred = t_true.sum(dim=axis), t_pred.sum(dim=axis)
        s_true, s_pred = true.sum(dim=1), pred.sum(dim=1)
        loss = loss + w * _abs(s_true - s_pred).mean(dim=-1)
        n_true = true / torch.clamp(s_true[:, None], min=1e-8)
        n_pred = pred / torch.clamp(s_pred[:, None], min=1e-8)
        tv = tv + w * (_abs(n_true - n_pred).sum(dim=1) * s_true).mean(dim=1)
    return (loss + weight * tv).mean()


def kernels(module: nn.Module):
    return [m.weight for m in module.modules()
            if isinstance(m, (nn.Conv2d, nn.Linear))]


def loss_of(train_cfg: dict, module: nn.Module, y, out):
    if train_cfg['loss'] == 'bce':
        loss = bce(y, out)
    elif train_cfg['loss'] == 'density':
        loss = density_loss(y, out)
    else:
        raise ValueError(f"unknown loss {train_cfg['loss']!r}")
    if train_cfg.get('l2', 0) > 0:
        flat = torch.cat([w.reshape(-1) for w in kernels(module)])
        loss = loss + train_cfg['l2'] * flat.square().sum()
    return loss


def _unit_norm(x):
    if x.ndim <= 1:
        return x.square().sum().sqrt()
    return x.square().sum(dim=tuple(range(1, x.ndim)), keepdim=True).sqrt()


def agc(params, grads, clip: float = 0.01, eps: float = 1e-3):
    out = []
    for p, g in zip(params, grads):
        max_norm = torch.clamp(_unit_norm(p), min=eps) * clip
        g_norm = _unit_norm(g)
        out.append(torch.where(g_norm < max_norm, g,
                               g * (max_norm / torch.clamp(g_norm,
                                                           min=1e-6))))
    return out


class Optimizer:
    """Keras Adam or AdaBelief after a clip at ``clipvalue``, on a list of
    parameters updated in place."""

    def __init__(self, params, train_cfg: dict, b1=0.9, b2=0.999, eps=1e-7):
        self.params = params
        self.kind = train_cfg['optimizer']
        if self.kind not in ('adam', 'adabelief'):
            raise ValueError(f'unknown optimizer {self.kind!r}')
        self.lr, self.clip = train_cfg['lr'], train_cfg['clipvalue']
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        """Returns the clipped gradients, as the rule receives them."""
        self.t += 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        corr = float(np.float32(np.sqrt(1.0 - float(b2) ** self.t)
                                / (1.0 - float(b1) ** self.t)))
        clipped = [g.clamp(-self.clip, self.clip) for g in grads]
        for p, g, m, v in zip(self.params, clipped, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            if self.kind == 'adam':
                v.mul_(self.b2).add_((1 - self.b2) * g.square())
            else:
                v.mul_(self.b2).add_((1 - self.b2) * (g - m).square())
            p.add_(corr * m / (v.sqrt() + self.eps) * -self.lr)
        return clipped


def train_step(module, opt: Optimizer, train_cfg: dict, x, y, gen=None):
    """One step; returns (loss, the clipped gradients)."""
    module.train()
    out = module(x, gen)
    loss = loss_of(train_cfg, module, y, out)
    grads = torch.autograd.grad(loss, opt.params)
    if train_cfg.get('agc'):
        grads = agc(opt.params, grads)
    return loss.detach(), opt.step(grads)


@torch.no_grad()
def val_loss(module, train_cfg: dict, x, y):
    module.eval()
    return loss_of(train_cfg, module, y, module(x))
