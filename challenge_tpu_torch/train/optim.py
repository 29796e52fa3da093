"""Gradient clipping, the Keras Adam rule and the LR schedule (counterpart:
``challenge_tpu/train/optim.py``; reference: sj_train.py:133-155, 434-442,
utils.py:350-366)."""

from __future__ import annotations

import numpy as np
import torch


# ------------------------------------------------------------------- AGC
def unitwise_norm(x, transposed: bool = False):
    """NFNet unitwise L2 norm (reference: utils.py:350-366) in PyTorch
    layouts: the full norm of a scalar or vector, per output row of a
    Linear weight [out, in] (flax: per column of [in, out]) and per output
    channel of an OIHW conv weight (flax: over HWI of HWIO). The JAX
    package reduces a flax ConvTranspose kernel [kh, kw, in, out] over
    (0, 1, 2) too, per output channel, which for ``transposed`` weights in
    torch's [in, out, kh, kw] layout is dims (0, 2, 3)."""
    if x.ndim <= 1:
        return x.square().sum().sqrt()
    if x.ndim == 2:
        return x.square().sum(dim=1, keepdim=True).sqrt()
    if x.ndim == 4:
        dims = (0, 2, 3) if transposed else (1, 2, 3)
        return x.square().sum(dim=dims, keepdim=True).sqrt()
    raise ValueError(f'unitwise_norm takes rank 0, 1, 2 or 4 parameters, '
                     f'got {tuple(x.shape)}')


def transposed_weights(module: torch.nn.Module):
    """One flag per tensor of ``module.parameters()``: True for the weight
    of a transposed convolution, whose layout is [in, out, kh, kw]."""
    owners = dict(module.named_modules())
    flags = []
    for name, _ in module.named_parameters():
        owner, _, leaf = name.rpartition('.')
        flags.append(leaf == 'weight' and isinstance(
            owners[owner], torch.nn.ConvTranspose2d))
    return flags


def adaptive_clip_grad(params, grads, clip_factor: float = 0.01,
                       eps: float = 1e-3, transposed=None):
    """Adaptive gradient clipping (reference: sj_train.py:145-155): scale
    each gradient unit down where its norm exceeds clip_factor x the
    parameter unit's norm. ``transposed`` flags the transposed-conv
    weights (:func:`transposed_weights`); default none. Returns new
    gradients."""
    out = []
    if transposed is None:
        transposed = [False] * len(params)
    for p, g, tr in zip(params, grads, transposed):
        p_norm = unitwise_norm(p, tr)
        g_norm = unitwise_norm(g, tr)
        max_norm = torch.clamp(p_norm, min=eps) * clip_factor
        clipped = g * (max_norm / torch.clamp(g_norm, min=1e-6))
        out.append(torch.where(g_norm < max_norm, g, clipped))
    return out


# ------------------------------------------------------------- Keras Adam
class KerasAdam(torch.optim.Optimizer):
    """``Adam(lr, clipvalue=...)`` with Keras semantics (reference:
    sj_train.py:434-435): gradients are clipped elementwise at
    ``clipvalue`` first; the bias correction is folded into the step size
    and eps is added to the UNcorrected sqrt(v):

        m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2
        p = p - lr * (sqrt(1-b2^t)/(1-b1^t)) * m / (sqrt(v) + eps)

    ``torch.optim.Adam`` adds eps to the corrected sqrt(v_hat) instead, an
    effective eps ~31x larger at step 1. The step count t is kept per
    parameter like torch's optimizers; ``m`` and ``v`` live in
    ``self.state[p]``."""

    def __init__(self, params, lr: float = 1e-3, clipvalue=None,
                 beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-7):
        super().__init__(params, dict(lr=lr, clipvalue=clipvalue,
                                      beta_1=beta_1, beta_2=beta_2,
                                      epsilon=epsilon))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['beta_1'], group['beta_2']
            clip, lr = group['clipvalue'], group['lr']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                if clip is not None:
                    g = g.clamp(-clip, clip)
                state = self.state[p]
                if not state:
                    state['step'] = 0
                    state['m'] = torch.zeros_like(p)
                    state['v'] = torch.zeros_like(p)
                state['step'] += 1
                # float32 like the JAX rule (count.astype(float32))
                t = np.float32(state['step'])
                corr = float(np.sqrt(np.float32(1) - np.float32(b2) ** t)
                             / (np.float32(1) - np.float32(b1) ** t))
                m, v = state['m'], state['v']
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g.square())
                p.add_(corr * m / (v.sqrt() + group['epsilon']) * -lr)
        return None


def make_optimizer(config, params) -> torch.optim.Optimizer:
    """The reference's optimizer stack for ``config.optimizer`` (sj_train.py:
    434-442); only adam is ported."""
    if config.optimizer != 'adam':
        raise NotImplementedError(
            f'optimizer {config.optimizer!r} is not ported yet (ROADMAP '
            + ('A13)' if config.optimizer == 'adabelief' else 'A15)'))
    return KerasAdam(params, lr=config.lr, clipvalue=config.clipvalue)


def custom_scheduler(d_model: float, warmup_steps: float = 4000,
                     lr_div: float = 2.0):
    """Transformer warmup schedule, called once per epoch
    (reference: sj_train.py:133-142)."""
    d_model = float(d_model)

    def _scheduler(step):
        step = float(step) + 1.0
        arg1 = step ** -0.5
        arg2 = step * (warmup_steps ** -1.5)
        return (d_model ** -0.5) * min(arg1, arg2) / lr_div
    return _scheduler
