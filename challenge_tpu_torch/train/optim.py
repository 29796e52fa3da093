"""Gradient clipping, the Keras Adam, AdaBelief, SGD and RMSprop rules and
the LR schedule (counterpart: ``challenge_tpu/train/optim.py``; reference:
sj_train.py:133-155, 434-442, utils.py:140-288, 350-366).

Every optimizer keeps each parameter group's learning rate
``group['lr']`` as a 0-dim tensor on its parameters' device, in their
dtype, so a captured step reads it anew at each replay; change it with
:func:`set_learning_rate`, which fills it in place. Each clips the
gradient's values at ``clipvalue`` first, as Keras' ``clipvalue=``
does."""

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


# ------------------------------------------------ Keras Adam, AdaBelief
def bias_correction(step: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """sqrt(1 - b2^t) / (1 - b1^t) as a float32 tensor on ``step``'s device,
    for the step count ``step`` (an int64 tensor), with no host read, so a
    CUDA graph can replay it. The JAX rules compute it in float32 from
    ``count.astype(float32)``. Here each power of the float32 beta is taken
    in float64 and rounded once to float32; the subtractions are exact in
    float32; the root and the division are taken in float64 on float32
    values and rounded once, which gives the correctly rounded float32 root
    and quotient (float64 holds more than twice float32's digits). So the
    CPU and the card agree, where torch's float32 ``sqrt`` on the CPU can
    be an ulp off the IEEE root."""
    t = step.to(torch.float64)
    f32 = torch.float32
    p1 = torch.pow(float(np.float32(b1)), t).to(f32)
    p2 = torch.pow(float(np.float32(b2)), t).to(f32)
    root = torch.sqrt((1 - p2).double()).to(f32)
    return (root.double() / (1 - p1).double()).to(f32)


class KerasAdam(torch.optim.Optimizer):
    """``Adam(lr, clipvalue=...)`` with Keras semantics (reference:
    sj_train.py:434-435): gradients are clipped elementwise at
    ``clipvalue`` first; the bias correction is folded into the step size
    and eps is added to the UNcorrected sqrt(v):

        m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2
        p = p - lr * (sqrt(1-b2^t)/(1-b1^t)) * m / (sqrt(v) + eps)

    ``torch.optim.Adam`` adds eps to the corrected sqrt(v_hat) instead, an
    effective eps ~31x larger at step 1. Each parameter group keeps its
    learning rate ``group['lr']`` and its step count t ``group['step']``
    (every step updates every parameter, as optax counts) as 0-dim
    tensors on its parameters' device, the rate in their dtype (JAX keeps
    it in its default float: float32, or float64 under x64), so a
    captured step reads them anew at each replay; change the rate with
    ``group['lr'].fill_(...)``. ``m`` and ``v`` live in ``self.state[p]``.
    :class:`AdaBelief` changes only the second moment, in
    :meth:`second_moment`."""

    def __init__(self, params, lr: float = 1e-3, clipvalue=None,
                 beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-7):
        super().__init__(params, dict(lr=lr, clipvalue=clipvalue,
                                      beta_1=beta_1, beta_2=beta_2,
                                      epsilon=epsilon))
        _device_lr(self)
        for group in self.param_groups:
            p = group['params'][0]
            group['step'] = torch.zeros((), dtype=torch.int64,
                                        device=p.device)

    def slot_names(self):
        """The tensors the step keeps per parameter in ``self.state[p]``,
        each made as zeros like the parameter."""
        return ('m', 'v')

    def second_moment(self, state, g, b2: float):
        """Update ``state['v']`` for the clipped gradient ``g`` (``m`` is
        already this step's); returns the tensor under the root."""
        v = state['v']
        v.mul_(b2).add_((1 - b2) * g.square())
        return v

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['beta_1'], group['beta_2']
            lr = group['lr']
            group['step'].add_(1)
            corr = bias_correction(group['step'], b1, b2)
            for p, g in _clipped_grads(group):
                state = self.state[p]
                if not state:
                    state['m'] = torch.zeros_like(p)
                    state['v'] = torch.zeros_like(p)
                m = state['m']
                m.mul_(b1).add_((1 - b1) * g)
                v = self.second_moment(state, g, b2)
                p.add_(corr * m / (v.sqrt() + group['epsilon']) * -lr)
        return None


class AdaBelief(KerasAdam):
    """AdaBelief (counterpart: ``scale_by_adabelief``, optim.py:57-90;
    reference: utils.py:140-288) in the same stack: clipvalue first, then
    Keras Adam's rule with the second moment tracking the belief
    (g - m)^2, ``m`` being this step's first moment:

        v = b2*v + (1-b2)*(g - m)^2

    eps stays outside the root. With ``amsgrad`` the root is taken of
    ``vhat = max(vhat, v)``, kept in ``self.state[p]['vhat']``."""

    def __init__(self, params, lr: float = 1e-3, clipvalue=None,
                 beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-7, amsgrad: bool = False):
        super().__init__(params, lr, clipvalue, beta_1, beta_2, epsilon)
        self.amsgrad = amsgrad

    def slot_names(self):
        return ('m', 'v', 'vhat') if self.amsgrad else ('m', 'v')

    def second_moment(self, state, g, b2: float):
        v = state['v']
        v.mul_(b2).add_((1 - b2) * (g - state['m']).square())
        if not self.amsgrad:
            return v
        if 'vhat' not in state:
            state['vhat'] = torch.zeros_like(v)
        torch.maximum(state['vhat'], v, out=state['vhat'])
        return state['vhat']


class KerasSGD(torch.optim.Optimizer):
    """Keras ``SGD(lr, momentum=0.9, clipvalue=...)`` (counterpart:
    ``keras_sgd_momentum``, optim.py:146-161; reference: sj_train.py:
    436-437). The rate rides inside the momentum buffer, so a rate change
    decays in over some 1 / (1 - momentum) steps:

        accum = momentum*accum - lr*g;  p = p + accum

    ``accum`` lives in ``self.state[p]``."""

    def __init__(self, params, lr: float = 1e-3, clipvalue=None,
                 momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, clipvalue=clipvalue,
                                      momentum=momentum))
        _device_lr(self)

    def slot_names(self):
        return ('accum',)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p, g in _clipped_grads(group):
                state = self.state[p]
                if not state:
                    state['accum'] = torch.zeros_like(p)
                accum = state['accum']
                accum.mul_(group['momentum']).sub_(group['lr'] * g)
                p.add_(accum)
        return None


class KerasRMSprop(torch.optim.Optimizer):
    """Keras ``RMSprop(lr, rho=0.9, momentum=0.9, clipvalue=...)``
    (counterpart: ``keras_rmsprop``, optim.py:169-189; reference:
    sj_train.py:438-439), with eps inside the root, where Keras' momentum
    kernel puts it, and the rate inside the momentum buffer:

        ms = rho*ms + (1-rho)*g^2;  mom = momentum*mom + lr*g/sqrt(ms + eps)
        p = p - mom

    ``ms`` and ``mom`` live in ``self.state[p]``."""

    def __init__(self, params, lr: float = 1e-3, clipvalue=None,
                 rho: float = 0.9, momentum: float = 0.9,
                 epsilon: float = 1e-7):
        super().__init__(params, dict(lr=lr, clipvalue=clipvalue, rho=rho,
                                      momentum=momentum, epsilon=epsilon))
        _device_lr(self)

    def slot_names(self):
        return ('ms', 'mom')

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            rho = group['rho']
            for p, g in _clipped_grads(group):
                state = self.state[p]
                if not state:
                    state['ms'] = torch.zeros_like(p)
                    state['mom'] = torch.zeros_like(p)
                ms, mom = state['ms'], state['mom']
                ms.mul_(rho).add_((1 - rho) * g.square())
                mom.mul_(group['momentum']).add_(
                    group['lr'] * g / (ms + group['epsilon']).sqrt())
                p.sub_(mom)
        return None


def _device_lr(optimizer: torch.optim.Optimizer) -> None:
    """Each group's rate as a 0-dim tensor on its parameters' device, in
    their dtype (JAX keeps it in its default float: float32, or float64
    under x64)."""
    for group in optimizer.param_groups:
        p = group['params'][0]
        group['lr'] = torch.tensor(float(group['lr']), dtype=p.dtype,
                                   device=p.device)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr):
    """Fill every parameter group's device ``lr`` with ``lr`` in place,
    so a captured step reads it at its next replay (counterpart:
    ``set_learning_rate``, optim.py:228, which overwrites the injected
    hyperparameter). Returns ``optimizer``."""
    for group in optimizer.param_groups:
        group['lr'].fill_(lr)
    return optimizer


def _clipped_grads(group):
    """(parameter, gradient clipped at the group's clipvalue) for each
    parameter of ``group`` that has a gradient."""
    clip = group['clipvalue']
    for p in group['params']:
        if p.grad is not None:
            yield p, (p.grad if clip is None else p.grad.clamp(-clip, clip))


OPTIMIZERS = {'adam': KerasAdam, 'adabelief': AdaBelief, 'sgd': KerasSGD,
              'rmsprop': KerasRMSprop}


def make_optimizer(config, params) -> torch.optim.Optimizer:
    """The reference's optimizer stack for ``config.optimizer`` (sj_train.py:
    434-442, trainer.py:239-246); an unknown name raises ``ValueError``,
    as in JAX."""
    if config.optimizer not in OPTIMIZERS:
        raise ValueError(f'unknown optimizer: {config.optimizer!r}')
    return OPTIMIZERS[config.optimizer](params, lr=config.lr,
                                         clipvalue=config.clipvalue)


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
