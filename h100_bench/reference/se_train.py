"""The se v9 pretrain step, plain: the training-mode forward (the frozen
head's BatchNorms in inference mode, ``se.SECascade.train``), the composite
loss, the gradients of the trained leaves, AGC, the elementwise clip at
``clipvalue`` and Keras Adam (``train.agc`` and ``train.Optimizer``); and
the validation loss.

The loss (``sj_train.py:451-461``): Keras BCE of the class output, plus 10
times the MAE of the speech output against the clean-speech target and 10
times the MAE of the noise output against the noise target (each target
[B, 256, T, 1] broadcast against the output's two channels, as in the
source). Departures from the source, noted: the source freezes the head
with ``trainable = False``, so Keras hands the optimizer the U-Net's
leaves only; here the optimizer and AGC are handed the trained leaves
(``se.*`` in pretrain, ``vad.*`` in finetune) and the frozen half gets no
gradient and no update at all, where the program computes the frozen
half's gradients and multiplies them by 0 before the update. AGC's unit is
an output unit: for a transposed convolution's weight [in, out, kh, kw]
that is dim 1 (the source's kernel [kh, kw, in, out] reduced over its
first three dims), so ``train.agc``, which keeps dim 0, is given that
weight and its gradient with dims 0 and 1 swapped.
"""

from __future__ import annotations

import torch
from torch import nn

from h100_bench.reference import train as ref_train

LOSS_WEIGHTS = (1.0, 10.0, 10.0)       # class, speech, noise


def mae(y, p):
    d = y - p
    return torch.where(d >= 0, d, -d).mean()


def loss_parts(y, out):
    """(total, [class BCE, speech MAE, noise MAE]) of the outputs ``out``
    (class, speech, noise) against the targets ``y`` (labels, speech
    target, noise target)."""
    parts = [ref_train.bce(y[0], out[0]), mae(y[1], out[1]),
             mae(y[2], out[2])]
    return sum(w * v for w, v in zip(LOSS_WEIGHTS, parts)), parts


def leaves(module: nn.Module, prefix: str):
    """The leaves whose names start with ``prefix``, as (names, parameters,
    transposed-convolution weight flags)."""
    owners = dict(module.named_modules())
    names, params, transposed = [], [], []
    for name, p in module.named_parameters():
        if name.startswith(prefix):
            owner, _, leaf = name.rpartition('.')
            names.append(name)
            params.append(p)
            transposed.append(leaf == 'weight' and isinstance(
                owners[owner], nn.ConvTranspose2d))
    return names, params, transposed


def trained(module: nn.Module):
    """The trained leaves (:func:`leaves`): the U-Net's in pretrain, the
    head's in finetune."""
    return leaves(module, 'se.' if module.pretrain else 'vad.')


def agc(params, grads, transposed):
    """``train.agc`` with each transposed weight's output unit in dim 0."""
    def swap(t, tr):
        return t.transpose(0, 1) if tr else t
    clipped = ref_train.agc([swap(p, tr) for p, tr in zip(params,
                                                          transposed)],
                            [swap(g, tr) for g, tr in zip(grads,
                                                          transposed)])
    return [swap(g, tr) for g, tr in zip(clipped, transposed)]


def train_step(module, opt: ref_train.Optimizer, transposed, x, y):
    """One step on the optimizer's leaves; returns (loss, the clipped
    gradients)."""
    module.train()
    loss, _ = loss_parts(y, module(x))
    grads = torch.autograd.grad(loss, opt.params)
    return loss.detach(), opt.step(agc(opt.params, grads, transposed))


@torch.no_grad()
def val_loss(module, x, y):
    module.eval()
    return loss_parts(y, module(x))[0]
