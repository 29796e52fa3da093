"""Kernel regularization (counterpart: ``challenge_tpu/train/regularizers.py``;
reference: utils.py:100-108 ``apply_kernel_regularizer``, trainer.py:248-250).

Keras clones the model with a regularizer on each Dense and Conv layer; the
JAX package adds a penalty over the parameter tree's ``kernel`` leaves to
the loss. Here the penalty is taken over the same tensors of the module,
inside the autograd graph of the step: the weights of the layers whose
flax counterpart names its weight ``kernel`` (convolutions, transposed
convolutions, Dense layers including the recurrent cells' per-gate ones,
and the eff v5 time resample). BatchNorm's scale and every bias are left
out, as flax names them ``scale`` and ``bias``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from challenge_tpu_torch.models.effnet import TimeAxisResample

# the modules whose ``weight`` is a flax ``kernel`` (interop/jax_weights.py)
KERNEL_MODULES = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d,
                  nn.ConvTranspose2d, nn.Linear, TimeAxisResample)


def kernels(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """``module``'s kernels with their state_dict names, in module
    order."""
    return [(f'{name}.weight' if name else 'weight', m.weight)
            for name, m in module.named_modules()
            if isinstance(m, KERNEL_MODULES)]


def l1_l2(l1: float = 0.0, l2: float = 0.0):
    """``penalty(module)``: l1 * sum |w| + l2 * sum w^2 over the kernels of
    ``module`` (Keras' layer filter, reference: utils.py:102). The kernels
    are summed as one flat tensor: one reduction a term instead of one a
    tensor, in another order than JAX's leaf by leaf."""
    def penalty(module: nn.Module):
        flat = torch.cat([w.reshape(-1) for _, w in kernels(module)])
        total = flat.new_zeros(())
        if l1:
            total = total + l1 * flat.abs().sum()
        if l2:
            total = total + l2 * flat.square().sum()
        return total
    return penalty


def apply_kernel_regularizer(loss_fn, regularizer):
    """Wrap a ``(y_true, y_pred) -> (loss, parts)`` loss so that the train
    and eval steps add ``regularizer(module)``: the wrapped loss is called
    as ``loss_fn(y_true, y_pred, module)`` (it carries ``needs_params``, as
    JAX's does)."""
    def wrapped(y_true, y_pred, module):
        loss, parts = loss_fn(y_true, y_pred)
        return loss + regularizer(module), parts
    wrapped.needs_params = True
    return wrapped
