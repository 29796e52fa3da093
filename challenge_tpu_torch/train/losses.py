"""Training losses (counterpart: ``challenge_tpu/train/losses.py``;
reference: utils.py:291-347, sj_train.py:447-461). Only BCE is ported."""

from __future__ import annotations

import torch

KERAS_EPS = 1e-7   # Keras backend.epsilon(): probability clip for log losses


def binary_crossentropy(y_true, y_pred):
    """Keras BinaryCrossentropy(): elementwise BCE, mean over everything."""
    p = torch.clamp(y_pred, KERAS_EPS, 1.0 - KERAS_EPS)
    ce = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))
    return ce.mean()


def get_loss(config):
    """Loss selection (reference: sj_train.py:447-452): ``(y, p) -> (loss,
    parts)``."""
    name = config.loss.upper()
    if name != 'BCE':
        raise NotImplementedError(
            f'loss {config.loss!r} is not ported yet (ROADMAP A15)')
    return lambda t, p: (binary_crossentropy(t, p), {})
