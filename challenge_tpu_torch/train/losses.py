"""Training losses (counterpart: ``challenge_tpu/train/losses.py``;
reference: utils.py:291-347, sj_train.py:447-461). BCE, and the se v9
composite loss with its MAE targets, are ported."""

from __future__ import annotations

import torch

KERAS_EPS = 1e-7   # Keras backend.epsilon(): probability clip for log losses


def binary_crossentropy(y_true, y_pred):
    """Keras BinaryCrossentropy(): elementwise BCE, mean over everything."""
    p = torch.clamp(y_pred, KERAS_EPS, 1.0 - KERAS_EPS)
    ce = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))
    return ce.mean()


def mae(y_true, y_pred):
    """Keras MAE: mean |err| over the last axis, then over everything. The
    two broadcast as the JAX package's arrays do: the se targets
    [B, 256, T, 1] against the outputs [B, 256, T, 2]."""
    return (y_true - y_pred).abs().mean()


SE_LOSS_WEIGHTS = (1.0, 10.0, 10.0)    # class, speech, noise


def se_loss(y_true, y_pred):
    """The se v9 composite loss: [BCE(class), MAE(speech), MAE(noise)]
    weighted [1, 10, 10] (reference: sj_train.py:451-452, 461). Returns
    ``(total, parts)``, the parts under the per-head log names."""
    parts = {
        'class_loss': binary_crossentropy(y_true[0], y_pred[0]),
        'speech_loss': mae(y_true[1], y_pred[1]),
        'noise_loss': mae(y_true[2], y_pred[2]),
    }
    total = sum(w * v for w, v in zip(SE_LOSS_WEIGHTS, parts.values()))
    return total, parts


def get_loss(config):
    """Loss selection (reference: sj_train.py:447-452): ``(y, p) -> (loss,
    parts)``."""
    name = config.loss.upper()
    if name != 'BCE':
        raise NotImplementedError(
            f'loss {config.loss!r} is not ported yet (ROADMAP A15)')
    if config.model_type == 'se' and config.v == 9:
        return se_loss
    return lambda t, p: (binary_crossentropy(t, p), {})
