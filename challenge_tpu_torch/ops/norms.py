"""Normalization primitives (counterpart: ``challenge_tpu/ops/norms.py``;
reference: utils.py:114-116, data_utils.py:37-55, trainer.py:63-77)."""

from __future__ import annotations

import math

import torch

EPSILON = 1e-8                       # reference: utils.py:6
LOG_EPSILON = math.log(EPSILON)      # reference: transforms.py:8


def safe_div(x, y, eps: float = EPSILON):
    """x / max(y, eps) (reference: utils.py:114-116)."""
    return x / torch.clamp(y, min=eps)


def minmax(x, y=None):
    """Per-sample min-max over all non-batch axes (reference:
    data_utils.py:37-47); with labels ``y``, ``(x, y)``."""
    flat = x.reshape(x.shape[0], -1)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    x_max = flat.amax(dim=1).reshape(shape)
    x_min = flat.amin(dim=1).reshape(shape)
    x = safe_div(x - x_min, x_max - x_min)
    return x if y is None else (x, y)


def log_on_mel(mel, labels=None):
    """log(mel + eps) (counterpart: norms.py:31-36; reference:
    data_utils.py:50-55); with labels, ``(mel, labels)``."""
    mel = torch.log(mel + EPSILON)
    return mel if labels is None else (mel, labels)


def minmax_log_on_mel(mel, labels=None):
    """Per-sample min-max, then log(mel + eps) (counterpart:
    norms.py:39-48; reference: trainer.py:63-77)."""
    return log_on_mel(minmax(mel), labels)
