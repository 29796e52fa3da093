"""Normalization primitives (counterpart: ``challenge_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch

EPSILON = 1e-8                       # reference: utils.py:6


def safe_div(x, y, eps: float = EPSILON):
    """x / max(y, eps) (reference: utils.py:114-116)."""
    return x / torch.clamp(y, min=eps)


def minmax(x):
    """Per-sample min-max over all non-batch axes (reference: data_utils.py:37-47)."""
    flat = x.reshape(x.shape[0], -1)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    x_max = flat.amax(dim=1).reshape(shape)
    x_min = flat.amin(dim=1).reshape(shape)
    return safe_div(x - x_min, x_max - x_min)
