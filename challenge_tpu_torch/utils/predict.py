"""Prediction with test-time augmentation (counterpart:
``challenge_tpu/utils/predict.py``; reference: utils.py:119-134)."""

from __future__ import annotations

import torch


def _gate(out):
    """The VAD gate: 30 degree scores times the sigmoid of the activity."""
    return out[..., :30] * torch.sigmoid(out[..., 30:])


def predict(apply_fn, xs, reverse_and_add: bool = False, vad: bool = False):
    """``apply_fn(xs)``, gated with ``vad``; with ``reverse_and_add`` the
    mean of it and the prediction of the channel-reversed input, whose
    degrees are flipped within each block of 10."""
    output = apply_fn(xs)
    if vad:
        output = _gate(output)
    if reverse_and_add:
        rev = apply_fn(torch.flip(xs, dims=(-1,)))
        if vad:
            rev = _gate(rev)
        shape = rev.shape[:-1]
        rev = torch.flip(rev.reshape(*shape, -1, 10), dims=(-1,))
        output = (output + rev.reshape(*shape, -1)) / 2
    return output
