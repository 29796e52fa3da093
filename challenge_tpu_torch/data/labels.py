"""Per-example label and channel maps (counterpart:
``challenge_tpu/data/labels.py``; reference: data_utils.py:64-97,
trainer.py:86-104)."""

from __future__ import annotations

import torch

from challenge_tpu_torch.models.layers import avg_pool_same
from challenge_tpu_torch.ops.norms import safe_div


def to_frame_labels(y):
    """[..., n_voices, n_frames, n_classes] -> [..., n_frames, n_classes]
    (reference: data_utils.py:64-70)."""
    return y.sum(dim=-3)


def to_density_labels(y):
    """[..., n_voices, n_frames, n_classes] -> [..., n_frames, n_classes]:
    each voice's label mass over (frames, classes) normalised to 1, a
    silent slot left at 0, then summed over the voices (counterpart:
    ``labels.py:18-22``; reference: trainer.py:97-104)."""
    y = safe_div(y, y.sum(dim=(-2, -1), keepdim=True))
    return y.sum(dim=-3)


def preprocess_labels(y, multiplier: float):
    """Density labels [B, T, C] -> [B, T / 32, C] times ``multiplier``:
    five 'SAME' average pools of 2 frames, stride 2, each times 2: on a
    length that 32 divides, the sum of each 32 frames (counterpart:
    ``labels.py:70-77``; reference: trainer.py:86-94)."""
    for _ in range(5):
        y = avg_pool_same(y, 2, 2) * 2
    return y * multiplier


def mono_chan(x):
    """Stereo -> mono on the complex planes ``[re0, re1, im0, im1]`` of the
    last axis, as the training map (counterpart: ``labels.py:25-32`` with
    labels; reference: data_utils.py:73-76). The reference quirk is kept:
    ``x[..., :1] + x[..., 1:]`` broadcasts to the 3 planes
    ``[re0 + re1, re0 + im0, re0 + im1]``; the mel then takes ``re0 + re1``
    as the real part and the other two as imaginary parts, so the
    magnitude has 2 channels, not 1. Called without labels, as evaluation
    calls it (metrics.py:42-43), the reference's map is the identity,
    which ``evaluate.infer.channel_map`` keeps."""
    return x[..., :1] + x[..., 1:]


def stereo_mono(x):
    """2 -> 3 channels, stereo and their sum, on the complex planes of the
    last axis: ``[re0, re1, re0 + re1, im0, im1, im0 + im1]`` (counterpart:
    ``labels.py:35-43``; reference: data_utils.py:79-82)."""
    return torch.cat([x[..., :2], x[..., :1] + x[..., 1:2],
                      x[..., 2:4], x[..., 2:3] + x[..., 3:4]], dim=-1)


def label_downsample(y, resolution: int = 32):
    """Avg-pool x``resolution`` over time, then threshold 0.5 (reference:
    data_utils.py:85-97, without its stray batch-axis slice, as in JAX).
    y: [B, T, C] -> [B, ceil(T / resolution), C]. Of a tuple of targets
    only the first, the frame labels, is pooled (labels.py:60-63)."""
    if isinstance(y, tuple):
        return (label_downsample(y[0], resolution),) + y[1:]
    y = avg_pool_same(y, resolution, resolution)
    return (y >= 0.5).to(y.dtype)


def multiply_label(multiply_factor):
    """``(x, y) -> (x, y * multiply_factor)``, the labels scaled for
    MSE-style training (counterpart: labels.py:80; reference:
    data_utils.py:120-123)."""
    def _multiply_label(x, y):
        return x, y * multiply_factor
    return _multiply_label


def speech_enhancement_preprocess(x, y=None):
    """Drop the DC row and keep the real half of a complex spectrogram
    [..., freq, T, chan] (counterpart: ``labels.py:87-99``; reference:
    data_utils.py:139-148). The targets ``(label, only_voice, only_noise)``
    become ``(frame labels, only_voice', only_noise')``, the last two with
    the reference quirk kept: they keep only channel 0, since ``half`` is
    half of the already halved channel count, so they broadcast against
    the model's two-channel outputs in the loss."""
    x = x[..., 1:, :, :x.shape[-1] // 2]
    if y is None:
        return x
    half = x.shape[-1] // 2
    return x, (to_frame_labels(y[0]), y[1][..., 1:, :, :half],
               y[2][..., 1:, :, :half])
