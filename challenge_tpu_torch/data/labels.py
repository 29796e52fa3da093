"""Per-example label maps (counterpart: ``challenge_tpu/data/labels.py``;
reference: data_utils.py:64-97)."""

from __future__ import annotations

from challenge_tpu_torch.models.layers import avg_pool_same


def to_frame_labels(y):
    """[..., n_voices, n_frames, n_classes] -> [..., n_frames, n_classes]
    (reference: data_utils.py:64-70)."""
    return y.sum(dim=-3)


def label_downsample(y, resolution: int = 32):
    """Avg-pool x``resolution`` over time, then threshold 0.5 (reference:
    data_utils.py:85-97, without its stray batch-axis slice, as in JAX).
    y: [B, T, C] -> [B, ceil(T / resolution), C]."""
    y = avg_pool_same(y, resolution, resolution)
    return (y >= 0.5).to(y.dtype)
