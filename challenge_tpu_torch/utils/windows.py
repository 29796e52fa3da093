"""Context windows and their overlap-averaged reconstruction (counterpart:
``challenge_tpu/utils/windows.py``; reference: utils.py:13-71).

Given *relative* frame offsets (e.g. ``[-3, -1, 0, 1, 3]``),
:func:`seq_to_windows` cuts one window per anchor frame, zero-padding the
sequence so that anchors near its ends still get whole windows;
:func:`windows_to_seq` scatters the window columns back to their frames and
divides by each frame's hit count. Both take numpy arrays or tensors and
return tensors: ``Tensor.unfold`` takes the place of JAX's strided view,
``index_add_`` that of ``np.add.at``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPSILON = 1e-8


def _normalize_offsets(offsets):
    """Relative offsets -> (zero-based offsets, span = max offset + 1)."""
    rel = np.asarray(offsets, dtype=np.int64)
    rel = rel - rel.min()
    return torch.from_numpy(rel), int(rel.max()) + 1


def seq_to_windows(seq, window, skip: int = 1, padding: bool = True,
                   **pad_kwargs):
    """``seq`` [T, ...] -> [ceil(T / skip), len(window), ...]: the frames
    ``anchor + window`` of every anchor in range(0, T, skip). With
    ``padding`` the sequence is first extended by span // 2 frames in front
    and (span - 1) // 2 behind, of ``np.pad``'s ``constant_values`` (0
    unless ``pad_kwargs`` give it)."""
    seq = torch.as_tensor(seq)
    rel, span = _normalize_offsets(window)
    if padding:
        head, tail = span // 2, (span - 1) // 2
        value = pad_kwargs.pop('constant_values', 0)
        if pad_kwargs:
            raise TypeError(f'unexpected pad arguments: {sorted(pad_kwargs)}')
        flat = seq.reshape(seq.shape[0], -1).T        # pad along frames
        flat = F.pad(flat, (head, tail), value=value)
        seq = flat.T.reshape((-1,) + tuple(seq.shape[1:]))
        full = seq.unfold(0, span, 1)                 # [W, ..., span]
        full = torch.movedim(full, -1, 1)
        return full[::skip][:, rel]
    anchors = torch.arange(0, seq.shape[0], skip, dtype=torch.int64)
    return seq[anchors[:, None] + rel[None, :]]


def windows_to_seq(windows, window, skip: int = 1):
    """Inverse of :func:`seq_to_windows`: every window column added to its
    frame and divided by the frame's count of contributions (+ 1e-8).
    windows [n_windows, len(window), ...] -> [(n_windows - 1) * skip + 1,
    ...], summed in float64 at least."""
    windows = torch.as_tensor(windows)
    rel, span = _normalize_offsets(window)
    n_win = windows.shape[0]
    out_len = (n_win - 1) * skip + 1
    # the reference centres with (span - 1) // 2 (utils.py:60-68)
    anchors = torch.arange(n_win, dtype=torch.int64) * skip - (span - 1) // 2
    targets = (anchors[:, None] + rel[None, :]).reshape(-1)
    keep = (targets >= 0) & (targets < out_len)
    feat_shape = tuple(windows.shape[2:])
    flat = windows.reshape((n_win * len(rel),) + feat_shape)
    dtype = torch.promote_types(windows.dtype, torch.float64)
    total = torch.zeros((out_len,) + feat_shape, dtype=dtype)
    total.index_add_(0, targets[keep], flat[keep].to(dtype))
    hits = torch.zeros(out_len, dtype=torch.float64)
    hits.index_add_(0, targets[keep],
                    torch.ones(int(keep.sum()), dtype=torch.float64))
    return total / (hits.reshape((out_len,) + (1,) * len(feat_shape))
                    + EPSILON)
