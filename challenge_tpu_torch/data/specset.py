"""Spec-set banks (counterpart: ``challenge_tpu/data/specset.py``).

Ragged host spectrograms ``[freq, T_i, chan]`` are padded once into a
fixed-shape bank on the device, so batches are synthesized there with no
per-step host work.

The bank keeps only what synthesis reads: the channel-major flat layout
(column ``c*freq + f``) in float32, bfloat16 or int8, the int8 layout's
per-item dequantization scales, the true lengths and the per-frame energy
masks. The JAX bank's 128-lane column pad and 8/16-row alignment serve the
TPU's DMA engine and are not kept: here ``f_r == freq``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from challenge_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class SpecBank:
    """flat:     [N, T_flat, chan*freq] float32, bfloat16 or int8,
              channel-major; zero past each item's length, except in a
              wrapped bank (see build_bank).
    lens:     [N] int32 true frame counts.
    pos_mask: [N, T_max] float32, 1.0 where the frame has positive energy
              (max over freq/chan > 0, the reference's frame-label
              criterion, pipeline.py:55-56).
    contig_exact_frames: the longest window that a contiguous read of
              ``flat`` rows can take at any offset the background draw
              produces and still equal the reference's tile-then-crop
              window: ``min(lens)``, or ``wrap_frames`` for a wrapped bank.
    chan:     the spectrograms' channel count; ``flat`` column c * freq + f
              holds channel c of frequency row f.
    flat_scale: [N] float32 dequantization scales of an int8 ``flat``
              (item i holds ``flat[i] * flat_scale[i]``), else None.
    """
    flat: torch.Tensor
    lens: torch.Tensor
    pos_mask: torch.Tensor
    contig_exact_frames: int
    chan: int
    flat_scale: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.flat.shape[0]


# Config.bank_dtype -> the flat layout's dtype
FLAT_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
               'int8': torch.int8}


def build_bank(specs: Sequence[np.ndarray], t_max: Optional[int] = None,
               wrap_frames: Optional[int] = None, flat_dtype='float32',
               device=None) -> SpecBank:
    """Pad a list of [freq, T_i, chan] arrays into a SpecBank on ``device``
    (default ``cuda``).

    wrap_frames: the training window length. When some item is shorter,
    the flat rows past each item's length are filled cyclically (row j
    holds frame j % len) and extended so that a contiguous ``wrap_frames``
    row read at any offset the tile-then-crop draw can produce stays in the
    bank. Only background banks set it: clip banks keep their zero tails.

    flat_dtype: 'float32', 'bfloat16' or 'int8' (validated as in
    specset.py:123-135). bfloat16 is the float32 layout rounded to nearest
    even. int8 is the
    JAX package's symmetric per-item max-abs quantization
    (specset.py:238-248), done on the host in numpy: ``scale = peak/127``,
    or 1.0 for an all-zero item, then ``clip(round(x/scale), -127, 127)``,
    with the scales in ``flat_scale``. ``pos_mask`` comes from the float32
    frames whatever the layout's dtype.
    """
    if flat_dtype not in FLAT_DTYPES:
        raise ValueError(f'bank_dtype must be float32, bfloat16 or int8, '
                         f'got {flat_dtype!r}')
    flat_dtype = FLAT_DTYPES[flat_dtype]
    device = resolve_device(device)
    specs = [np.asarray(s, np.float32) for s in specs]
    freq, _, chan = specs[0].shape
    lens = np.array([s.shape[1] for s in specs], np.int32)
    t_pad = int(lens.max()) if t_max is None else int(t_max)
    # an explicit t_max truncates longer items, and their lengths with them
    lens = np.minimum(lens, t_pad)
    contig = int(min(lens.min(), t_pad))
    wrap = wrap_frames is not None and contig < wrap_frames
    t_flat = t_pad
    if wrap:
        # the largest window offset the draw gives an item of length L is
        # ceil(n/L)*L - n; the read reaches n rows past it
        max_off = 0
        for t in lens:
            t = max(int(t), 1)
            max_off = max(max_off, -(-wrap_frames // t) * t - wrap_frames)
        t_flat = max(t_pad, max_off + wrap_frames)
        contig = int(wrap_frames)
    flat = np.zeros((len(specs), t_flat, chan, freq), np.float32)
    pos_mask = np.zeros((len(specs), t_pad), np.float32)
    for i, s in enumerate(specs):
        t = int(lens[i])
        flat[i, :t] = s[:, :t].transpose(1, 2, 0)         # [t, chan, freq]
        # reduced from the contiguous copy: the transposed view is slow
        pos_mask[i, :t] = flat[i, :t].max(axis=(1, 2)) > 0
        if wrap and t < t_flat:
            tt = max(t, 1)
            flat[i, t:] = flat[i, np.arange(t, t_flat) % tt]
    flat = flat.reshape(len(specs), t_flat, chan * freq)
    flat_scale = None
    if flat_dtype == torch.int8:
        peak = np.abs(flat).max(axis=(1, 2))
        scale = np.where(peak > 0, peak / 127.0, 1.0).astype(np.float32)
        flat = np.clip(np.round(flat / scale[:, None, None]),
                       -127, 127).astype(np.int8)
        flat_scale = torch.from_numpy(scale).to(device)
    return SpecBank(flat=torch.from_numpy(flat).to(flat_dtype).to(device),
                    lens=torch.from_numpy(lens).to(device),
                    pos_mask=torch.from_numpy(pos_mask).to(device),
                    contig_exact_frames=contig, chan=chan,
                    flat_scale=flat_scale)


def remap_labels(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """30-class -> 3-class remap + one-hot (reference: sj_train.py:86-88)."""
    labels = np.asarray(labels)
    if labels.max() - 1 != n_classes:
        labels = labels // 10
    return np.eye(n_classes, dtype='float32')[labels]
