"""Bank building and the training feature chain (counterpart:
``challenge_tpu/data/pipeline.py``: ``build_banks``, ``make_feature_fn`` in
its ``variant='sj'`` fused-magnitude branch, ``DevicePipeline``).

One batch: draws -> synthesized magnitude (CUDA kernel) and frame labels ->
SpecAugment -> [stft filter] -> mel -> [minmax] -> log -> label downsample.
The mel is a plain matmul on the ``[B, T, 2, freq]`` magnitudes; the JAX
package's block-diagonal flat GEMM is a TPU layout device. The se v9
family takes another branch: draws -> complex spectrogram and targets
(three flat-complex kernel calls) -> DC row dropped, real half kept ->
label downsample, with no SpecAugment, mel or log.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.labels import (
    label_downsample, speech_enhancement_preprocess, to_frame_labels)
from challenge_tpu_torch.data.mixture import (
    Banks, draw, synthesize, synthesize_se)
from challenge_tpu_torch.data.specset import build_bank, remap_labels
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.ops.augment import batch_mask_keep
from challenge_tpu_torch.ops.mel import mel_filterbank
from challenge_tpu_torch.ops.norms import EPSILON, minmax

# model versions trained against 32x-downsampled labels (reference: utils.py:7)
LABEL_DOWNSAMPLE_MODELS = (3, 6, 7, 8, 9)


def build_banks(backgrounds, voices, labels, noises=None,
                n_classes: int = 3, one_hot: bool = True,
                n_frame: Optional[int] = None, flat_dtype='float32',
                device=None) -> Banks:
    """Host lists of [freq, T_i, chan] arrays -> banks on ``device``
    (default ``cuda``). ``labels`` may be int class ids (remapped and
    one-hotted, reference: sj_train.py:86-88) or already one-hot. Pass
    ``n_frame`` (the training window) so backgrounds shorter than the window
    are tiled as the reference tiles them (pipeline.py:29-35).
    ``flat_dtype`` ('float32', 'bfloat16' or 'int8', the ``bank_dtype``
    flag) is the dtype of every bank's flat layout (see
    ``specset.build_bank``)."""
    device = resolve_device(device)
    labels = np.asarray(labels)
    if one_hot and labels.ndim == 1:
        labels = remap_labels(labels, n_classes)
    return Banks(
        backgrounds=build_bank(backgrounds, wrap_frames=n_frame,
                               flat_dtype=flat_dtype, device=device),
        voices=build_bank(voices, flat_dtype=flat_dtype, device=device),
        voice_labels=torch.as_tensor(np.asarray(labels, np.float32),
                                     device=device),
        noises=(build_bank(noises, flat_dtype=flat_dtype, device=device)
                if noises is not None else None))


class FeatureFn:
    """``(gen, banks) -> (x [B, n_mels, n_frame, 2], y)`` for the
    ``sj_train`` configuration with ``n_chan == 2`` (counterpart:
    ``make_feature_fn(config, training, variant='sj')`` on its fused
    magnitude branch, pipeline.py:254-337); for se v9 ``(x [B, 256,
    n_frame, 2], (frame labels [B, n_frame / 32, C], only_voice,
    only_noise [B, 256, n_frame, 1]))`` (pipeline.py:265-306), with ``x``
    and the targets in bfloat16 for bfloat16 and int8 banks.

    :meth:`features` is the part after synthesis, with the SpecAugment
    masks passed in, so tests can feed it JAX's magnitudes and masks;
    :meth:`mel` is its pre-log half."""

    def __init__(self, config: Config, training: bool = True, device=None):
        if config.n_chan != 2:
            raise NotImplementedError(
                f'n_chan={config.n_chan} is not ported yet (ROADMAP A10)')
        self.config = config
        self.se_v9 = config.model_type == 'se' and config.v == 9
        self.training = training
        self.device = resolve_device(device)
        self.freq = 257
        self.melm = torch.tensor(mel_filterbank(config.n_mels, self.freq),
                                 device=self.device)
        self.use_filter = 'filter' in config.name
        self.use_minmax = 'nominmax' not in config.name
        filter_num = int(round(200 / (16000 / 256)))   # sj_train.py:117
        idx = np.arange(self.freq)
        keep = ((idx < 1) | (idx >= filter_num + 1)).astype(np.float32)
        self.filter_cols = torch.from_numpy(np.tile(keep, 2)).to(self.device)

    def mel(self, mag, tmask=None, fmask=None):
        """mag: [B, T, 2*freq] flat magnitude (column c*freq + f), float32
        or, from reduced-precision banks, bfloat16; tmask [B, T] / fmask
        [B, freq]: {0,1} keep masks, or None for no SpecAugment. Returns
        the pre-log mel [B, n_mels, T, 2] in float32. A bfloat16 magnitude
        is cast to float32 first, which is exact, as JAX promotes
        bf16 * f32 to f32."""
        mag = mag.float()
        b, t, width = mag.shape
        if width != 2 * self.freq:
            raise ValueError(f'magnitude width {width}, expected '
                             f'{2 * self.freq}')
        if tmask is not None:
            mag = mag * tmask[:, :, None]
        if fmask is not None:
            mag = mag * fmask.repeat(1, 2)[:, None, :]
        if self.use_filter:
            mag = mag * self.filter_cols
        mel = torch.matmul(mag.reshape(b, t, 2, self.freq), self.melm)
        mel = mel.permute(0, 3, 1, 2)                   # [B, n_mels, T, 2]
        return minmax(mel) if self.use_minmax else mel

    def features(self, mag, y, tmask=None, fmask=None):
        """(log-mel [B, n_mels, T, 2], labels) from the flat magnitude and
        the per-voice labels y [B, V, T, C]; masks as in :meth:`mel`."""
        cfg = self.config
        mel = torch.log(self.mel(mag, tmask, fmask) + EPSILON)
        y = to_frame_labels(y)
        if cfg.v in LABEL_DOWNSAMPLE_MODELS:
            y = label_downsample(y, 32)
        elif cfg.v == 5:
            y = label_downsample(y, cfg.n_frame // (cfg.n_frame * 256 // 16000))
        if cfg.loss.upper() in ('MSE', 'MAE'):
            y = y * cfg.mse_multiplier
        return mel, y

    def __call__(self, gen: torch.Generator, banks: Banks):
        cfg = self.config
        d = draw(gen, banks, cfg.batch_size, cfg.n_frame,
                 max_voices=cfg.max_voices, max_noises=cfg.max_noises,
                 min_ratio=1.0, snr=cfg.snr)
        if self.se_v9:
            x, y = speech_enhancement_preprocess(*synthesize_se(banks, d))
            return x, label_downsample(y, 32)
        mag, y = synthesize(banks, d)
        tmask = fmask = None
        if self.training:
            # 6 time masks <= 24 frames, 1 freq mask <= 16 of the 257 rows
            tmask = batch_mask_keep(gen, cfg.batch_size, cfg.n_frame,
                                    max_mask_size=24, n_mask=6)
            fmask = batch_mask_keep(gen, cfg.batch_size, self.freq,
                                    max_mask_size=16, n_mask=1)
        return self.features(mag, y, tmask, fmask)


class DevicePipeline:
    """Infinite iterator of on-device (x, y) batches from ``banks``, which
    must live on ``device`` (default ``cuda``)."""

    def __init__(self, banks: Banks, config: Config, training: bool = True,
                 seed: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        if banks.backgrounds.flat.device != self.device:
            raise ValueError(f'banks are on {banks.backgrounds.flat.device}, '
                             f'the pipeline on {self.device}')
        self.banks = banks
        self.fn = FeatureFn(config, training, self.device)
        base = config.seed if seed is None else seed
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(base + (0 if training else 1))

    def __iter__(self):
        while True:
            yield self.fn(self.gen, self.banks)

    def take(self, n: int):
        it = iter(self)
        return [next(it) for _ in range(n)]
