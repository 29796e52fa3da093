"""Bank building and the training feature chain (counterpart:
``challenge_tpu/data/pipeline.py``: ``build_banks``, ``make_feature_fn``
with ``variant='sj'``, ``DevicePipeline``).

One batch, by configuration:

* n_chan 2, not se (the main path): draws -> synthesized magnitude (CUDA
  kernel B1/B3) and frame labels -> SpecAugment -> [stft filter] -> mel ->
  [minmax] -> log -> label downsample. The mel is a plain matmul on the
  ``[B, T, 2, freq]`` magnitudes; the JAX package's block-diagonal flat
  GEMM is a TPU layout device.
* the same with ``fused_mel=True`` (opt-in, as in JAX): draws -> the masked
  mel and its per-sample min and max from one kernel (B4), which takes the
  SpecAugment masks and the stft filter columns -> [minmax from those] ->
  log -> label downsample.
* n_chan 1, 3 or more: draws -> complex window (kernel B2) and frame
  labels -> SpecAugment on the complex planes -> channel map (mono,
  stereo + mono, random merge) -> [stft filter] -> mel -> [minmax] -> log
  -> label downsample.
* se v9: draws -> complex spectrogram and targets (three B2 calls) -> DC
  row dropped, real half kept -> label downsample, with no SpecAugment,
  mel or log.

The ``density`` variant (ROADMAP A13) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.labels import (
    label_downsample, mono_chan, speech_enhancement_preprocess, stereo_mono,
    to_frame_labels)
from challenge_tpu_torch.data.mixture import (
    Banks, draw, synthesize, synthesize_complex, synthesize_mel,
    synthesize_se)
from challenge_tpu_torch.data.specset import build_bank, remap_labels
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.ops.augment import (
    batch_mask_keep, merge_factors, random_merge_aug, stft_filter_keep)
from challenge_tpu_torch.ops.mel import complex_to_mel, mel_filterbank
from challenge_tpu_torch.ops.norms import EPSILON, minmax, safe_div
from challenge_tpu_torch.ops.synth import mel_band

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
    """``(gen, banks) -> (x [B, n_mels, n_frame, c], y)``, the ``sj_train``
    batch (counterpart: ``make_feature_fn(config, training,
    variant='sj', fused_mel=...)``, pipeline.py:106-339). ``c`` is n_chan,
    except for n_chan 1, whose features keep 2 channels as JAX's do (the
    ``mono_chan`` quirk, see ``labels.mono_chan``). For se v9 ``(x [B, 256,
    n_frame, 2], (frame labels [B, n_frame / 32, C], only_voice,
    only_noise [B, 256, n_frame, 1]))`` (pipeline.py:265-306), with ``x``
    and the targets in bfloat16 for bfloat16 and int8 banks.

    ``fused_mel=True`` takes the mel from kernel B4 (pipeline.py:204-252);
    it needs n_chan 2 and not se, as JAX asserts (pipeline.py:187-189). Its
    masks come from the same generator calls as the unfused path's, so
    both see the same masks for the same generator state.

    :meth:`features`, :meth:`complex_features` and :meth:`fused_features`
    are the parts after synthesis, with the masks (and merge factors)
    passed in, so tests can feed them JAX's values; :meth:`mel` is the
    pre-log half of :meth:`features`, :meth:`complex_mel` the mel of
    :meth:`complex_features` before minmax."""

    def __init__(self, config: Config, training: bool = True, device=None,
                 fused_mel: bool = False):
        self.config = config
        self.se_v9 = config.model_type == 'se' and config.v == 9
        if fused_mel and (config.n_chan != 2 or self.se_v9):
            raise ValueError('fused_mel requires the n_chan == 2 '
                             'configuration that is not se')
        self.fused_mel = fused_mel
        self.training = training
        self.device = resolve_device(device)
        self.freq = 257
        self.melm = torch.tensor(mel_filterbank(config.n_mels, self.freq),
                                 device=self.device)
        self.band = mel_band(self.melm) if fused_mel else None
        self.use_filter = 'filter' in config.name
        self.use_minmax = 'nominmax' not in config.name
        filter_num = int(round(200 / (16000 / 256)))   # sj_train.py:117
        self.filter_keep = stft_filter_keep(self.freq, filter_num,
                                            self.device)
        self.filter_cols = self.filter_keep.repeat(2)

    def masks(self, gen: torch.Generator):
        """The SpecAugment keep masks of one training batch: 6 time masks
        <= 24 frames ([B, n_frame]), then 1 frequency mask <= 16 of the 257
        rows ([B, 257])."""
        cfg = self.config
        tmask = batch_mask_keep(gen, cfg.batch_size, cfg.n_frame,
                                max_mask_size=24, n_mask=6)
        fmask = batch_mask_keep(gen, cfg.batch_size, self.freq,
                                max_mask_size=16, n_mask=1)
        return tmask, fmask

    def labels(self, y):
        """Per-voice labels [B, V, T, C] -> the model's targets."""
        cfg = self.config
        y = to_frame_labels(y)
        if cfg.v in LABEL_DOWNSAMPLE_MODELS:
            y = label_downsample(y, 32)
        elif cfg.v == 5:
            y = label_downsample(y, cfg.n_frame // (cfg.n_frame * 256 // 16000))
        if cfg.loss.upper() in ('MSE', 'MAE'):
            y = y * cfg.mse_multiplier
        return y

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
        return torch.log(self.mel(mag, tmask, fmask) + EPSILON), \
            self.labels(y)

    def fused_features(self, mel, mm, y):
        """(log-mel, labels) from kernel B4's masked mel [B, n_mels, T, 2]
        and its per-sample (min, max) ``mm`` [B, 2]."""
        if self.use_minmax:
            mn, mx = mm[:, 0, None, None, None], mm[:, 1, None, None, None]
            mel = safe_div(mel - mn, mx - mn)
        return torch.log(mel + EPSILON), self.labels(y)

    def complex_mel(self, flat, tmask=None, fmask=None, factors=None):
        """The mel before minmax [B, n_mels, T, c] for n_chan != 2, from
        the complex window ``flat`` [B, T, 4*freq] (planes re0, re1, im0,
        im1; float32, or bfloat16 from reduced-precision banks); masks as
        in :meth:`mel`; ``factors`` [B, n_chan - 2] the merge factors for
        n_chan > 3. The steps keep JAX's dtypes: masks and sums in the
        window's dtype, the merge in float32, the mel product in float32."""
        n_chan = self.config.n_chan
        b, t, _ = flat.shape
        spec = flat.reshape(b, t, 4, self.freq).transpose(2, 3)  # [B,T,f,4]
        if tmask is not None:
            spec = spec * tmask.to(spec.dtype)[:, :, None, None]
        if fmask is not None:
            spec = spec * fmask.to(spec.dtype)[:, None, :, None]
        if n_chan == 1:
            spec = mono_chan(spec)
        elif n_chan == 3:
            spec = stereo_mono(spec)
        elif n_chan > 3:
            spec = random_merge_aug(spec, factors[:, None, None, :])
        if self.use_filter:
            spec = spec * self.filter_keep.to(spec.dtype)[:, None]
        return complex_to_mel(spec, self.melm)

    def complex_features(self, flat, y, tmask=None, fmask=None,
                         factors=None):
        """(log-mel, labels) for n_chan != 2: :meth:`complex_mel`, then
        [minmax] and the log; y the per-voice labels."""
        mel = self.complex_mel(flat, tmask, fmask, factors)
        if self.use_minmax:
            mel = minmax(mel)
        return torch.log(mel + EPSILON), self.labels(y)

    def __call__(self, gen: torch.Generator, banks: Banks):
        cfg = self.config
        d = draw(gen, banks, cfg.batch_size, cfg.n_frame,
                 max_voices=cfg.max_voices, max_noises=cfg.max_noises,
                 min_ratio=1.0, snr=cfg.snr)
        if self.se_v9:
            x, y = speech_enhancement_preprocess(*synthesize_se(banks, d))
            return x, label_downsample(y, 32)
        tmask, fmask = self.masks(gen) if self.training else (None, None)
        if cfg.n_chan != 2:
            flat, y = synthesize_complex(banks, d)
            factors = (merge_factors(gen, cfg.batch_size, cfg.n_chan)
                       if cfg.n_chan > 3 else None)
            return self.complex_features(flat, y, tmask, fmask, factors)
        if self.fused_mel:
            b = cfg.batch_size
            if tmask is None:
                tmask = torch.ones((b, cfg.n_frame), device=self.device)
                fmask = torch.ones((b, self.freq), device=self.device)
            fmask = fmask.repeat(1, 2)
            if self.use_filter:
                fmask = fmask * self.filter_cols
            (mel, mm), y = synthesize_mel(banks, d, self.melm, tmask, fmask,
                                          self.band)
            return self.fused_features(mel, mm, y)
        mag, y = synthesize(banks, d)
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
