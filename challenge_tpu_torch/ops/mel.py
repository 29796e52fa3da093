"""Mel filterbank (counterpart: ``challenge_tpu/ops/mel.py``).

A numpy copy of ``tf.signal.linear_to_mel_weight_matrix(n_mels, 257, 16000)``
with TF's default band edges (125 Hz, 3800 Hz), built once on the host. The
projection is a plain matmul: at the call site in training (or, on the
fused path, inside kernel B4), in :func:`complex_to_mel` for the channel
maps' complex spectrograms, and in :func:`magnitude_to_mel` for evaluation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _hertz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(num_mel_bins: int = 80, num_spectrogram_bins: int = 257,
                   sample_rate: int = 16000, lower_edge_hertz: float = 125.0,
                   upper_edge_hertz: float = 3800.0) -> np.ndarray:
    """float32 [num_spectrogram_bins, num_mel_bins]; the DC row is zero
    (TF's ``bands_to_zero = 1``). Intermediates are float32 like TF's."""
    bands_to_zero = 1
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins,
                               dtype=np.float32)[bands_to_zero:]
    spectrogram_bins_mel = _hertz_to_mel(linear_freqs).astype(np.float32)[:, None]

    edges = np.linspace(np.float32(_hertz_to_mel(lower_edge_hertz)),
                        np.float32(_hertz_to_mel(upper_edge_hertz)),
                        num_mel_bins + 2, dtype=np.float32)
    lower_edge_mel = edges[None, :num_mel_bins]
    center_mel = edges[None, 1:num_mel_bins + 1]
    upper_edge_mel = edges[None, 2:]

    lower_slopes = (spectrogram_bins_mel - lower_edge_mel) / (
        center_mel - lower_edge_mel)
    upper_slopes = (upper_edge_mel - spectrogram_bins_mel) / (
        upper_edge_mel - center_mel)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    weights = np.pad(weights, [[bands_to_zero, 0], [0, 0]])
    weights = weights.astype(np.float32)
    weights.setflags(write=False)      # shared through the cache
    return weights


# JAX's name of the numpy matrix (mel.py:27); its ``mel_filterbank`` is the
# device copy, which the port makes where it is used
linear_to_mel_weight_matrix = mel_filterbank


def magphase_to_mel(num_mel_bins: int = 80, num_spectrogram_bins: int = 257,
                    sample_rate: int = 16000, **kwargs):
    """``(x[, y]) -> mel[, y]``: a magphase [B, freq, T, chan*2] or
    [freq, T, chan*2], its phase half dropped, projected to [B, n_mels, T,
    chan] or [n_mels, T, chan] (counterpart: ``magphase_to_mel``,
    mel.py:66-89; reference: transforms.py:51-77)."""
    melm_np = mel_filterbank(num_mel_bins, num_spectrogram_bins, sample_rate,
                             **kwargs)

    def _magphase_to_mel(x, y=None):
        melm = torch.tensor(melm_np, device=x.device)
        x = x[..., :x.shape[-1] // 2]
        if x.ndim == 4:
            out = torch.einsum('bftc,fm->bmtc', x, melm)
        elif x.ndim == 3:
            out = magnitude_to_mel(x, melm)
        else:
            raise ValueError('x.ndim must be 3 or 4')
        return out if y is None else (out, y)
    return _magphase_to_mel


def magnitude_to_mel(mag: torch.Tensor, melm: torch.Tensor) -> torch.Tensor:
    """Unbatched magnitude [freq, T, chan] -> mel [n_mels, T, chan]
    (counterpart: ``magphase_to_mel`` on the magnitude half of a magphase,
    mel.py:80-103; reference: transforms.py:58-77)."""
    return torch.einsum('ftc,fm->mtc', mag, melm)


def complex_to_mel(spec: torch.Tensor, melm: torch.Tensor) -> torch.Tensor:
    """Complex spectrogram [B, T, freq, planes] (real planes first) ->
    mel [B, n_mels, T, chan] (counterpart: ``complex_to_mel`` of
    ``challenge_tpu/data/pipeline.py:90-103``, 'tfc' layout). The magnitude
    is taken in the spectrogram's dtype, and its real and imaginary halves
    broadcast against each other: n_chan 1's three planes give 2 channels
    (the ``mono_chan`` quirk). The product runs in ``melm``'s float32, as
    JAX promotes a bfloat16 magnitude."""
    n = spec.shape[-1] // 2
    real, imag = spec[..., :n], spec[..., n:]
    mag = torch.sqrt(real * real + imag * imag)
    return torch.einsum('btfc,fm->bmtc', mag.to(melm.dtype), melm)
