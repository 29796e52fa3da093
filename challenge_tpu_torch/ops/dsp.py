"""Waveform ingest for evaluation (counterpart: ``challenge_tpu/ops/dsp.py``;
reference: data_utils.py:9-34): read a WAV, resample to 16 kHz with Kaldi's
LinearResample (what the reference's
``torchaudio.compliance.kaldi.resample_waveform`` runs), normalize by 10x
the RMS, and take the complex STFT (n_fft 512, hop 256, periodic Hann,
centre reflect padding) in the reference layout ``[freq, time, chan*2]``,
real parts of every channel, then imaginary parts.

The resampling weights are built on the host with numpy, as in JAX, and
applied with torch as one strided product per output phase. The STFT is a
framed matmul against the windowed DFT basis, the same arithmetic as the
JAX package's two GEMMs (a TPU layout there, a plain matmul here).
"""

from __future__ import annotations

import functools
import math
import wave

import numpy as np
import torch
import torch.nn.functional as F

from challenge_tpu_torch.device import resolve_device

SR = 16000                  # the models' sample rate
N_FFT, HOP = 512, 256       # the STFT of training and eval
LOWPASS_WIDTH = 6           # Kaldi's (and torchaudio's) default filter width

# --------------------------------------------------------------------- wav io
def read_wav(path: str):
    """A PCM WAV file -> (float32 [chan, samples] in [-1, 1], rate)."""
    with wave.open(path, 'rb') as f:
        n_chan = f.getnchannels()
        rate = f.getframerate()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype='<i2').astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype='<i4').astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f'unsupported sample width: {width}')
    return data.reshape(-1, n_chan).T, rate


def read_wav_raw(path: str):
    """A 16-bit PCM WAV without conversion: (int16 [chan, samples], rate),
    or (None, rate) for other sample widths."""
    with wave.open(path, 'rb') as f:
        if f.getsampwidth() != 2:
            return None, f.getframerate()
        n_chan = f.getnchannels()
        rate = f.getframerate()
        raw = f.readframes(f.getnframes())
    data = np.frombuffer(raw, dtype='<i2').reshape(-1, n_chan)
    return np.ascontiguousarray(data.T), rate


# ---------------------------------------------------------------- resampling
@functools.lru_cache(maxsize=32)
def resample_matrix(orig_freq: int, new_freq: int):
    """Polyphase weights of Kaldi's LinearResample (numpy, cached; a copy
    of the JAX package's). Returns (first_indices [P], weights [P, W],
    input_unit, output_unit): output sample ``i`` with phase ``p = i % P``
    and unit ``u = i // P`` is
    ``sum_k weights[p, k] * x[first_indices[p] + u * input_unit + k]``."""
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError(f'sample rates must be positive: {orig_freq}, '
                         f'{new_freq}')
    min_freq = min(orig_freq, new_freq)
    lowpass_cutoff = 0.99 * 0.5 * min_freq
    window_width = LOWPASS_WIDTH / (2.0 * lowpass_cutoff)

    g = math.gcd(orig_freq, new_freq)
    input_unit = orig_freq // g
    output_unit = new_freq // g

    output_t = np.arange(output_unit, dtype=np.float64) / new_freq
    min_t = output_t - window_width
    max_t = output_t + window_width
    min_input_index = np.ceil(min_t * orig_freq)
    max_input_index = np.floor(max_t * orig_freq)
    num_indices = (max_input_index - min_input_index + 1).astype(np.int64)
    w = int(num_indices.max())

    j = np.arange(w, dtype=np.float64)[None, :]
    input_index = min_input_index[:, None] + j
    delta_t = input_index / orig_freq - output_t[:, None]

    weights = np.zeros_like(delta_t)
    inside = np.abs(delta_t) < window_width
    weights[inside] = 0.5 * (1 + np.cos(
        2 * np.pi * lowpass_cutoff / LOWPASS_WIDTH * delta_t[inside]))
    nz = delta_t != 0.0
    weights[nz] *= np.sin(2 * np.pi * lowpass_cutoff * delta_t[nz]) / (
        np.pi * delta_t[nz])
    weights[~nz] *= 2 * lowpass_cutoff
    weights /= orig_freq
    # zero out columns beyond each phase's own index count
    weights *= (j < num_indices[:, None])
    first, weights = min_input_index.astype(np.int64), weights.astype(np.float32)
    for a in (first, weights):
        a.setflags(write=False)         # shared through the cache
    return first, weights, input_unit, output_unit


def resample_waveform(wav: torch.Tensor, orig_freq: int,
                      new_freq: int) -> torch.Tensor:
    """Resample float32 [..., samples] (Kaldi LinearResample; reference:
    data_utils.py:20-21) to ``ceil(samples * new / orig)`` samples. Taps
    outside the input read zeros. Equal rates are not the identity: the
    0.99-Nyquist lowpass still applies (infer.py:311-313)."""
    first_idx, weights, in_unit, out_unit = resample_matrix(orig_freq,
                                                            new_freq)
    n_in = wav.shape[-1]
    n_out = int(np.ceil(n_in * new_freq / orig_freq))
    n_units = -(-n_out // out_unit)
    n_taps = weights.shape[1]
    lpad = max(0, -int(first_idx.min()))
    span = (n_units - 1) * in_unit + n_taps           # input read per phase
    rpad = max(0, int(first_idx.max()) + span - n_in)
    xp = F.pad(wav, (lpad, rpad))
    w = torch.tensor(weights, device=wav.device)
    phases = []
    for p, first in enumerate(first_idx):
        start = lpad + int(first)
        frames = xp[..., start:start + span].unfold(-1, n_taps, in_unit)
        phases.append(frames @ w[p])                  # [..., n_units]
    out = torch.stack(phases, dim=-1).reshape(*wav.shape[:-1], -1)
    return out[..., :n_out]


# ---------------------------------------------------------------------- stft
@functools.lru_cache(maxsize=1)
def _dft_matrices():
    """Real-DFT basis times the periodic Hann window: [N_FFT, N_FFT//2+1]
    cos and -sin, float32 (a copy of the JAX package's)."""
    n_bins = N_FFT // 2 + 1
    n = np.arange(N_FFT, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / N_FFT
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT)
    cos_m = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * window[:, None]).astype(np.float32)
    cos_m.setflags(write=False)
    sin_m.setflags(write=False)
    return cos_m, sin_m


def stft(wav: torch.Tensor):
    """Complex STFT of float32 [chan, samples]: (real, imag) each
    [chan, freq, n_frames], as ``torch.stft(N_FFT, HOP, window=hann,
    center=True, pad_mode='reflect')`` computes it."""
    cos_m, sin_m = (torch.tensor(m, device=wav.device)
                    for m in _dft_matrices())
    x = F.pad(wav[None], (N_FFT // 2, N_FFT // 2), mode='reflect')[0]
    frames = x.unfold(-1, N_FFT, HOP)                 # [chan, T, N_FFT]
    return (frames @ cos_m).transpose(-1, -2), \
        (frames @ sin_m).transpose(-1, -2)


def stft_magnitude(wav: torch.Tensor) -> torch.Tensor:
    """|STFT| of float32 [chan, samples]: [chan, freq, n_frames]
    (counterpart: ``stft_magnitude``, dsp.py:197)."""
    real, imag = stft(wav)
    return torch.sqrt(real * real + imag * imag)


# ----------------------------------------------------------------- load_wav
def rms_normalize(wav: torch.Tensor) -> torch.Tensor:
    """wav / (10 * rms(wav)) (reference: data_utils.py:32-34)."""
    return wav / (torch.sqrt(torch.mean(torch.square(wav))) * 10.0)


def wav_to_spec(wav: torch.Tensor, rate: int) -> torch.Tensor:
    """[chan, samples] (int16 PCM or float32) -> complex spectrogram
    ``[freq, time, chan*2]`` on ``wav``'s device: resample to ``SR``, RMS
    normalize, STFT."""
    if wav.dtype == torch.int16:
        wav = wav.float() / 32768.0
    wav = rms_normalize(resample_waveform(wav, rate, SR))
    real, imag = stft(wav)                            # [chan, freq, T] each
    spec = torch.stack([real, imag], dim=0)           # [2, chan, freq, T]
    spec = spec.permute(2, 3, 0, 1)                   # [freq, T, 2, chan]
    return spec.reshape(*spec.shape[:2], -1)


def load_wav_device(path: str, device=None) -> torch.Tensor:
    """WAV file -> complex spectrogram ``[freq, time, chan*2]`` on
    ``device`` (default ``cuda``) (counterpart: ``load_wav_device``,
    dsp.py:246). 16-bit PCM goes to the device as int16 and is converted
    there."""
    device = resolve_device(device)
    raw, rate = read_wav_raw(path)
    if raw is None:
        raw, rate = read_wav(path)
    return wav_to_spec(torch.from_numpy(raw).to(device), rate)


def load_wav(path: str, device=None) -> torch.Tensor:
    """:func:`load_wav_device`. JAX's ``load_wav`` returns the same
    spectrogram as a numpy array (dsp.py:259); the port's returns the
    device tensor."""
    return load_wav_device(path, device)
