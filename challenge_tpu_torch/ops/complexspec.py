"""Complex spectrogram <-> magnitude and phase, and the phase vocoder
(counterpart: ``challenge_tpu/ops/complexspec.py``; reference:
transforms.py:80-195).

The channel layout is the reference's: ``[..., :chan]`` holds the real
part (or the magnitude), ``[..., chan:]`` the imaginary part (or the
phase). Functions that take ``labels`` hand them back beside the result,
as the reference's ``tf.data`` maps do.
"""

from __future__ import annotations

import math

import torch

from challenge_tpu_torch.ops.norms import EPSILON


def complex_to_magphase(complex_tensor, y=None):
    """[..., 2 chan] real | imag -> magnitude | phase
    (transforms.py:111-123)."""
    n_chan = complex_tensor.shape[-1] // 2
    real = complex_tensor[..., :n_chan]
    imag = complex_tensor[..., n_chan:]
    magphase = torch.cat([torch.sqrt(real * real + imag * imag),
                          torch.atan2(imag, real)], dim=-1)
    if y is None:
        return magphase
    return magphase, y


def magphase_to_complex(magphase):
    """Magnitude | phase -> real | imag (transforms.py:126-134)."""
    n_chan = magphase.shape[-1] // 2
    mag = magphase[..., :n_chan]
    phase = magphase[..., n_chan:]
    return torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)],
                     dim=-1)


def log_magphase(specs, labels=None, n_chan: int = 2):
    """log(magnitude + 1e-8), the phase kept (transforms.py:80-86)."""
    specs = torch.cat([torch.log(specs[..., :n_chan] + EPSILON),
                       specs[..., n_chan:]], dim=-1)
    if labels is not None:
        return specs, labels
    return specs


def minmax_norm_magphase(specs, labels=None):
    """Magnitude and phase each min-max scaled over every axis but the
    first (transforms.py:89-107)."""
    n_chan = specs.shape[-1] // 2
    mag = specs[..., :n_chan]
    phase = specs[..., n_chan:]
    axis = tuple(range(1, specs.ndim))

    def norm(x):
        lo = x.amin(dim=axis, keepdim=True)
        hi = x.amax(dim=axis, keepdim=True)
        return (x - lo) / (hi - lo + EPSILON)
    specs = torch.cat([norm(mag), norm(phase)], dim=-1)
    if labels is not None:
        return specs, labels
    return specs


def phase_vocoder(complex_spec, rate: float = 1.0):
    """Stretch a complex spectrogram [freq, time, 2 chan] in time by
    ``rate`` without changing its pitch (transforms.py:137-195, itself
    torchaudio's phase vocoder): ``ceil(time / rate)`` output frames, the
    magnitude interpolated linearly between the two neighbouring input
    frames, the phase the cumulative sum of the wrapped phase increments
    around bin k's advance of ``pi * k`` a frame (hop = n_fft / 2 =
    freq - 1). Computed in ``complex64``; ``rate == 1`` returns the
    input."""
    if rate == 1:
        return complex_spec
    freq, t, _ = complex_spec.shape
    half = complex_spec.shape[-1] // 2
    device = complex_spec.device
    z = torch.complex(complex_spec[..., :half].float(),
                      complex_spec[..., half:].float())
    advance = torch.linspace(0.0, math.pi * (freq - 1), freq,
                             device=device)[:, None, None]
    # frame i * rate in float32, as numpy's (and jnp's) float32 arange
    steps = torch.arange(math.ceil(t / rate), dtype=torch.float32,
                         device=device) * torch.tensor(
                             rate, dtype=torch.float32, device=device)
    z = torch.nn.functional.pad(z, (0, 0, 0, 2))
    idx = steps.to(torch.int64)
    lo, hi = z[:, idx], z[:, idx + 1]
    frac = torch.remainder(steps, 1.0)[None, :, None]
    mag = frac * hi.abs() + (1 - frac) * lo.abs()
    dphi = hi.angle() - lo.angle() - advance
    dphi = dphi - 2 * math.pi * torch.round(dphi / (2 * math.pi)) + advance
    phi = torch.cumsum(torch.cat([z[:, :1].angle(), dphi[:, :-1]], dim=1),
                       dim=1)
    out = mag * torch.exp(1j * phi.to(torch.complex64))
    return torch.cat([out.real, out.imag], dim=-1)
