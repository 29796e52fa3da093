"""The training batch, worked out again from the sources and the seeds.

The bank layout (every spectrogram [freq, T, chan] padded into a
channel-major flat [N, T_flat, chan * freq] float32 array; backgrounds
shorter than the window wrapped so that a contiguous read at any drawn
offset equals the tile-then-crop window), the draws of one batch from a
``torch.Generator`` in the program's order of calls, the ordered float32
synthesis sum and its magnitude, the SpecAugment keep masks, the mel
features (mel matmul, per-sample minmax, log) and the labels (frame labels
pooled 32 times, or the density labels summed over each 32 frames). The
draws are the program's functions of the generator's state, so the same
seed gives the same batch here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from h100_bench.reference.layers import avg_pool_same

EPSILON = 1e-8
FREQ = 257


class Bank(NamedTuple):
    flat: torch.Tensor        # [N, T_flat, chan * freq] float32
    lens: torch.Tensor        # [N] int32
    pos_mask: torch.Tensor    # [N, T_max]: frame has positive energy

    @property
    def n(self) -> int:
        return self.flat.shape[0]


class Banks(NamedTuple):
    backgrounds: Bank
    voices: Bank
    voice_labels: torch.Tensor     # [Nv, C] one-hot
    noises: Optional[Bank]


def build_bank(specs, device, wrap_frames: Optional[int] = None) -> Bank:
    specs = [np.asarray(s, np.float32) for s in specs]
    freq, _, chan = specs[0].shape
    lens = np.array([s.shape[1] for s in specs], np.int32)
    t_pad = int(lens.max())
    t_flat = t_pad
    wrap = wrap_frames is not None and int(lens.min()) < wrap_frames
    if wrap:
        max_off = max(-(-wrap_frames // max(int(t), 1)) * max(int(t), 1)
                      - wrap_frames for t in lens)
        t_flat = max(t_pad, max_off + wrap_frames)
    flat = np.zeros((len(specs), t_flat, chan, freq), np.float32)
    pos = np.zeros((len(specs), t_pad), np.float32)
    for i, s in enumerate(specs):
        t = int(lens[i])
        flat[i, :t] = s.transpose(1, 2, 0)
        pos[i, :t] = flat[i, :t].max(axis=(1, 2)) > 0
        if wrap and t < t_flat:
            flat[i, t:] = flat[i, np.arange(t, t_flat) % max(t, 1)]
    return Bank(torch.from_numpy(flat.reshape(len(specs), t_flat, -1)).to(
        device), torch.from_numpy(lens).to(device),
        torch.from_numpy(pos).to(device))


def build_banks(backgrounds, voices, labels, noises, n_frame: int,
                n_classes: int, device) -> Banks:
    """30-class voice labels are mapped to ``n_classes`` by ``// 10`` and
    one-hotted, as the reference trainer does."""
    labels = np.asarray(labels)
    if labels.max() - 1 != n_classes:
        labels = labels // 10
    onehot = np.eye(n_classes, dtype=np.float32)[labels]
    return Banks(build_bank(backgrounds, device, wrap_frames=n_frame),
                 build_bank(voices, device),
                 torch.from_numpy(onehot).to(device),
                 build_bank(noises, device) if noises else None)


class Draws(NamedTuple):
    n_frame: int
    bidx: torch.Tensor
    boff: torch.Tensor
    vidx: torch.Tensor
    vshift: torch.Tensor
    vw: torch.Tensor
    vlens: torch.Tensor
    nidx: Optional[torch.Tensor] = None
    nshift: Optional[torch.Tensor] = None
    nw: Optional[torch.Tensor] = None
    nlens: Optional[torch.Tensor] = None


def _stream(gen, n_items: int, shape):
    count = int(np.prod(shape))
    perms = torch.cat([torch.randperm(n_items, generator=gen,
                                      device=gen.device)
                       for _ in range(-(-count // n_items))])
    return perms[:count].reshape(shape).to(torch.int32)


def _randint(gen, maxval):
    maxval = maxval.clamp(min=1)
    u = torch.rand(maxval.shape, generator=gen, device=maxval.device)
    return torch.floor(u * maxval.float()).to(torch.int32)


def _shift(gen, length, n_frame: int, min_ratio: float, crop: bool):
    pad = (n_frame - torch.floor(min_ratio * length.float()).to(
        torch.int32)).clamp(min=0)
    span = length + 2 * pad - n_frame
    return pad - _randint(gen, span + 1 if crop else span)


def _place(e, shifts, n_frame: int):
    t_len = e.shape[-1]
    j = torch.arange(n_frame, device=e.device) - shifts[..., None].long()
    valid = (j >= 0) & (j < t_len)
    return torch.gather(e, -1, j.clamp(0, t_len - 1)) * valid.to(e.dtype)


def _candidate_labels(banks: Banks, vidx, vshift, n_frame: int):
    vidx = vidx.long()
    mask = _place(banks.voices.pos_mask[vidx], vshift, n_frame)
    return mask[..., None] * banks.voice_labels[vidx][:, :, None, :]


def draw(gen, banks: Banks, b: int, n_frame: int, max_voices: int,
         max_noises: int, snr: float, min_ratio: float = 1.0,
         min_noise_ratio: float = 0.5) -> Draws:
    """Every random choice of one batch: background items and window
    starts, voice and noise items (shuffled repeating streams), their
    counts (upper bounds exclusive), mix ratios and row shifts, and the
    sequential rejection of voices whose labels would overlap."""
    bg, vo, no = banks.backgrounds, banks.voices, banks.noises
    dev = bg.flat.device
    bidx = _stream(gen, bg.n, (b,))
    vidx = _stream(gen, vo.n, (b, max_voices))
    bg_lens = bg.lens[bidx.long()].clamp(min=1)
    n_tile = (n_frame + bg_lens - 1) // bg_lens
    boff = _randint(gen, n_tile * bg_lens - n_frame + 1)
    n_voices = (torch.randint(1, max_voices, (b,), generator=gen, device=dev)
                if max_voices > 1 else torch.ones((b,), dtype=torch.int64,
                                                  device=dev))
    vlens = vo.lens[vidx.long()]
    v_eff = vlens.amax(dim=1, keepdim=True).expand(b, max_voices)
    ratios = torch.pow(10.0, -torch.rand((b, max_voices), generator=gen,
                                         device=dev) * (-snr / 10.0))
    vshift = _shift(gen, v_eff, n_frame, min_ratio, crop=False)
    active = torch.arange(max_voices, device=dev)[None, :] \
        < n_voices[:, None]
    cand = _candidate_labels(banks, vidx, vshift, n_frame)
    acc = torch.zeros_like(cand[:, 0])
    accepts = []
    for v in range(max_voices):
        ok = (active[:, v] & ((acc + cand[:, v]).amax(dim=(1, 2)) < 2.0)
              ).to(cand.dtype)
        acc = acc + cand[:, v] * ok[:, None, None]
        accepts.append(ok)
    vw = torch.stack(accepts, dim=1) * ratios
    if no is None or max_noises <= 0:
        return Draws(n_frame, bidx, boff, vidx, vshift, vw, vlens)
    nidx = _stream(gen, no.n, (b, max_noises))
    n_noises = torch.randint(0, max_noises, (b,), generator=gen, device=dev)
    nlens = no.lens[nidx.long()]
    n_eff = nlens.amax(dim=1, keepdim=True).expand(b, max_noises)
    nshift = _shift(gen, n_eff, n_frame, min_noise_ratio, crop=True)
    nratios = torch.pow(10.0, -2.0 * torch.rand((b, max_noises),
                                                generator=gen, device=dev))
    nw = (torch.arange(max_noises, device=dev)[None, :]
          < n_noises[:, None]).float() * nratios
    return Draws(n_frame, bidx, boff, vidx, vshift, vw, vlens, nidx, nshift,
                 nw, nlens)


def synthesize(banks: Banks, d: Draws):
    """(magnitude [B, n_frame, chan / 2 * freq], per-voice labels [B, V,
    n_frame, C]): the background window, then each active voice and noise
    clip in slot order, ``acc + w * clip`` in float32 on the rows its shift
    puts inside the window; the magnitude of the real and imaginary
    column halves."""
    t = torch.arange(d.n_frame, device=banks.backgrounds.flat.device)
    acc = banks.backgrounds.flat[d.bidx.long()[:, None],
                                 d.boff.long()[:, None] + t[None, :]]
    for bank, idx, shift, w, lens in (
            (banks.voices, d.vidx, d.vshift, d.vw, d.vlens),
            (banks.noises, d.nidx, d.nshift, d.nw, d.nlens)):
        if idx is None:
            continue
        rows = bank.flat.shape[1]
        for k in range(idx.shape[1]):
            j = t[None, :] - shift[:, k, None].long()
            valid = ((j >= 0) & (j < lens[:, k, None].clamp(max=rows))
                     & (w[:, k, None] != 0))
            clip = bank.flat[idx[:, k, None].long(), j.clamp(0, rows - 1)]
            acc = torch.where(valid[..., None],
                              acc + w[:, k, None, None] * clip, acc)
    half = acc.shape[-1] // 2
    re, im = acc[..., :half], acc[..., half:]
    labels = _candidate_labels(banks, d.vidx, d.vshift, d.n_frame) \
        * (d.vw != 0).float()[..., None, None]
    # the correctly rounded float32 root (a float64 root rounded once), as
    # the card's sqrtf gives it; torch's float32 root on the CPU can be an
    # ulp off
    return torch.sqrt((re * re + im * im).double()).float(), labels


def keep_mask(gen, b: int, total: int, max_size: int, n_mask: int):
    """[B, total] {0, 1}: ``n_mask`` spans of U{0..max_size-1} frames at
    floor(u * (total - size)) zeroed per sample."""
    dev = gen.device
    sizes = torch.randint(0, max_size, (b, n_mask), generator=gen,
                          device=dev, dtype=torch.int32)
    u = torch.rand((b, n_mask), generator=gen, device=dev)
    off = torch.floor(u * (total - sizes).float()).to(torch.int32)
    idx = torch.arange(total, device=dev)[None, None, :]
    keep = (idx < off[..., None]) | (idx >= (off + sizes)[..., None])
    return keep.float().amin(dim=1)


def mel_filterbank(n_mels: int = 80, n_bins: int = FREQ, sr: int = 16000,
                   lo: float = 125.0, hi: float = 3800.0) -> np.ndarray:
    """``tf.signal.linear_to_mel_weight_matrix`` in float32 [freq, n_mels],
    the DC row zero."""
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)
    freqs = np.linspace(0.0, sr / 2.0, n_bins, dtype=np.float32)[1:]
    bins = mel(freqs).astype(np.float32)[:, None]
    edges = np.linspace(np.float32(mel(lo)), np.float32(mel(hi)),
                        n_mels + 2, dtype=np.float32)
    lower = (bins - edges[None, :n_mels]) / (edges[None, 1:n_mels + 1]
                                             - edges[None, :n_mels])
    upper = (edges[None, 2:] - bins) / (edges[None, 2:]
                                        - edges[None, 1:n_mels + 1])
    w = np.maximum(0.0, np.minimum(lower, upper))
    return np.pad(w, [[1, 0], [0, 0]]).astype(np.float32)


def minmax(x):
    """Per-sample min-max over every axis but the first."""
    flat = x.reshape(x.shape[0], -1)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    lo = flat.amin(dim=1).reshape(shape)
    hi = flat.amax(dim=1).reshape(shape)
    return (x - lo) / torch.clamp(hi - lo, min=EPSILON)


def label_downsample(y, resolution: int = 32):
    return (avg_pool_same(y, resolution, resolution) >= 0.5).to(y.dtype)


def density_labels(y, multiplier: float):
    """Each voice's label mass normalised to 1 and summed over the voices,
    then five 'SAME' pools of 2 frames times 2 (each 32 frames summed),
    times ``multiplier``."""
    y = (y / torch.clamp(y.sum(dim=(-2, -1), keepdim=True), min=EPSILON)
         ).sum(dim=-3)
    for _ in range(5):
        y = avg_pool_same(y, 2, 2) * 2
    return y * multiplier


def features(mag, labels, melm, tmask=None, fmask=None, density=False,
             multiplier: float = 1.0):
    """(log-mel [B, n_mels, T, 2], targets) of one batch: magnitude times
    the keep masks, the mel matmul, per-sample minmax, log(x + 1e-8); the
    frame labels summed over voices and pooled 32 times, or the density
    labels."""
    b, t, width = mag.shape
    if tmask is not None:
        mag = mag * tmask[:, :, None] * fmask.repeat(1, 2)[:, None, :]
    mel = torch.matmul(mag.reshape(b, t, 2, width // 2), melm)
    x = torch.log(minmax(mel.permute(0, 3, 1, 2)) + EPSILON)
    if density:
        return x, density_labels(labels, multiplier)
    return x, label_downsample(labels.sum(dim=-3), 32)


def _draws_and_masks(gen, banks: Banks, cfg: dict, training: bool):
    b, n_frame = cfg['batch_size'], cfg['n_frame']
    d = draw(gen, banks, b, n_frame, cfg['max_voices'], cfg['max_noises'],
             cfg['snr'])
    if not training:
        return d, None, None
    return d, keep_mask(gen, b, n_frame, 24, 6), keep_mask(gen, b, FREQ, 16, 1)


def batch_draws(gen, banks: Banks, cfg: dict, training: bool) -> Draws:
    """The draws of the batch that :func:`batch` makes from ``gen``, with
    the generator left where :func:`batch` leaves it."""
    return _draws_and_masks(gen, banks, cfg, training)[0]


def batch(gen, banks: Banks, cfg: dict, melm, training: bool):
    """One batch as the program's feature function makes it: the draws,
    then (training only) the time and frequency keep masks from the same
    generator, the synthesis and the features. ``cfg`` is a configuration
    file's ``model`` and ``train`` blocks merged. Returns (x, y)."""
    d, tmask, fmask = _draws_and_masks(gen, banks, cfg, training)
    mag, labels = synthesize(banks, d)
    return features(mag, labels, melm, tmask, fmask, cfg['density'],
                    cfg['multiplier'])
