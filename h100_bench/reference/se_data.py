"""The se v9 training batch, worked out again from the sources and the
seeds: the draws of ``data.draw`` (no keep masks: the se features draw
none), the three complex windows of the se triple (the full mix,
``only_voice`` and ``only_noise``) as ordered float32 sums, the
speech-enhancement preprocess and the pooled frame labels.

The windows (``mixture.py:493-527`` of the JAX package; the program's
``data/mixture.py`` ``synthesize_se``): the full mix is the background
window, then each active voice and noise clip in slot order, ``acc + w *
clip`` on the rows its shift puts inside the window, as ``data.synthesize``
sums it before its magnitude; ``only_noise`` the same without the voices;
``only_voice`` the voices alone, summed from zeros. The preprocess
(``sj_train.py``'s ``speech_enhancement_preprocess``; the program's
``data/labels.py``): each window [B, T, chan * freq] as [B, freq, T,
chan], the DC row dropped; the input keeps the real half of the channels
(re0, re1), the two targets keep channel 0 only (re0: the source halves
the already halved channel count), which the loss broadcasts against the
outputs' two channels. The labels: the per-voice frame labels of the
active voices, summed over the voices and pooled 32 times.
"""

from __future__ import annotations

import torch

from h100_bench.reference import data as ref_data
from h100_bench.reference.data import Banks, Draws


def window(banks: Banks, d: Draws, background: bool = True,
           voices: bool = True, noises: bool = True):
    """The complex window [B, n_frame, chan * freq] of the background (or
    zeros), the voices and the noises that are asked for, summed in
    ``data.synthesize``'s order."""
    bg = banks.backgrounds.flat
    t = torch.arange(d.n_frame, device=bg.device)
    acc = bg[d.bidx.long()[:, None], d.boff.long()[:, None] + t[None, :]]
    if not background:
        acc = torch.zeros_like(acc)
    for on, bank, idx, shift, w, lens in (
            (voices, banks.voices, d.vidx, d.vshift, d.vw, d.vlens),
            (noises, banks.noises, d.nidx, d.nshift, d.nw, d.nlens)):
        if not on or idx is None:
            continue
        rows = bank.flat.shape[1]
        for k in range(idx.shape[1]):
            j = t[None, :] - shift[:, k, None].long()
            valid = ((j >= 0) & (j < lens[:, k, None].clamp(max=rows))
                     & (w[:, k, None] != 0))
            clip = bank.flat[idx[:, k, None].long(), j.clamp(0, rows - 1)]
            acc = torch.where(valid[..., None],
                              acc + w[:, k, None, None] * clip, acc)
    return acc


def triple(banks: Banks, d: Draws):
    """(full, only_voice, only_noise), each [B, freq, n_frame, chan]."""
    chan = banks.backgrounds.flat.shape[-1] // ref_data.FREQ

    def unflat(flat):
        return flat.reshape(flat.shape[0], d.n_frame, chan,
                            ref_data.FREQ).permute(0, 3, 1, 2)
    return (unflat(window(banks, d)),
            unflat(window(banks, d, background=False, noises=False)),
            unflat(window(banks, d, voices=False)))


def preprocess(full, only_voice, only_noise):
    """(x [B, 256, T, 2], speech target [B, 256, T, 1], noise target
    [B, 256, T, 1])."""
    half = full.shape[-1] // 2
    return (full[:, 1:, :, :half], only_voice[:, 1:, :, :half // 2],
            only_noise[:, 1:, :, :half // 2])


def labels(banks: Banks, d: Draws):
    """The pooled frame labels [B, n_frame / 32, C] of the active
    voices."""
    per_voice = ref_data._candidate_labels(banks, d.vidx, d.vshift,
                                           d.n_frame) \
        * (d.vw != 0).float()[..., None, None]
    return ref_data.label_downsample(per_voice.sum(dim=-3), 32)


def batch_draws(gen, banks: Banks, cfg: dict) -> Draws:
    """One batch's draws from ``gen``; ``cfg`` is a configuration file's
    ``model`` and ``train`` blocks merged."""
    return ref_data.draw(gen, banks, cfg['batch_size'], cfg['n_frame'],
                         cfg['max_voices'], cfg['max_noises'], cfg['snr'])


def batch(gen, banks: Banks, cfg: dict):
    """One se batch as the program's feature function makes it: (x,
    (labels, speech target, noise target))."""
    d = batch_draws(gen, banks, cfg)
    x, speech, noise = preprocess(*triple(banks, d))
    return x, (labels(banks, d), speech, noise)
