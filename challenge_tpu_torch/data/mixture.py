"""On-device mixture synthesis (counterpart: ``challenge_tpu/data/mixture.py``
``sample_batch``, its Pallas paths; reference: pipeline.py:6-110).

A batch is made in two steps so that tests can feed JAX's draws to the port:

* :func:`draw` makes every random choice of a batch with one
  ``torch.Generator``: background items and window offsets, voice and
  noise items (shuffled repeating streams), their row shifts and mix
  weights, with the reference's overlap rejection folded into the voice
  weights (a rejected or inactive slot has weight 0);
* :func:`synthesize` turns draws into ``(magnitude, frame labels)``: the
  magnitude through the CUDA synthesis kernel (``ops/synth.py``), the
  labels by placing each accepted voice's energy mask at its shift;
  :func:`synthesize_complex` gives the complex window instead, through the
  flat-complex kernel, for the channel maps of n_chan != 2;
  :func:`synthesize_mel` gives the masked mel and its min and max, through
  the fused mel kernel; :func:`synthesize_se` gives the complex
  spectrogram and the se family's targets, through the se-triple
  kernel (the flat-complex sum with three accumulators).

:func:`sample_batch` is JAX's reference-shaped batch API over these
(:func:`draw`, then :func:`batch_of`), and :func:`merge_complex_specs`
its per-sample synthesis in plain tensor code, split in the same way into
:func:`merge_draws` and :func:`merge_placed`.

The upper bounds of the voice and noise counts are exclusive, as in the
reference (tf.random.uniform's exclusive maxval, pipeline.py:43,87): a
``max_voices``-voice mixture never occurs. The draws follow JAX's
distributions, not its bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from challenge_tpu_torch.data.specset import SpecBank
from challenge_tpu_torch.ops import synth


class Banks(NamedTuple):
    backgrounds: SpecBank
    voices: SpecBank
    voice_labels: torch.Tensor       # [Nv, n_classes] one-hot
    noises: Optional[SpecBank] = None


class Draws(NamedTuple):
    """The random choices of one batch, as the synthesis kernel takes them:
    int32 indices, shifts and lengths, float32 weights ([B] or [B, slots])."""
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


def _stream_draw(gen, n_items: int, shape):
    """Concatenated random permutations of [0, n_items), sliced in order:
    the reference's ``.repeat().shuffle(len)`` streams (pipeline.py:143-156)
    up to tf.data's sliding shuffle buffer (see the JAX docstring)."""
    count = 1
    for s in shape:
        count *= int(s)
    n_perms = -(-count // n_items)
    perms = torch.cat([torch.randperm(n_items, generator=gen,
                                      device=gen.device)
                       for _ in range(n_perms)])
    return perms[:count].reshape(shape).to(torch.int32)


def _dyn_randint(gen, maxval):
    """Uniform int in [0, maxval) per element, maxval >= 1 enforced;
    floor(u * maxval) in float32 like JAX."""
    maxval = maxval.clamp(min=1)
    u = torch.rand(maxval.shape, generator=gen, device=maxval.device)
    return torch.floor(u * maxval.float()).to(torch.int32)


def _placement_draw(gen, length, n_frame: int, min_ratio: float,
                    crop_style: bool):
    """The reference's pad-then-random-crop (pipeline.py:57-74 voices,
    96-103 noises): voices draw the offset from the exclusive range
    (tf.random.uniform), noises from the inclusive one
    (tf.image.random_crop). Clip frame j lands at ``j + pad - offset``."""
    pad = n_frame - torch.floor(min_ratio * length.float()).to(torch.int32)
    pad = pad.clamp(min=0)
    span = length + 2 * pad - n_frame
    maxval = span + 1 if crop_style else span
    return _dyn_randint(gen, maxval), pad


def _placement_shift(gen, length, n_frame: int, min_ratio: float,
                     crop_style: bool):
    """The row shift s with out[j + s] += clip[j]."""
    offset, pad = _placement_draw(gen, length, n_frame, min_ratio,
                                  crop_style)
    return pad - offset


def _shift_rows(e, shifts, n_frame: int):
    """out[..., t] = e[..., t - shifts[...]] for t in [0, n_frame), zero
    where t - shift falls outside e. Plain indexing; the JAX package builds
    the same grid with one-hot matmuls because TPU scatters serialize."""
    t_len = e.shape[-1]
    j = torch.arange(n_frame, device=e.device) - shifts[..., None].long()
    valid = (j >= 0) & (j < t_len)
    return torch.gather(e, -1, j.clamp(0, t_len - 1)) * valid.to(e.dtype)


def _frame_labels(banks: Banks, vidx, vshift, n_frame: int):
    """Candidate per-voice frame labels [B, V, n_frame, C]: each voice's
    energy mask placed at its shift, times its one-hot class."""
    vidx = vidx.long()
    mask = _shift_rows(banks.voices.pos_mask[vidx], vshift, n_frame)
    return mask[..., None] * banks.voice_labels[vidx][:, :, None, :]


def _accept_scan(l_frames, active):
    """Sequential overlap rejection (reference: pipeline.py:78-84).

    l_frames: [B, V, n_frame, C] candidate labels; active: [B, V] bool.
    A voice is rejected if adding it would make any (frame, class) reach 2
    over the voices accepted before it. Returns accept [B, V] float32."""
    acc = torch.zeros_like(l_frames[:, 0])
    accepts = []
    for v in range(l_frames.shape[1]):
        l_v = l_frames[:, v]
        no_overlap = (acc + l_v).amax(dim=(1, 2)) < 2.0
        accept = (active[:, v] & no_overlap).to(l_frames.dtype)
        acc = acc + l_v * accept[:, None, None]
        accepts.append(accept)
    return torch.stack(accepts, dim=1)


def draw(gen: torch.Generator, banks: Banks, batch_size: int, n_frame: int,
         max_voices: int = 7, max_noises: int = 2, min_ratio: float = 1.0,
         min_noise_ratio: float = 1 / 2, snr: float = -20.0) -> Draws:
    """Every random choice of one batch (counterpart: the draws of
    ``sample_batch``, mixture.py:362-426 and the background offset at
    :451-455). ``gen`` must live on the banks' device."""
    b = batch_size
    bg, vo, no = banks.backgrounds, banks.voices, banks.noises
    device = bg.flat.device

    bidx = _stream_draw(gen, bg.n, (b,))
    vidx = _stream_draw(gen, vo.n, (b, max_voices))

    # background window start: tile-then-random-crop (pipeline.py:29-35)
    # read as one contiguous window of the (wrapped) bank
    bg_lens = bg.lens[bidx.long()].clamp(min=1)
    n_tile = (n_frame + bg_lens - 1) // bg_lens
    boff = _dyn_randint(gen, n_tile * bg_lens - n_frame + 1)

    # voices; padded-batch semantics: every voice of a sample is placed as
    # if it had the longest length of that sample's draw (pipeline.py:51)
    if max_voices > 1:
        n_voices = torch.randint(1, max_voices, (b,), generator=gen,
                                 device=device)
    else:
        n_voices = torch.ones((b,), dtype=torch.int64, device=device)
    vlens = vo.lens[vidx.long()]
    v_eff = vlens.amax(dim=1, keepdim=True).expand(b, max_voices)
    ratio_u = torch.rand((b, max_voices), generator=gen,
                         device=device) * (-snr / 10.0)
    ratios = torch.pow(10.0, -ratio_u)
    vshift = _placement_shift(gen, v_eff, n_frame, min_ratio,
                              crop_style=False)
    active = torch.arange(max_voices, device=device)[None, :] \
        < n_voices[:, None]
    accept = _accept_scan(_frame_labels(banks, vidx, vshift, n_frame),
                          active)
    vw = accept * ratios

    if no is None or max_noises <= 0:
        return Draws(n_frame, bidx, boff, vidx, vshift, vw, vlens)
    nidx = _stream_draw(gen, no.n, (b, max_noises))
    n_noises = torch.randint(0, max_noises, (b,), generator=gen,
                             device=device)
    nlens = no.lens[nidx.long()]
    n_eff = nlens.amax(dim=1, keepdim=True).expand(b, max_noises)
    nshift = _placement_shift(gen, n_eff, n_frame, min_noise_ratio,
                              crop_style=True)
    nratios = torch.pow(10.0, -2.0 * torch.rand(
        (b, max_noises), generator=gen, device=device))
    nw = (torch.arange(max_noises, device=device)[None, :]
          < n_noises[:, None]).float() * nratios
    return Draws(n_frame, bidx, boff, vidx, vshift, vw, vlens,
                 nidx, nshift, nw, nlens)


def synth_args(banks: Banks, draws: Draws):
    """``synthesize_magnitude``'s arguments for ``draws`` on ``banks``.

    int8 banks (mixture.py:467-472): each clip's dequantization scale is
    folded into its weight, ``w * flat_scale[idx]`` in float32, and the
    background scales ``flat_scale[bidx]`` go to the kernel. Scales are
    > 0, so the ``w != 0`` activity gate is unchanged."""
    bg, vo, no = banks.backgrounds, banks.voices, banks.noises
    d = draws
    if bg.contig_exact_frames < d.n_frame:
        raise ValueError(
            f'background bank reads exactly only up to '
            f'{bg.contig_exact_frames} frames, the window is {d.n_frame}: '
            f'build the banks with n_frame={d.n_frame}')
    vw, nw, bgscale = d.vw, d.nw, None
    if bg.flat_scale is not None:
        vw = d.vw * vo.flat_scale[d.vidx.long()]
        if d.nidx is not None:
            nw = d.nw * no.flat_scale[d.nidx.long()]
        bgscale = bg.flat_scale[d.bidx.long()]
    return (d.n_frame, bg.flat, d.bidx, d.boff, vo.flat, d.vidx, d.vshift,
            vw, None if d.nidx is None else no.flat, d.nidx, d.nshift, nw,
            d.vlens, d.nlens, bgscale)


def synthesize(banks: Banks, draws: Draws):
    """Draws -> (magnitude [B, n_frame, 2*freq] in the channel-major flat
    layout, frame labels [B, V, n_frame, C]) (counterpart: the magnitude
    branch of ``sample_batch``, mixture.py:534-544, and its labels). The
    magnitude is float32 for float32 banks and bfloat16 for bfloat16 and
    int8 banks.

    A voice slot carries labels iff its drawn weight is nonzero: weights
    are ``accept * 10**-u`` with ``10**-u > 0``."""
    d = draws
    return (synth.synthesize_magnitude(*synth_args(banks, d)),
            _labels(banks, d))


def synthesize_complex(banks: Banks, draws: Draws):
    """Draws -> (the complex window [B, n_frame, chan * freq] in the flat
    layout, frame labels [B, V, n_frame, C]) (counterpart: the
    ``layout='tfc'`` branch of ``sample_batch`` without ``magnitude``,
    mixture.py:489-491, 545), through the flat-complex kernel: float32 for
    float32 banks, bfloat16 for bfloat16 and int8 banks."""
    return synth.synthesize_flat(*synth_args(banks, draws)), \
        _labels(banks, draws)


def synthesize_mel(banks: Banks, draws: Draws, melm, tmask, fmask,
                   band=None):
    """Draws -> ((mel [B, n_mels, n_frame, chan / 2], mm [B, 2]), frame
    labels [B, V, n_frame, C]) (counterpart: the ``mel_pack`` branch of
    ``sample_batch``, mixture.py:442-444, 484-487), through the fused mel
    kernel: the masked mel of the float32 magnitude and its per-sample min
    and max, float32 for every bank dtype. melm [freq, n_mels]; tmask
    [B, n_frame] and fmask [B, chan / 2 * freq] {0,1} masks; band the
    ``synth.mel_band`` of melm, or None to build it."""
    return (synth.synthesize_mel(*synth_args(banks, draws), melm=melm,
                                 tmask=tmask, fmask=fmask, band=band),
            _labels(banks, draws))


def _labels(banks: Banks, d: Draws):
    return _frame_labels(banks, d.vidx, d.vshift, d.n_frame) \
        * (d.vw != 0).to(torch.float32)[..., None, None]


def se_synth_args(banks: Banks, draws: Draws):
    """The arguments of the se v9 targets' three flat-complex calls
    (``synth.se_triple_args`` of :func:`synth_args`): the full mix,
    ``only_noise`` and ``only_voice``. :func:`synthesize_se` computes all
    three in one launch; the separate calls are its checks."""
    return synth.se_triple_args(*synth_args(banks, draws))


def synthesize_se(banks: Banks, draws: Draws):
    """Draws -> ``(spec, (label, only_voice, only_noise))`` (counterpart:
    the ``seperate_noise_voice`` branch of ``sample_batch``,
    mixture.py:489-532): complex spectrograms in the reference layout
    [B, freq, n_frame, chan], the three windows of :func:`se_synth_args`
    from one se-triple kernel launch, and the per-voice frame labels [B, V,
    n_frame, C]. Spectrograms are float32 for float32 banks and bfloat16
    for bfloat16 and int8 banks."""
    chan = banks.backgrounds.chan

    def unflat(flat):                   # [B, T, chan * freq] -> [B, f, T, c]
        return flat.reshape(flat.shape[0], draws.n_frame, chan, -1).permute(
            0, 3, 1, 2)

    full, only_noise, only_voice = synth.synthesize_se(
        *synth_args(banks, draws))
    return unflat(full), (_labels(banks, draws), unflat(only_voice),
                          unflat(only_noise))


# ------------------------------------------------ the reference-shaped API
def batch_of(banks: Banks, draws: Draws, n_classes: Optional[int] = None,
             seperate_noise_voice: bool = False, layout: str = 'ftc',
             magnitude: bool = False):
    """Draws -> :func:`sample_batch`'s output, through the synthesis
    kernel of the route: the flat-complex kernel (B2) for a complex
    spectrogram, the se triple for ``seperate_noise_voice``, the magnitude
    kernel (B1/B3) for ``magnitude``. Spectrograms are float32 for float32
    banks and bfloat16 for bfloat16 and int8 banks."""
    width = banks.voice_labels.shape[-1]
    if n_classes is not None and n_classes != width:
        raise ValueError(f'banks have {width} label classes, not '
                         f'{n_classes}')
    if layout not in ('ftc', 'tfc'):
        raise ValueError(f"layout must be 'ftc' or 'tfc', not {layout!r}")
    b, nf = draws.bidx.shape[0], draws.n_frame
    chan = banks.backgrounds.chan
    if magnitude:
        if layout != 'tfc' or seperate_noise_voice:
            raise ValueError('magnitude mode implies time-major output '
                             "(layout='tfc') without se targets")
        mag, label = synthesize(banks, draws)      # [B, T, chan/2 * freq]
        return mag.reshape(b, nf, chan // 2, -1), label
    if seperate_noise_voice:
        spec, (label, only_voice, only_noise) = synthesize_se(banks, draws)
        if layout == 'tfc':
            spec, only_voice, only_noise = (
                t.transpose(1, 2) for t in (spec, only_voice, only_noise))
        return spec, (label, only_voice, only_noise)
    flat, label = synthesize_complex(banks, draws)
    spec = flat.reshape(b, nf, chan, -1).transpose(2, 3)   # [B, T, f, c]
    return (spec if layout == 'tfc' else spec.transpose(1, 2)), label


def sample_batch(gen: torch.Generator, banks: Banks, batch_size: int,
                 n_frame: int, n_classes: int = 3, max_voices: int = 7,
                 max_noises: int = 2, min_ratio: float = 1.0,
                 min_noise_ratio: float = 1 / 2, snr: float = -20.0,
                 seperate_noise_voice: bool = False, layout: str = 'ftc',
                 magnitude: bool = False):
    """A whole training batch on the banks' device (counterpart:
    ``sample_batch``, mixture.py:313-594): :func:`draw` with ``gen``, then
    :func:`batch_of`. Returns ``(spec [B, freq, n_frame, chan], label [B,
    max_voices, n_frame, n_classes])``, with ``layout='tfc'`` the spec as
    [B, n_frame, freq, chan]; with ``seperate_noise_voice`` the reference's
    ``(spec, (label, only_voice, only_noise))``; with ``magnitude=True``
    (needs 'tfc') ``|spec|`` [B, n_frame, chan/2, freq]. JAX's
    ``magnitude='flat'`` (its lane-padded layout) and ``use_pallas``
    have no counterpart: on the card the kernel always runs, on the CPU its
    plain version."""
    d = draw(gen, banks, batch_size, n_frame, max_voices=max_voices,
             max_noises=max_noises, min_ratio=min_ratio,
             min_noise_ratio=min_noise_ratio, snr=snr)
    return batch_of(banks, d, n_classes, seperate_noise_voice, layout,
                    magnitude)


class MergeDraws(NamedTuple):
    """The random choices of one :func:`merge_complex_specs` sample: the
    background window's start, the voice count, each voice's mix ratio and
    window offset [V], the noise count and each noise's ratio and offset
    [N] (ratios float32, the rest int32)."""
    bg_offset: torch.Tensor
    n_voices: torch.Tensor
    voice_ratios: torch.Tensor
    voice_offsets: torch.Tensor
    n_noises: Optional[torch.Tensor] = None
    noise_ratios: Optional[torch.Tensor] = None
    noise_offsets: Optional[torch.Tensor] = None


def merge_draws(gen: torch.Generator, n_voices: int, n_frame: int,
                bg_len: int, voice_len: int, n_noises: int = 0,
                noise_len: int = 0, min_ratio: float = 2 / 3,
                min_noise_ratio: float = 1 / 2,
                snr: float = -20) -> MergeDraws:
    """Every random choice of :func:`merge_complex_specs` for ``n_voices``
    voice and ``n_noises`` noise slots (mixture.py:168-224): the tiled
    background's window start, the voice count in [1, V) (1 for one
    slot), per voice a ratio 10**-U(0, -snr/10) and a padded-crop offset,
    the noise count in [0, N), per noise a ratio 10**-U(0, 2) and an
    inclusive-crop offset."""
    dev = gen.device

    def ints(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    n_tile = -(-n_frame // max(bg_len, 1))
    bg_offset = _dyn_randint(gen, ints(n_tile * bg_len - n_frame + 1))
    count = (torch.randint(1, n_voices, (), generator=gen, device=dev)
             if n_voices > 1 else torch.ones((), dtype=torch.int64,
                                             device=dev))
    ratios = torch.pow(10.0, -torch.rand((n_voices,), generator=gen,
                                         device=dev) * (-snr / 10.0))
    offsets, _ = _placement_draw(gen, ints([voice_len] * n_voices), n_frame,
                                 min_ratio, crop_style=False)
    if n_noises <= 0:
        return MergeDraws(bg_offset, count.to(torch.int32), ratios, offsets)
    n_count = torch.randint(0, n_noises, (), generator=gen, device=dev)
    n_ratios = torch.pow(10.0, -2.0 * torch.rand((n_noises,), generator=gen,
                                                 device=dev))
    n_offsets, _ = _placement_draw(gen, ints([noise_len] * n_noises),
                                   n_frame, min_noise_ratio, crop_style=True)
    return MergeDraws(bg_offset, count.to(torch.int32), ratios, offsets,
                      n_count.to(torch.int32), n_ratios, n_offsets)


def _windows(clips, length: int, offsets, n_frame: int, min_ratio: float):
    """Each clip's padded-crop window [K, freq, n_frame, chan]: clip frame
    j lands at ``j + pad - offset``, zeros elsewhere (mixture.py:91-101)."""
    pad = max(n_frame - int(torch.floor(torch.tensor(
        min_ratio, dtype=torch.float32) * float(length))), 0)
    idx = (torch.arange(n_frame, device=clips.device)[None, :]
           + (offsets.long() - pad)[:, None])             # [K, n_frame]
    valid = (idx >= 0) & (idx < length)
    idx = idx.clamp(0, max(length - 1, 0))
    win = torch.stack([c[:, i] for c, i in zip(clips, idx)])
    return win * valid[:, None, :, None].to(clips.dtype)


def merge_placed(background, voices_and_labels, noises, draws: MergeDraws,
                 n_frame: int = 300, n_classes: int = 3,
                 min_ratio: float = 2 / 3, min_noise_ratio: float = 1 / 2,
                 seperate_noise_voice: bool = False, bg_len=None,
                 voice_lens=None, noise_lens=None):
    """:func:`merge_complex_specs` for the given ``draws``: the background
    window, each voice's window and frame labels, the sequential overlap
    rejection, the weighted sums (mixture.py:170-227). Plain tensor code,
    as in JAX (no kernel)."""
    voices, labels = voices_and_labels
    tb, v, tv = background.shape[1], voices.shape[0], voices.shape[2]
    bg_len = tb if bg_len is None else int(bg_len)
    voice_len = tv if voice_lens is None else int(max(voice_lens))
    dev = background.device
    t = torch.arange(n_frame, device=dev)
    spec = background[:, (draws.bg_offset.long() + t) % max(bg_len, 1)]
    only_noise = spec
    wins = _windows(voices, voice_len, draws.voice_offsets, n_frame,
                    min_ratio)
    frame_mask = (wins.amax(dim=(1, 3)) > 0).float()        # [V, n_frame]
    l_frames = frame_mask[:, :, None] * labels[:, None, :]  # [V, n_frame, C]
    active = torch.arange(v, device=dev) < draws.n_voices
    accept = _accept_scan(l_frames[None], active[None])[0]
    if l_frames.shape[-1] != n_classes:
        raise ValueError(f'labels have {l_frames.shape[-1]} classes, not '
                         f'{n_classes}')
    voice_sum = torch.einsum('v,vfnc->fnc', accept * draws.voice_ratios,
                             wins)
    spec = spec + voice_sum
    label = l_frames * accept[:, None, None]
    if noises is not None:
        tn = noises.shape[2]
        noise_len = tn if noise_lens is None else int(max(noise_lens))
        nwins = _windows(noises, noise_len, draws.noise_offsets, n_frame,
                         min_noise_ratio)
        n_active = (torch.arange(noises.shape[0], device=dev)
                    < draws.n_noises).float()
        noise_sum = torch.einsum('x,xfnc->fnc',
                                 n_active * draws.noise_ratios, nwins)
        spec = spec + noise_sum
        only_noise = only_noise + noise_sum
    if seperate_noise_voice:
        return spec, (label, voice_sum, only_noise)
    return spec, label


def merge_complex_specs(gen: torch.Generator, background, voices_and_labels,
                        noises=None, n_frame: int = 300, n_classes: int = 3,
                        min_ratio: float = 2 / 3,
                        min_noise_ratio: float = 1 / 2, snr: float = -20,
                        seperate_noise_voice: bool = False, bg_len=None,
                        voice_lens=None, noise_lens=None):
    """One sample with the reference's semantics (counterpart:
    ``merge_complex_specs``, mixture.py:134-229; reference:
    pipeline.py:6-110): background [freq, Tb, chan], ``(voices [V, freq,
    Tv, chan], labels [V, n_classes])``, noises [N, freq, Tn, chan] ->
    ``(spec [freq, n_frame, chan], label [V, n_frame, n_classes])``, or
    with ``seperate_noise_voice`` ``(spec, (label, only_voice,
    only_noise))``. Lengths default to the padded extents, as the
    reference's padded batches see them. :func:`merge_draws` with ``gen``,
    then :func:`merge_placed`; the argument order, the defaults and the
    misspelled ``seperate_noise_voice`` are JAX's."""
    voices = voices_and_labels[0]
    draws = merge_draws(
        gen, voices.shape[0], n_frame,
        background.shape[1] if bg_len is None else int(bg_len),
        voices.shape[2] if voice_lens is None else int(max(voice_lens)),
        0 if noises is None else noises.shape[0],
        0 if noises is None else (noises.shape[2] if noise_lens is None
                                  else int(max(noise_lens))),
        min_ratio, min_noise_ratio, snr)
    return merge_placed(background, voices_and_labels, noises, draws,
                        n_frame, n_classes, min_ratio, min_noise_ratio,
                        seperate_noise_voice, bg_len, voice_lens, noise_lens)
