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
  spectrogram and the se family's targets, through the flat-complex
  kernel.

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
    """The arguments of the se v9 targets' three flat-complex kernel calls
    (mixture.py:493-527), each a sub-mix of the first in the same order:

    * the full mix, ``synth_args``;
    * ``only_noise``: the background and the noises, every voice weight
      zeroed, so that the kernel skips the voices;
    * ``only_voice``: the voices accumulated from zeros, over a one-item
      all-zero background bank (with a unit background scale for int8
      banks), so that quiet voices do not cancel against the background.
    """
    args = synth_args(banks, draws)
    (n_frame, bg, bidx, boff, vbank, vidx, vshift, vw, nbank, nidx, nshift,
     nw, vlens, nlens, bgscale) = args
    only_noise = args[:7] + (torch.zeros_like(vw),) + args[8:]
    zbank = torch.zeros((1, n_frame, bg.shape[-1]), dtype=bg.dtype,
                        device=bg.device)
    only_voice = (n_frame, zbank, torch.zeros_like(bidx),
                  torch.zeros_like(boff), vbank, vidx, vshift, vw, None, None,
                  None, None, vlens, None,
                  None if bgscale is None else torch.ones_like(bgscale))
    return args, only_noise, only_voice


def synthesize_se(banks: Banks, draws: Draws):
    """Draws -> ``(spec, (label, only_voice, only_noise))`` (counterpart:
    the ``seperate_noise_voice`` branch of ``sample_batch``,
    mixture.py:489-532): complex spectrograms in the reference layout
    [B, freq, n_frame, chan], from the flat-complex kernel's three calls
    of :func:`se_synth_args`, and the per-voice frame labels [B, V,
    n_frame, C]. Spectrograms are float32 for float32 banks and bfloat16
    for bfloat16 and int8 banks."""
    chan = banks.backgrounds.chan

    def unflat(flat):                   # [B, T, chan * freq] -> [B, f, T, c]
        return flat.reshape(flat.shape[0], draws.n_frame, chan, -1).permute(
            0, 3, 1, 2)

    full, only_noise, only_voice = (synth.synthesize_flat(*a) for a in
                                    se_synth_args(banks, draws))
    return unflat(full), (_labels(banks, draws), unflat(only_voice),
                          unflat(only_noise))
