"""Mixture synthesis (counterpart: ``challenge_tpu/ops/pallas_synth.py``,
all four modes of its one kernel).

``synthesize_magnitude``, ``synthesize_flat`` and ``synthesize_mel`` are
the wrappers of the CUDA kernels in ``csrc/synth.cu`` and
``csrc/synth_mel.cu``, which replace ``pallas_synth.py::_kernel``. Per
sample all three take the background window, add each active voice clip and
then each active noise clip, in slot order, at its row shift, and drop rows
outside the window. Bank elements are upcast to float32 and the sum is
taken in float32 whatever their type; int8 banks are dequantized by the
background scale ``bgscale`` and by clip scales the caller has folded into
the weights. They differ in the epilogue:

* ``synthesize_magnitude`` returns ``sqrt(re^2 + im^2)`` over the flat
  layout's column halves, and the complex window never reaches device
  memory: ``synth_mag_f32`` for float32 banks (B1), ``synth_mag_bf16`` and
  ``synth_mag_int8`` for bfloat16 and int8 banks (B3);
* ``synthesize_flat`` returns the window itself, the flat-complex output
  (B2): ``synth_flat_f32``, ``synth_flat_bf16`` and ``synth_flat_int8``;
* ``synthesize_se`` returns the se v9 targets' three windows (the full
  mix, only_noise and only_voice of :func:`se_triple_args`) from one
  launch that reads each source once: ``synth_se_f32``, ``synth_se_bf16``
  and ``synth_se_int8``, B2 with three accumulators;
* ``synthesize_mel`` returns the masked mel of the float32 magnitude and
  its per-sample min and max, and neither the window nor the magnitude
  reaches device memory (B4, the fused mel epilogue): ``synth_mel_f32``,
  ``synth_mel_bf16`` and ``synth_mel_int8``.

See the source for the kernels' bound and design. ``*_plain`` compute the
same ordered sum with separate PyTorch ops. The wrappers use them only for
tensors on the CPU; for CUDA tensors they launch a kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from challenge_tpu_torch.ops import cuda

# bank dtype -> (magnitude kernel, output dtype); the output dtype is also
# that of the flat-complex kernel of FLAT_KERNELS
KERNELS = {torch.float32: ('synth_mag_f32', torch.float32),
           torch.bfloat16: ('synth_mag_bf16', torch.bfloat16),
           torch.int8: ('synth_mag_int8', torch.bfloat16)}
FLAT_KERNELS = {torch.float32: 'synth_flat_f32',
                torch.bfloat16: 'synth_flat_bf16',
                torch.int8: 'synth_flat_int8'}
SE_KERNELS = {torch.float32: 'synth_se_f32',
              torch.bfloat16: 'synth_se_bf16',
              torch.int8: 'synth_se_int8'}
MEL_KERNELS = {torch.float32: 'synth_mel_f32',
               torch.bfloat16: 'synth_mel_bf16',
               torch.int8: 'synth_mel_int8'}      # float32 outputs
MAX_SLOTS = 32      # voice + noise slots per sample the kernel takes
MAX_PAIRS = 1024    # column pairs (m, F/2 + m) per row synth.cu takes
MEL_MAX_COLS = 256  # band columns (chans x n_f) synth_mel.cu takes


def _sources(vbank, vidx, vshift, vw, nbank, nidx, nshift, nw, vlens, nlens):
    """(bank, idx, shift, w, lens) per source, voices first; lens default to
    the bank's full row extent (its rows past a clip's length are zero)."""
    out = []
    for bank, idx, shift, w, lens in ((vbank, vidx, vshift, vw, vlens),
                                      (nbank, nidx, nshift, nw, nlens)):
        if bank is None:
            continue
        if lens is None:
            lens = torch.full(idx.shape, bank.shape[1], dtype=torch.int32,
                              device=idx.device)
        out.append((bank, idx, shift, w, lens))
    return out


def _ordered_sum(n_frame: int, bgbank, bidx, boff, vbank, vidx, vshift, vw,
                 nbank, nidx, nshift, nw, vlens, nlens, bgscale):
    """The kernels' float32 window [B, n_frame, F] as separate PyTorch ops:
    gather the background windows (upcast to float32, times ``bgscale``
    for int8 banks), then for each slot in order ``acc = acc + w * clip``
    where the slot is active and its shifted rows cover the window row."""
    t = torch.arange(n_frame, device=bgbank.device)
    acc = bgbank[bidx.long()[:, None], boff.long()[:, None] + t[None, :]]
    acc = acc.float()
    if bgscale is not None:
        acc = acc * bgscale[:, None, None]
    for bank, idx, shift, w, lens in _sources(
            vbank, vidx, vshift, vw, nbank, nidx, nshift, nw, vlens, nlens):
        rows = bank.shape[1]
        for k in range(idx.shape[1]):
            j = t[None, :] - shift[:, k, None].long()                 # [B, T]
            valid = ((j >= 0) & (j < lens[:, k, None].clamp(max=rows))
                     & (w[:, k, None] != 0))
            clip = bank[idx[:, k, None].long(), j.clamp(0, rows - 1)]  # [B,T,F]
            acc = torch.where(valid[..., None],
                              acc + w[:, k, None, None] * clip.float(), acc)
    return acc


def synthesize_magnitude_plain(n_frame: int, bgbank, bidx, boff,
                               vbank, vidx, vshift, vw,
                               nbank=None, nidx=None, nshift=None, nw=None,
                               vlens=None, nlens=None, bgscale=None):
    """The magnitude kernels' function as separate PyTorch ops: the ordered
    sum, then the magnitude. Returns [B, n_frame, F/2] in the kernel's
    output dtype."""
    acc = _ordered_sum(n_frame, bgbank, bidx, boff, vbank, vidx, vshift, vw,
                       nbank, nidx, nshift, nw, vlens, nlens, bgscale)
    half = acc.shape[-1] // 2
    re, im = acc[..., :half], acc[..., half:]
    # the IEEE float32 root, as CUDA's sqrtf gives it: torch's float32 sqrt
    # on the CPU is 1 ulp off for some inputs; a float64 root rounded once
    # to float32 is exact. A bfloat16 output rounds that float32 root once
    # more, as __float2bfloat16_rn does.
    out_dtype = KERNELS[bgbank.dtype][1]
    return torch.sqrt((re * re + im * im).double()).float().to(out_dtype)


def synthesize_flat_plain(n_frame: int, bgbank, bidx, boff,
                          vbank, vidx, vshift, vw,
                          nbank=None, nidx=None, nshift=None, nw=None,
                          vlens=None, nlens=None, bgscale=None):
    """The flat-complex kernels' function as separate PyTorch ops: the
    ordered sum, rounded once to the kernel's output dtype (to nearest
    even, as __float2bfloat16_rn). Returns [B, n_frame, F]."""
    acc = _ordered_sum(n_frame, bgbank, bidx, boff, vbank, vidx, vshift, vw,
                       nbank, nidx, nshift, nw, vlens, nlens, bgscale)
    return acc.to(KERNELS[bgbank.dtype][1])


def se_triple_args(n_frame: int, bgbank, bidx, boff, vbank, vidx, vshift,
                   vw, nbank=None, nidx=None, nshift=None, nw=None,
                   vlens=None, nlens=None, bgscale=None):
    """The se v9 targets' three flat-complex calls as argument tuples
    (counterpart: challenge_tpu/data/mixture.py:493-527), each a sub-mix of
    the first in the same slot order:

    * the full mix, the arguments as given;
    * ``only_noise``: the background and the noises, every voice weight
      zeroed, so that the sum skips the voices;
    * ``only_voice``: the voices accumulated from zeros, over a one-item
      all-zero background bank (with a unit background scale for int8
      banks), so that quiet voices do not cancel against the background.
    """
    args = (n_frame, bgbank, bidx, boff, vbank, vidx, vshift, vw, nbank,
            nidx, nshift, nw, vlens, nlens, bgscale)
    only_noise = args[:7] + (torch.zeros_like(vw),) + args[8:]
    zbank = torch.zeros((1, n_frame, bgbank.shape[-1]), dtype=bgbank.dtype,
                        device=bgbank.device)
    only_voice = (n_frame, zbank, torch.zeros_like(bidx),
                  torch.zeros_like(boff), vbank, vidx, vshift, vw, None, None,
                  None, None, vlens, None,
                  None if bgscale is None else torch.ones_like(bgscale))
    return args, only_noise, only_voice


def synthesize_se_plain(*args):
    """The se kernels' function as separate PyTorch ops: the three
    :func:`synthesize_flat_plain` calls of :func:`se_triple_args`. Returns
    ``(full, only_noise, only_voice)``, each [B, n_frame, F]."""
    full, only_noise, only_voice = se_triple_args(*args)
    return (synthesize_flat_plain(*full),
            synthesize_flat_plain(*only_noise),
            synthesize_flat_plain(*only_voice))


class MelBand(NamedTuple):
    """The nonzero band of a mel matrix [freq, n_mels] as the mel kernels
    take it: per mel bin, the rows (ascending) and weights of its nonzero
    entries (CSR: bin m's are ``off[m] .. off[m + 1]``), on the matrix's
    device; ``f_lo`` and ``n_f`` bound the rows that any bin reads, and
    ``rows`` lists them."""
    off: torch.Tensor
    row: torch.Tensor
    w: torch.Tensor
    f_lo: int
    n_f: int
    rows: tuple


def mel_band(melm: torch.Tensor) -> MelBand:
    """The :class:`MelBand` of ``melm``, computed on the host (one copy
    from the device); callers that apply one matrix to many batches build
    it once. The entries must be >= 0, which makes leaving out the zero
    terms of the mel sum exact."""
    m = melm.detach().float().cpu().numpy()
    if m.ndim != 2 or (m < 0).any():
        raise ValueError('the mel matrix must be [freq, n_mels] and >= 0')
    nz = m != 0
    rows = np.flatnonzero(nz.any(axis=1))
    f_lo, f_hi = (int(rows[0]), int(rows[-1])) if rows.size else (0, 0)
    row = np.concatenate([np.flatnonzero(nz[:, j]) for j in
                          range(m.shape[1])]).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(nz.sum(axis=0))]).astype(np.int32)
    w = m[row, np.repeat(np.arange(m.shape[1]), np.diff(off))]
    dev = melm.device
    band = MelBand(torch.from_numpy(off).to(dev),
                   torch.from_numpy(row).to(dev),
                   torch.from_numpy(np.ascontiguousarray(w)).to(dev),
                   f_lo, f_hi - f_lo + 1, tuple(int(f) for f in rows))
    return band


def synthesize_mel_plain(n_frame: int, bgbank, bidx, boff,
                         vbank, vidx, vshift, vw,
                         nbank=None, nidx=None, nshift=None, nw=None,
                         vlens=None, nlens=None, bgscale=None, melm=None,
                         tmask=None, fmask=None, band=None):
    """The mel kernels' function as separate PyTorch ops: the ordered sum,
    the float32 magnitude (whatever the bank dtype), times ``fmask``; then
    the mel sum over the nonzero rows f of ``melm`` in increasing order,
    one rounded product and one rounded add per row, as the kernel takes
    it (a zero weight adds an exact 0); then times ``tmask``. Returns
    ``(mel [B, n_mels, n_frame, chans], mm [B, 2])``, both float32, with
    ``mm`` the per-sample min and max of the mel. ``band``: as in
    :func:`synthesize_mel`."""
    acc = _ordered_sum(n_frame, bgbank, bidx, boff, vbank, vidx, vshift, vw,
                       nbank, nidx, nshift, nw, vlens, nlens, bgscale)
    half = acc.shape[-1] // 2
    re, im = acc[..., :half], acc[..., half:]
    x = torch.sqrt((re * re + im * im).double()).float() * fmask[:, None, :]
    freq, n_mels = melm.shape
    b = acc.shape[0]
    x = x.reshape(b, n_frame, half // freq, freq)
    mel = torch.zeros((b, n_frame, half // freq, n_mels), device=x.device)
    for f in (mel_band(melm) if band is None else band).rows:
        mel = mel + x[..., f, None] * melm[f]
    mel = (mel * tmask[:, :, None, None]).permute(0, 3, 1, 2).contiguous()
    return mel, torch.stack([mel.amin(dim=(1, 2, 3)),
                             mel.amax(dim=(1, 2, 3))], dim=1)


_SOURCE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                    + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                    + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_void_p])
_ARGTYPES = (_SOURCE_ARGTYPES + [ctypes.c_void_p] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
_SE_ARGTYPES = (_SOURCE_ARGTYPES + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_MEL_ARGTYPES = (_SOURCE_ARGTYPES + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _check_aligned(name, x) -> None:
    """The kernels stage bank rows as 16-byte chunks of each range
    rounded down to 16 bytes, which stays inside a bank that starts on a
    16-byte boundary (csrc/synth_common.cuh)."""
    if x.data_ptr() % 16:
        raise ValueError(f'{name}: data_ptr() is not 16-byte aligned')


def check_mel_shape(chans: int, f_lo: int, n_f: int, freq: int,
                    element_size: int) -> None:
    """Raise ValueError for a shape that kernel B4 refuses: ``chans``
    channel planes of ``freq`` rows each, a band of rows ``f_lo ..
    f_lo + n_f - 1`` and banks of ``element_size`` bytes an element. Its
    lanes split a warp evenly over the channels, hold at most
    ``MEL_MAX_COLS`` band columns a tile row, and copy each band segment as
    the 16-byte chunks around it, which must stay inside the plane."""
    if chans < 1 or chans & (chans - 1) or chans > 16 \
            or chans * n_f > MEL_MAX_COLS:
        raise ValueError(f'{chans} channels x {n_f} band rows: the '
                         f'kernel takes 1, 2, 4, 8 or 16 channels and at '
                         f'most {MEL_MAX_COLS} band columns')
    if (freq - f_lo - n_f) * element_size < 15:
        raise ValueError('band: the kernel copies 16-byte chunks, so the '
                         'band must end 15 bytes before each plane does')


def _check(name, x, dtype, shape=None, device=None):
    if x.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {x.dtype}')
    if device is not None and x.device != device:
        raise ValueError(f'{name}: on {x.device}, expected {device}')
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(x.shape)}, expected {shape}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')


def _check_dtype(bgbank, bgscale) -> None:
    if bgbank.dtype not in KERNELS:
        raise TypeError(f'bank dtype {bgbank.dtype}: expected one of '
                        f'{sorted(str(d) for d in KERNELS)}')
    if (bgscale is not None) != (bgbank.dtype == torch.int8):
        raise ValueError('bgscale is required iff the banks are int8')


def _source_args(what: str, bgbank, bidx, boff, vbank, vidx, vshift, vw,
                 nbank, nidx, nshift, nw, vlens, nlens, bgscale):
    """Check the synthesis arguments for a launch on CUDA and return them as
    the entry points take them (pointers, strides and slot counts), with
    the per-source tensors they point into. The caller keeps those until
    it has launched: default lens are made here, and once freed their
    block may go to the next allocation before the kernel reads it."""
    device, dtype = bgbank.device, bgbank.dtype
    if device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {device}')
    b, width = bidx.shape[0], bgbank.shape[-1]
    if width % 2:
        raise ValueError(f'flat width {width} must be even (re | im halves)')
    _check('bgbank', bgbank, dtype, device=device)
    _check_aligned('bgbank', bgbank)
    if bgbank.ndim != 3:
        raise ValueError(f'bgbank: expected [N, rows, F], got {bgbank.shape}')
    _check('bidx', bidx, torch.int32, (b,), device)
    _check('boff', boff, torch.int32, (b,), device)
    if bgscale is not None:
        _check('bgscale', bgscale, torch.float32, (b,), device)
    srcs = _sources(vbank, vidx, vshift, vw, nbank, nidx, nshift, nw,
                    vlens, nlens)
    args = [bgbank.data_ptr(), bidx.data_ptr(), boff.data_ptr(),
            bgbank.shape[1] * width]
    n_slots = 0
    for name_, (bank, idx, shift, w, lens) in zip(('voice', 'noise'), srcs):
        k = idx.shape[1]
        n_slots += k
        _check(f'{name_} bank', bank, dtype, device=device)
        _check_aligned(f'{name_} bank', bank)
        if bank.ndim != 3 or bank.shape[-1] != width:
            raise ValueError(f'{name_} bank: expected [N, rows, {width}], '
                             f'got {tuple(bank.shape)}')
        for what_, x, dt in (('idx', idx, torch.int32),
                             ('shift', shift, torch.int32),
                             ('w', w, torch.float32),
                             ('lens', lens, torch.int32)):
            _check(f'{name_} {what_}', x, dt, (b, k), device)
        args += [bank.data_ptr(), idx.data_ptr(), shift.data_ptr(),
                 w.data_ptr(), lens.data_ptr(), k, bank.shape[1],
                 bank.shape[1] * width]
    if len(srcs) == 1:                      # no noise bank
        args += [None] * 5 + [0, 0, 0]
    if n_slots > MAX_SLOTS:
        raise ValueError(f'{n_slots} clip slots per sample; the kernel '
                         f'takes at most {MAX_SLOTS}')
    return args + [None if bgscale is None else bgscale.data_ptr()], srcs


def _run(lib: str, name: str, argtypes, *args) -> None:
    """Launch entry point ``name`` of ``csrc/<lib>.cu`` on the current
    stream of the first argument's device, and count the launch."""
    fn = getattr(cuda.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')
    cuda.count_launch(name)


def _launch(mode: str, n_frame: int, bgbank, bidx, boff,
            vbank, vidx, vshift, vw, nbank, nidx, nshift, nw, vlens, nlens,
            bgscale):
    """Check the arguments, then run the plain version on the CPU or launch
    the kernel of ``mode`` on CUDA: ``'mag'`` the magnitude, ``'flat'``
    the flat-complex window, ``'se'`` the se triple's three windows."""
    plain = {'mag': synthesize_magnitude_plain, 'flat': synthesize_flat_plain,
             'se': synthesize_se_plain}[mode]
    _check_dtype(bgbank, bgscale)
    if bgbank.device.type == 'cpu':
        return plain(n_frame, bgbank, bidx, boff, vbank, vidx, vshift, vw,
                     nbank, nidx, nshift, nw, vlens, nlens, bgscale)
    # srcs holds the tensors args points into until the launch
    args, srcs = _source_args(plain.__name__[:-len('_plain')], bgbank, bidx,
                              boff, vbank, vidx, vshift, vw, nbank, nidx,
                              nshift, nw, vlens, nlens, bgscale)
    dtype, b, width = bgbank.dtype, bidx.shape[0], bgbank.shape[-1]
    if width > 2 * MAX_PAIRS:
        raise ValueError(f'flat width {width}: the kernels take at most '
                         f'{2 * MAX_PAIRS} columns (a thread per pair)')
    name = {'mag': KERNELS[dtype][0], 'flat': FLAT_KERNELS[dtype],
            'se': SE_KERNELS[dtype]}[mode]
    outs = [torch.empty((b, n_frame, width // 2 if mode == 'mag' else width),
                        dtype=KERNELS[dtype][1], device=bgbank.device)
            for _ in range(3 if mode == 'se' else 1)]
    with torch.cuda.device(bgbank.device):
        _run('synth', name, _SE_ARGTYPES if mode == 'se' else _ARGTYPES,
             *args, *(o.data_ptr() for o in outs), b, n_frame, width)
    return tuple(outs) if mode == 'se' else outs[0]


def synthesize_magnitude(n_frame: int, bgbank, bidx, boff,
                         vbank, vidx, vshift, vw,
                         nbank=None, nidx=None, nshift=None, nw=None,
                         vlens=None, nlens=None, bgscale=None):
    """Synthesized magnitudes [B, n_frame, F/2]: float32 for float32 banks,
    bfloat16 for bfloat16 and int8 banks.

    bgbank/vbank/nbank: flat banks [N, rows, F] of one dtype (float32,
    bfloat16 or int8; F = 4 * freq, channel-major). bidx/boff: [B] int32
    background item and window start; the window rows
    ``boff .. boff + n_frame`` must lie inside the bank
    (``build_bank(..., wrap_frames=n_frame)`` guarantees it). vidx/vshift:
    [B, V] int32 clip item and row shift (clip row j lands on window row
    j + shift); vw: [B, V] float32 weights, 0 for an inactive slot, with an
    int8 bank's clip scales folded in; vlens: [B, V] int32 clip lengths
    (default: the bank's rows). Likewise for the optional noises.
    bgscale: [B] float32 background dequantization scales, given iff the
    banks are int8. Same argument order as the JAX ``synthesize_windows``.
    """
    return _launch('mag', n_frame, bgbank, bidx, boff, vbank, vidx, vshift,
                   vw, nbank, nidx, nshift, nw, vlens, nlens, bgscale)


def synthesize_flat(n_frame: int, bgbank, bidx, boff,
                    vbank, vidx, vshift, vw,
                    nbank=None, nidx=None, nshift=None, nw=None,
                    vlens=None, nlens=None, bgscale=None):
    """The synthesized complex windows [B, n_frame, F] in the flat layout
    (column c * freq + f; real planes first): float32 for float32 banks,
    bfloat16 for bfloat16 and int8 banks. Arguments and checks as
    :func:`synthesize_magnitude`; the JAX ``synthesize_windows`` with
    neither ``magnitude`` nor ``mel``."""
    return _launch('flat', n_frame, bgbank, bidx, boff, vbank, vidx, vshift,
                   vw, nbank, nidx, nshift, nw, vlens, nlens, bgscale)


def synthesize_mel(n_frame: int, bgbank, bidx, boff,
                   vbank, vidx, vshift, vw,
                   nbank=None, nidx=None, nshift=None, nw=None,
                   vlens=None, nlens=None, bgscale=None, melm=None,
                   tmask=None, fmask=None, band=None):
    """The synthesized windows' masked mel and its per-sample min and max:
    ``(mel [B, n_mels, n_frame, chans], mm [B, 2])``, float32 for every
    bank dtype; the JAX ``synthesize_windows(..., mel=...)``, with the mel
    in the model's layout.

    Synthesis arguments and checks as :func:`synthesize_magnitude`, then
    melm: [freq, n_mels] float32 mel matrix (>= 0) applied to each channel
    plane (freq = F / 2 / chans); tmask: [B, n_frame] and fmask: [B, F / 2]
    float32 {0,1} time and column masks (column c * freq + f); band: the
    :func:`mel_band` of ``melm``, built from it when None. Runs
    :func:`synthesize_mel_plain` on the CPU and kernel B4
    (``csrc/synth_mel.cu``) on CUDA."""
    _check_dtype(bgbank, bgscale)
    if melm is None or tmask is None or fmask is None:
        raise ValueError('synthesize_mel needs melm, tmask and fmask')
    if bgbank.device.type == 'cpu':
        return synthesize_mel_plain(n_frame, bgbank, bidx, boff, vbank, vidx,
                                    vshift, vw, nbank, nidx, nshift, nw,
                                    vlens, nlens, bgscale, melm, tmask, fmask,
                                    band)
    # srcs holds the tensors args points into until the launch
    args, srcs = _source_args('synthesize_mel', bgbank, bidx, boff, vbank,
                              vidx, vshift, vw, nbank, nidx, nshift, nw,
                              vlens, nlens, bgscale)
    device, b, width = bgbank.device, bidx.shape[0], bgbank.shape[-1]
    _check('melm', melm, torch.float32, device=device)
    freq, n_mels = melm.shape
    if (width // 2) % freq:
        raise ValueError(f'flat width {width}: not 2 x chans x {freq} rows')
    chans = width // 2 // freq
    _check('tmask', tmask, torch.float32, (b, n_frame), device)
    _check('fmask', fmask, torch.float32, (b, width // 2), device)
    if band is None:
        band = mel_band(melm)
    if band.off.numel() != n_mels + 1 or band.w.device != device:
        raise ValueError('band: not the mel_band of melm on its device')
    check_mel_shape(chans, band.f_lo, band.n_f, freq, bgbank.element_size())
    mel = torch.empty((b, n_mels, n_frame, chans), dtype=torch.float32,
                      device=device)
    mm = torch.empty((b, 2), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _run('synth_mel', MEL_KERNELS[bgbank.dtype], _MEL_ARGTYPES, *args,
             band.off.data_ptr(), band.row.data_ptr(), band.w.data_ptr(),
             band.row.numel(), n_mels, band.f_lo, band.n_f, freq,
             tmask.data_ptr(), fmask.data_ptr(), mel.data_ptr(),
             mm.data_ptr(), b, n_frame, width)
    return mel, mm


def synthesize_se(n_frame: int, bgbank, bidx, boff, vbank, vidx, vshift, vw,
                  nbank=None, nidx=None, nshift=None, nw=None, vlens=None,
                  nlens=None, bgscale=None):
    """The se v9 targets' complex windows ``(full, only_noise,
    only_voice)``, each [B, n_frame, F] in the flat layout: float32 for
    float32 banks, bfloat16 for bfloat16 and int8 banks. Each equals the
    :func:`synthesize_flat` call of :func:`se_triple_args` bit for bit.
    Arguments and checks as :func:`synthesize_magnitude`. Runs
    :func:`synthesize_se_plain` on the CPU and one ``synth_se_*`` launch
    on CUDA, which reads the background window and each clip once."""
    return _launch('se', n_frame, bgbank, bidx, boff, vbank, vidx, vshift,
                   vw, nbank, nidx, nshift, nw, vlens, nlens, bgscale)
