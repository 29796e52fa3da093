"""Mixture synthesis (counterpart: ``challenge_tpu/ops/pallas_synth.py``,
its magnitude and flat-complex modes).

``synthesize_magnitude`` and ``synthesize_flat`` are the wrappers of the
CUDA kernels in ``csrc/synth.cu``, which replace ``pallas_synth.py::_kernel``.
Per sample both take the background window, add each active voice clip and
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
  (B2): ``synth_flat_f32``, ``synth_flat_bf16`` and ``synth_flat_int8``.

See the source for the kernels' bound and design. ``*_plain`` compute the
same ordered sum with separate PyTorch ops. The wrappers use them only for
tensors on the CPU; for CUDA tensors they launch a kernel or raise.
"""

from __future__ import annotations

import ctypes

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
MAX_SLOTS = 32      # voice + noise slots per sample the kernel takes


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


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _check(name, x, dtype, shape=None, device=None):
    if x.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {x.dtype}')
    if device is not None and x.device != device:
        raise ValueError(f'{name}: on {x.device}, expected {device}')
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(x.shape)}, expected {shape}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')


def _launch(flat: bool, n_frame: int, bgbank, bidx, boff,
            vbank, vidx, vshift, vw, nbank, nidx, nshift, nw, vlens, nlens,
            bgscale):
    """Check the arguments, then run the plain version on the CPU or launch
    the magnitude (``flat=False``) or flat-complex kernel on CUDA."""
    plain = synthesize_flat_plain if flat else synthesize_magnitude_plain
    what = plain.__name__[:-len('_plain')]
    device, dtype = bgbank.device, bgbank.dtype
    if dtype not in KERNELS:
        raise TypeError(f'bank dtype {dtype}: expected one of '
                        f'{sorted(str(d) for d in KERNELS)}')
    if (bgscale is not None) != (dtype == torch.int8):
        raise ValueError('bgscale is required iff the banks are int8')
    if device.type == 'cpu':
        return plain(n_frame, bgbank, bidx, boff, vbank, vidx, vshift, vw,
                     nbank, nidx, nshift, nw, vlens, nlens, bgscale)
    if device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {device}')

    name = FLAT_KERNELS[dtype] if flat else KERNELS[dtype][0]
    b, width = bidx.shape[0], bgbank.shape[-1]
    if width % 2:
        raise ValueError(f'flat width {width} must be even (re | im halves)')
    _check('bgbank', bgbank, dtype, device=device)
    if bgbank.ndim != 3:
        raise ValueError(f'bgbank: expected [N, rows, F], got {bgbank.shape}')
    _check('bidx', bidx, torch.int32, (b,), device)
    _check('boff', boff, torch.int32, (b,), device)
    if bgscale is not None:
        _check('bgscale', bgscale, torch.float32, (b,), device)
    srcs = _sources(vbank, vidx, vshift, vw, nbank, nidx, nshift, nw,
                    vlens, nlens)
    args = []
    n_slots = 0
    for name_, (bank, idx, shift, w, lens) in zip(('voice', 'noise'), srcs):
        k = idx.shape[1]
        n_slots += k
        _check(f'{name_} bank', bank, dtype, device=device)
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

    out = torch.empty((b, n_frame, width if flat else width // 2),
                      dtype=KERNELS[dtype][1], device=device)
    fn = getattr(cuda.load('synth'), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(bgbank.data_ptr(), bidx.data_ptr(), boff.data_ptr(),
                 bgbank.shape[1] * width, *args,
                 None if bgscale is None else bgscale.data_ptr(),
                 out.data_ptr(), b, n_frame, width, stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')
    cuda.LAUNCHES[name] += 1
    return out


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
    return _launch(False, n_frame, bgbank, bidx, boff, vbank, vidx, vshift,
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
    return _launch(True, n_frame, bgbank, bidx, boff, vbank, vidx, vshift,
                   vw, nbank, nidx, nshift, nw, vlens, nlens, bgscale)
