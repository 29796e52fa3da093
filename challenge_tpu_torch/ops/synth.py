"""Mixture synthesis with the magnitude computed in the kernel
(counterpart: ``challenge_tpu/ops/pallas_synth.py``, magnitude mode).

``synthesize_magnitude`` is the wrapper of the CUDA kernel in
``csrc/synth.cu``, which replaces ``pallas_synth.py::_kernel`` in its
magnitude mode for float32 banks. Per sample it takes the background window,
adds each active voice clip and then each active noise clip, in slot order,
at its row shift, drops rows outside the window, and returns
``sqrt(re^2 + im^2)`` over the flat layout's column halves. The complex
window never reaches device memory. See the source for its bound and design.

``synthesize_magnitude_plain`` computes the same ordered sum with separate
PyTorch ops. The wrapper uses it only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from challenge_tpu_torch.ops import cuda

KERNEL = 'synth_mag_f32'
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


def synthesize_magnitude_plain(n_frame: int, bgbank, bidx, boff,
                               vbank, vidx, vshift, vw,
                               nbank=None, nidx=None, nshift=None, nw=None,
                               vlens=None, nlens=None):
    """The kernel's function as separate PyTorch ops: gather the background
    windows, then for each slot in order ``acc = acc + w * clip`` where the
    slot is active and its shifted rows cover the window row, then the
    magnitude. Returns [B, n_frame, F/2] float32."""
    t = torch.arange(n_frame, device=bgbank.device)
    acc = bgbank[bidx.long()[:, None], boff.long()[:, None] + t[None, :]]
    for bank, idx, shift, w, lens in _sources(
            vbank, vidx, vshift, vw, nbank, nidx, nshift, nw, vlens, nlens):
        rows = bank.shape[1]
        for k in range(idx.shape[1]):
            j = t[None, :] - shift[:, k, None].long()                 # [B, T]
            valid = ((j >= 0) & (j < lens[:, k, None].clamp(max=rows))
                     & (w[:, k, None] != 0))
            clip = bank[idx[:, k, None].long(), j.clamp(0, rows - 1)]  # [B,T,F]
            acc = torch.where(valid[..., None],
                              acc + w[:, k, None, None] * clip, acc)
    half = acc.shape[-1] // 2
    re, im = acc[..., :half], acc[..., half:]
    # the IEEE float32 root, as CUDA's sqrtf gives it: torch's float32 sqrt
    # on the CPU is 1 ulp off for some inputs; a float64 root rounded once
    # to float32 is exact
    return torch.sqrt((re * re + im * im).double()).float()


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
             + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _check(name, x, dtype, shape=None, device=None):
    if x.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {x.dtype}')
    if device is not None and x.device != device:
        raise ValueError(f'{name}: on {x.device}, expected {device}')
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(x.shape)}, expected {shape}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')


def synthesize_magnitude(n_frame: int, bgbank, bidx, boff,
                         vbank, vidx, vshift, vw,
                         nbank=None, nidx=None, nshift=None, nw=None,
                         vlens=None, nlens=None):
    """Synthesized magnitudes [B, n_frame, F/2] float32.

    bgbank/vbank/nbank: flat banks [N, rows, F] float32 (F = 4 * freq,
    channel-major). bidx/boff: [B] int32 background item and window start;
    the window rows ``boff .. boff + n_frame`` must lie inside the bank
    (``build_bank(..., wrap_frames=n_frame)`` guarantees it). vidx/vshift:
    [B, V] int32 clip item and row shift (clip row j lands on window row
    j + shift); vw: [B, V] float32 weights, 0 for an inactive slot; vlens:
    [B, V] int32 clip lengths (default: the bank's rows). Likewise for the
    optional noises. Same argument order as the JAX ``synthesize_windows``.
    """
    device = bgbank.device
    if device.type == 'cpu':
        return synthesize_magnitude_plain(
            n_frame, bgbank, bidx, boff, vbank, vidx, vshift, vw,
            nbank, nidx, nshift, nw, vlens, nlens)
    if device.type != 'cuda':
        raise ValueError(f'synthesize_magnitude: unsupported device {device}')

    b, width = bidx.shape[0], bgbank.shape[-1]
    if width % 2:
        raise ValueError(f'flat width {width} must be even (re | im halves)')
    _check('bgbank', bgbank, torch.float32, device=device)
    if bgbank.ndim != 3:
        raise ValueError(f'bgbank: expected [N, rows, F], got {bgbank.shape}')
    _check('bidx', bidx, torch.int32, (b,), device)
    _check('boff', boff, torch.int32, (b,), device)
    srcs = _sources(vbank, vidx, vshift, vw, nbank, nidx, nshift, nw,
                    vlens, nlens)
    args = []
    n_slots = 0
    for name, (bank, idx, shift, w, lens) in zip(('voice', 'noise'), srcs):
        k = idx.shape[1]
        n_slots += k
        _check(f'{name} bank', bank, torch.float32, device=device)
        if bank.ndim != 3 or bank.shape[-1] != width:
            raise ValueError(f'{name} bank: expected [N, rows, {width}], '
                             f'got {tuple(bank.shape)}')
        for what, x, dt in (('idx', idx, torch.int32),
                            ('shift', shift, torch.int32),
                            ('w', w, torch.float32),
                            ('lens', lens, torch.int32)):
            _check(f'{name} {what}', x, dt, (b, k), device)
        args += [bank.data_ptr(), idx.data_ptr(), shift.data_ptr(),
                 w.data_ptr(), lens.data_ptr(), k, bank.shape[1],
                 bank.shape[1] * width]
    if len(srcs) == 1:                      # no noise bank
        args += [None] * 5 + [0, 0, 0]
    if n_slots > MAX_SLOTS:
        raise ValueError(f'{n_slots} clip slots per sample; the kernel '
                         f'takes at most {MAX_SLOTS}')

    out = torch.empty((b, n_frame, width // 2), dtype=torch.float32,
                      device=device)
    fn = cuda.load('synth').synth_mag_f32
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(bgbank.data_ptr(), bidx.data_ptr(), boff.data_ptr(),
                 bgbank.shape[1] * width, *args, out.data_ptr(), b, n_frame,
                 width, stream)
    if err != 0:
        raise RuntimeError(f'{KERNEL} launch failed: CUDA error {err}')
    cuda.LAUNCHES[KERNEL] += 1
    return out
