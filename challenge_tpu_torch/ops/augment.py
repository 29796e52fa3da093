"""SpecAugment masks, the random shift, the random channel merge and the
STFT filter (counterpart: ``challenge_tpu/ops/augment.py``; reference:
transforms.py:12-47, data_utils.py:58-61, 100-136).

Random draws take an explicit ``torch.Generator`` where JAX takes a key;
they follow JAX's distributions, not its bits. The draws are apart from
their use: :func:`batch_mask_keep` and :func:`merge_factors` return the
masks and merge factors, :func:`random_merge_aug` and
:func:`stft_filter_keep` take or make them, so a caller can pass in values
drawn elsewhere. JAX's draw-and-apply functions are built on these:
:func:`mask`, :func:`random_shift`, :func:`batch_mask`,
:func:`batch_specaugment`, :func:`specaugment`,
:func:`batch_random_merge_aug` and :func:`stft_filter`. The batched ones
draw in ``FeatureFn``'s order (time masks, then frequency masks), so
composed on the same generator they give its batch.
"""

from __future__ import annotations

import torch


def batch_mask_keep(gen: torch.Generator, b: int, total: int,
                    max_mask_size: int, n_mask: int = 1):
    """Per-sample keep masks [B, total] (float32 {0,1}) of ``n_mask`` random
    spans: size ~ U{0..max_mask_size-1}, offset ~ floor(u * (total - size))."""
    device = gen.device
    sizes = torch.randint(0, max_mask_size, (b, n_mask), generator=gen,
                          device=device, dtype=torch.int32)
    u = torch.rand((b, n_mask), generator=gen, device=device)
    offsets = torch.floor(u * (total - sizes).float()).to(torch.int32)
    idx = torch.arange(total, device=device)[None, None, :]
    keep = (idx < offsets[..., None]) | (idx >= (offsets + sizes)[..., None])
    return keep.float().amin(dim=1)


def merge_factors(gen: torch.Generator, b: int, number: int):
    """Per-sample channel-merge factors [B, number - 2], float32 U(0.1, 0.9)
    (augment.py:132-133; one independent draw per sample, as
    ``batch_random_merge_aug`` draws them)."""
    u = torch.rand((b, number - 2), generator=gen, device=gen.device)
    return 0.1 + 0.8 * u


def merge_factors_from_seed(seeds, number: int):
    """Channel-merge factors [N, number - 2], float32 in [0.1, 0.9), as a
    function of int seeds [N]: each (seed, column) pair is hashed in int64
    tensor ops (two xor-shift-multiply rounds of a 32-bit integer hash) and
    its top 24 bits scaled into the range. Eval's n_chan > 3 map takes the
    factors of clip ``i`` from seed ``i``, on the per-clip path, on the
    batched one and in the exported eval program alike (``torch.export``
    traces these ops; a ``torch.Generator`` it cannot). The stream is not
    JAX's (ROADMAP C6)."""
    seeds = torch.as_tensor(seeds).to(torch.int64)
    col = torch.arange(number - 2, device=seeds.device)
    x = (seeds[:, None] * 256 + col + 0x9E3779B9) & 0xFFFFFFFF
    for _ in range(2):
        x = (((x >> 16) ^ x) * 0x45D9F3B) & 0xFFFFFFFF
    x = (x >> 16) ^ x
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return 0.1 + 0.8 * u


def random_merge_aug(x, factor):
    """2 -> ``2 + factor.shape[-1]`` channels on the complex planes
    ``[re0, re1, im0, im1]`` of the last axis (augment.py:122-145;
    reference: data_utils.py:100-117): each new real plane is
    ``f * re0 + sqrt(1 - f) * re1``, each new imaginary plane ``im0 + im1``,
    without the factor (a reference quirk). ``factor`` broadcasts against
    ``x[..., :1]`` on its leading axes; the result takes the promoted dtype
    of ``x`` and ``factor``, as in JAX, and the imaginary sums are taken in
    ``x``'s dtype."""
    if x.shape[-1] // 2 != 2:
        raise ValueError('This augment can be used in 2 channel audio')
    dt = torch.promote_types(x.dtype, factor.dtype)
    re, im = x[..., :2], x[..., 2:]
    aug_re = factor * re[..., :1] + torch.sqrt(1 - factor) * re[..., 1:]
    aug_im = (im[..., :1] + im[..., 1:]).expand(aug_re.shape)
    return torch.cat([re.to(dt), aug_re.to(dt), im.to(dt), aug_im.to(dt)],
                     dim=-1)


def stft_filter_keep(freq: int, filter_num: int, device=None):
    """{0,1} float32 [freq]: 0 on the STFT rows 1..filter_num, the crude
    high-pass that keeps DC (augment.py:160-178; reference:
    data_utils.py:126-136)."""
    idx = torch.arange(freq, device=device)
    return ((idx < 1) | (idx >= filter_num + 1)).float()


# ------------------------------------------------- draw-and-apply (JAX API)
def _axis_view(mask, ndim: int, axis: int, batched: bool):
    """``mask`` ([total] or [B, total]) shaped to broadcast along ``axis``
    of a rank-``ndim`` tensor (and its batch axis 0)."""
    shape = [1] * ndim
    if batched:
        shape[0] = mask.shape[0]
    shape[axis] = mask.shape[-1]
    return mask.reshape(shape)


def mask(gen: torch.Generator, specs, axis: int, max_mask_size=None,
         n_mask: int = 1):
    """Zero ``n_mask`` random spans along ``axis`` of ``specs``, the same
    spans for the whole tensor (counterpart: ``mask``, augment.py:30-51;
    reference: transforms.py:12-40): per span, size ~ U{0..max_mask_size-1}
    and offset ~ floor(u * (total - size))."""
    axis = axis % specs.ndim
    total = specs.shape[axis]
    keep = batch_mask_keep(gen, 1, total, total if max_mask_size is None
                           else max_mask_size, n_mask)[0]
    return specs * _axis_view(keep.to(specs.dtype), specs.ndim, axis, False)


def random_shift(gen: torch.Generator, specs, axis: int = 0,
                 width: int = 16):
    """Shift ``specs`` along ``axis`` by a uniform s in [-width, width],
    zero-filled: out[j] = specs[j + s] (counterpart: ``random_shift``,
    augment.py:54-64; reference: transforms.py:43-47)."""
    shift = torch.randint(0, 2 * width + 1, (), generator=gen,
                          device=gen.device) - width
    axis = axis % specs.ndim
    n = specs.shape[axis]
    idx = torch.arange(n, device=specs.device) + shift.to(specs.device)
    valid = (idx >= 0) & (idx < n)
    out = specs.index_select(axis, idx.clamp(0, n - 1))
    return out * _axis_view(valid.to(specs.dtype), specs.ndim, axis, False)


def batch_mask(gen: torch.Generator, specs, axis: int, max_mask_size: int,
               n_mask: int = 1):
    """Per-sample random spans along ``axis`` of ``specs`` [B, ...] zeroed,
    the masks of :func:`batch_mask_keep` (counterpart: ``batch_mask``,
    augment.py:83-100)."""
    axis = axis % specs.ndim
    keep = batch_mask_keep(gen, specs.shape[0], specs.shape[axis],
                           max_mask_size, n_mask)
    return specs * _axis_view(keep.to(specs.dtype), specs.ndim, axis, True)


def batch_specaugment(gen: torch.Generator, specs, time_axis: int = -2,
                      freq_axis: int = -3):
    """Per-sample time masks (6 of up to 24 frames), then one frequency
    mask (up to 16 rows) (counterpart: ``batch_specaugment``,
    augment.py:103-109; reference: data_utils.py:58-61)."""
    specs = batch_mask(gen, specs, time_axis, max_mask_size=24, n_mask=6)
    return batch_mask(gen, specs, freq_axis, max_mask_size=16, n_mask=1)


def specaugment(gen: torch.Generator, specs, labels=None,
                time_axis: int = -2, freq_axis: int = -3):
    """:func:`batch_specaugment`'s masks, one set for the whole tensor
    (counterpart: ``specaugment``, augment.py:112-122)."""
    specs = mask(gen, specs, time_axis, max_mask_size=24, n_mask=6)
    specs = mask(gen, specs, freq_axis, max_mask_size=16, n_mask=1)
    return specs if labels is None else (specs, labels)


def batch_random_merge_aug(number: int):
    """``(gen, x [B, ..., 4]) -> [B, ..., 2 + number]``: the channel merge
    with one independent factor draw a sample (counterpart:
    ``batch_random_merge_aug``, augment.py:148-157)."""
    def _batch(gen: torch.Generator, x):
        factor = merge_factors(gen, x.shape[0], number)
        return random_merge_aug(
            x, factor.reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (-1,)))
    return _batch


def stft_filter(filter_num: int, freq_axis=None):
    """``(x[, y]) -> x[, y]`` with the STFT rows 1..filter_num zeroed
    (counterpart: ``stft_filter``, augment.py:160-178); ``freq_axis``
    defaults to the reference layout (0 unbatched, -3 batched)."""
    def _stft_filter(x, y=None):
        axis = (freq_axis % x.ndim if freq_axis is not None
                else (0 if x.ndim == 3 else x.ndim - 3))
        keep = stft_filter_keep(x.shape[axis], filter_num, x.device)
        x = x * _axis_view(keep.to(x.dtype), x.ndim, axis, False)
        return x if y is None else (x, y)
    return _stft_filter
