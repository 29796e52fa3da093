"""Batched SpecAugment masks, the random channel merge and the STFT filter
(counterpart: ``challenge_tpu/ops/augment.py`` ``batch_mask_keep``,
``random_merge_aug``, ``stft_filter``; reference: transforms.py:12-40,
data_utils.py:100-136).

Random draws take an explicit ``torch.Generator``; they follow JAX's
distributions, not its bits. The masks and merge factors are returned
rather than applied (JAX's ``batch_mask`` and ``random_merge_aug`` draw and
apply in one call), so a caller can also pass in values drawn elsewhere.
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
