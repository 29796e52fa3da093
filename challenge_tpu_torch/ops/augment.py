"""Batched SpecAugment masks (counterpart: ``challenge_tpu/ops/augment.py``
``batch_mask_keep``; reference: transforms.py:12-40).

Random draws take an explicit ``torch.Generator``; they follow JAX's
distributions, not its bits. The masks are returned rather than applied
(JAX's ``batch_mask`` applies them), so a caller can also pass in masks
drawn elsewhere.
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
