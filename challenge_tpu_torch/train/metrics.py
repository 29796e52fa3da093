"""Batch training metrics (counterpart: ``challenge_tpu/train/metrics.py``;
reference: metrics.py:217-298).

The challenge error rate is computed with fixed-shape cumulative ops, as in
the JAX package: an event end at frame e pairs with the latest start <= e (a
cummax); a prediction hits a true event iff some predicted-event midpoint
lies inside it (midpoints scattered onto a frame grid, then its cumsum
differenced); score = (n_true + n_pred - 2 * hits) / max(n_true, 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from challenge_tpu_torch.models.layers import avg_pool_same
from challenge_tpu_torch.ops.norms import safe_div


def _starts_ends(y):
    """Run starts/ends of a 0/1 sequence [B, T, C] (reference:
    metrics.py:229-246)."""
    prev = F.pad(y, (0, 0, 1, 0))[:, :-1]
    nxt = F.pad(y, (0, 0, 0, 1))[:, 1:]
    return (y - prev).clamp(0, 1), (y - nxt).clamp(0, 1)


def _last_start_index(starts):
    """Per (b, c): latest start frame <= t, or -1."""
    t_idx = torch.arange(starts.shape[1], device=starts.device)[None, :, None]
    marked = torch.where(starts > 0, t_idx, -1)
    return torch.cummax(marked, dim=1).values


def er_score(threshold: float = 0.5, smoothing: bool = True):
    """Batched challenge error rate [B] (reference: metrics.py:217-274).
    With ``smoothing`` the prediction is 0.5 s average-pooled with stride =
    pool size before thresholding, as the reference does."""
    def er(y_true, y_pred):
        y_true = (y_true >= threshold).float()
        if smoothing:
            k = int(0.5 * 16000) // 256
            y_pred = avg_pool_same(y_pred, k, k)
        y_pred = (y_pred >= threshold).float()

        t_starts, t_ends = _starts_ends(y_true)
        p_starts, p_ends = _starts_ends(y_pred)
        n_true = t_starts.sum(dim=(1, 2))
        n_pred = p_starts.sum(dim=(1, 2))

        b, tp, c = y_pred.shape
        p_ls = _last_start_index(p_starts)
        t_idx = torch.arange(tp, device=y_pred.device)[None, :, None]
        mid = torch.div(p_ls + t_idx, 2, rounding_mode='floor').clamp(0, tp - 1)
        mid_grid = torch.zeros_like(y_pred).scatter_add_(1, mid, p_ends)
        cum = torch.cumsum(mid_grid, dim=1)

        tt = y_true.shape[1]
        t_ls = _last_start_index(t_starts)                     # [B, Tt, C]
        e_idx = torch.arange(tt, device=y_true.device)[None, :, None]
        hi = e_idx.expand(t_ls.shape).clamp(0, tp - 1)
        lo = (t_ls - 1).clamp(0, tp - 1)
        upper = torch.gather(cum, 1, hi)
        lower = torch.where(t_ls > 0, torch.gather(cum, 1, lo), 0.0)
        # out-of-range true windows (start beyond pred length) count zero
        lower = torch.where(t_ls <= tp - 1, lower, upper)
        hit = ((upper - lower) >= 1.0).float() * t_ends
        correct = hit.sum(dim=(1, 2))
        score = n_true + n_pred - 2.0 * correct
        return score / n_true.clamp(1.0, max(float(tt), 1.0) * c)
    return er


def cos_sim(y_true, y_pred):
    """Masked negative cosine similarity over time [B] (reference:
    metrics.py:277-287): classes with no positive frames are masked out,
    the mask normalized to unit sum per sample."""
    mask = (y_true.sum(dim=-2) > 0.).float()                   # [B, C]
    mask = safe_div(mask, mask.sum(dim=-1, keepdim=True))

    def l2n(x):
        return x * torch.rsqrt(
            torch.clamp(x.square().sum(dim=-2, keepdim=True), min=1e-12))
    cos = -(l2n(y_true) * l2n(y_pred)).sum(dim=-2)             # [B, C]
    return (cos * mask).sum(dim=-1)


def f1_counts(y_true, y_pred, threshold: float = 0.5):
    """Micro-F1 sufficient statistics (tp, fp, fn) of one batch (reference:
    metrics.py:290-298); accumulate them and finish with f1_from_counts."""
    pred = (y_pred > threshold).float()
    true = (y_true >= 0.5).float()
    return torch.stack([(pred * true).sum(), (pred * (1 - true)).sum(),
                        ((1 - pred) * true).sum()])


def f1_from_counts(counts):
    tp, fp, fn = counts
    return 2 * tp / max(2 * tp + fp + fn, 1e-12)


def batch_metrics(config):
    """The per-batch metric dict of the reference's compile(metrics=...)
    (sj_train.py:454-457): cos_sim and the F1 counts, plus er unless
    v == 5; the density family (v == 0) has cos_sim only."""
    fns = {'cos_sim': lambda y, p: cos_sim(y, p).mean()}
    if config.v == 0:
        return fns
    fns['f1_counts'] = f1_counts
    if config.v != 5:
        er = er_score(smoothing=False)
        fns['er'] = lambda y, p: er(y, p).mean()
    return fns
