"""Training losses (counterpart: ``challenge_tpu/train/losses.py``;
reference: utils.py:291-347, sj_train.py:447-461, trainer.py:144-189):
the class losses of ``--loss`` (BCE, focal, MSE, MAE), the se v9
composite with any of them as its class loss, and the density trainer's
count + total-variation loss. |x| is :func:`_abs` throughout, whose
gradient at 0 is JAX's (ROADMAP C10)."""

from __future__ import annotations

import torch

from challenge_tpu_torch.ops.norms import safe_div

KERAS_EPS = 1e-7   # Keras backend.epsilon(): probability clip for log losses


def _abs(x):
    """|x| with JAX's gradient, 1 at x = 0 (``select(x >= 0, g, -g)``)
    where torch's ``abs`` gives 0. The density loss meets x = 0 wherever a
    relu output and its label are both 0."""
    return torch.where(x >= 0, x, -x)


def _cross_entropy(y_true, y_pred):
    """Elementwise BCE of the prediction clipped to [eps, 1 - eps]."""
    p = torch.clamp(y_pred, KERAS_EPS, 1.0 - KERAS_EPS)
    return -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))


def binary_crossentropy(y_true, y_pred):
    """Keras BinaryCrossentropy(): elementwise BCE, mean over everything."""
    return _cross_entropy(y_true, y_pred).mean()


def sigmoid_focal_crossentropy(y_true, y_pred, alpha: float = 0.25,
                               gamma: float = 2.0):
    """Focal loss (counterpart: ``losses.py:28-40``; reference:
    utils.py:291-347): the clipped BCE weighted by alpha for positives
    (1 - alpha for negatives) and by (1 - p_t)^gamma, p_t the unclipped
    probability of the true label; summed over classes, then the mean
    over time and batch."""
    p_t = y_true * y_pred + (1.0 - y_true) * (1.0 - y_pred)
    alpha_factor = y_true * alpha + (1.0 - y_true) * (1.0 - alpha)
    modulating = torch.pow(1.0 - p_t, gamma)
    per_sample = (alpha_factor * modulating
                  * _cross_entropy(y_true, y_pred)).sum(dim=-1).mean(dim=-1)
    return per_sample.mean()


def mse(y_true, y_pred):
    """Mean squared error over everything."""
    return (y_true - y_pred).square().mean()


def mae(y_true, y_pred):
    """Keras MAE: mean |err| over the last axis, then over everything. The
    two broadcast as the JAX package's arrays do: the se targets
    [B, 256, T, 1] against the outputs [B, 256, T, 2]."""
    return _abs(y_true - y_pred).mean()


CLASS_LOSSES = {'BCE': binary_crossentropy,
                'FOCAL': sigmoid_focal_crossentropy, 'MSE': mse, 'MAE': mae}
SE_LOSS_WEIGHTS = (1.0, 10.0, 10.0)    # class, speech, noise


def make_se_loss(cls_loss):
    """The se v9 composite loss: [cls_loss(class), MAE(speech),
    MAE(noise)] weighted [1, 10, 10] (reference: sj_train.py:451-452,
    461), as ``(y_true, y_pred) -> (total, parts)``, the parts under the
    per-head log names."""
    def _loss(y_true, y_pred):
        parts = {
            'class_loss': cls_loss(y_true[0], y_pred[0]),
            'speech_loss': mae(y_true[1], y_pred[1]),
            'noise_loss': mae(y_true[2], y_pred[2]),
        }
        total = sum(w * v for w, v in zip(SE_LOSS_WEIGHTS, parts.values()))
        return total, parts
    return _loss


se_loss = make_se_loss(binary_crossentropy)    # the default --loss BCE


def density_loss(alpha: float = 0.8, l2: float = 1.0):
    """The density trainer's count + total-variation loss (counterpart:
    ``losses.py:66-101``; reference: trainer.py:144-189) as ``(y_true,
    y_pred) -> scalar``. The last axis of [B, T, C] is 3 classes of C / 3
    degrees each (30 = 3 x 10; 3 = 3 x 1). The count term is the MAE of
    the time sums of the degree and class marginals, weighted alpha and
    1 - alpha; the TV term the L1 distance of their time-normalised
    profiles, each weighted by its true mass, times ``l2``; the mean over
    the batch."""
    def _loss(y_true, y_pred):
        t_true = y_true.reshape(y_true.shape[:-1] + (3, -1))  # [B, T, 3, C/3]
        t_pred = y_pred.reshape(y_pred.shape[:-1] + (3, -1))
        loss = 0.0
        tv = 0.0
        for w, axis in ((alpha, -2), (1 - alpha, -1)):  # degrees, classes
            true, pred = t_true.sum(dim=axis), t_pred.sum(dim=axis)
            s_true, s_pred = true.sum(dim=1), pred.sum(dim=1)
            loss = loss + w * _abs(s_true - s_pred).mean(dim=-1)
            n_true = safe_div(true, s_true[:, None])
            n_pred = safe_div(pred, s_pred[:, None])
            tv = tv + w * (_abs(n_true - n_pred).sum(dim=1)
                           * s_true).mean(dim=1)
        return (loss + l2 * tv).mean()
    return _loss


def get_loss(config):
    """Loss selection (reference: sj_train.py:447-452): ``(y, p) -> (loss,
    parts)``; an unknown name raises ``ValueError``, as in JAX. MSE and MAE
    train on labels times ``mse_multiplier`` (``data/pipeline.py``)."""
    base = CLASS_LOSSES.get(config.loss.upper())
    if base is None:
        raise ValueError(f'unknown loss: {config.loss!r}')
    if config.model_type == 'se' and config.v == 9:
        return make_se_loss(base)
    return lambda t, p: (base(t, p), {})
