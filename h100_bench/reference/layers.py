"""Layers shared by the reference models, float32, NCHW for convolutions
and [B, T, D] for the dense head.

Keras semantics, as the measured models state them: BatchNorm with
momentum 0.99 and eps 1e-3 that normalizes with the biased variance
``E[x^2] - E[x]^2`` (clipped at 0) and keeps that same value as its running
variance; conv and Dense layers that feed a BatchNorm carry no bias; 'SAME'
2x2/2 max pooling pads an odd size at its end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """BatchNormalization over every axis but ``feature_dim``."""

    def __init__(self, features: int, feature_dim: int = 1,
                 momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.feature_dim = feature_dim
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        dim = self.feature_dim % x.ndim
        axes = tuple(i for i in range(x.ndim) if i != dim)
        shape = [1] * x.ndim
        shape[dim] = x.shape[dim]
        if self.training:
            mean = x.mean(dim=axes)
            var = ((x * x).mean(dim=axes) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)


class ConvMPBlock(nn.Module):
    """num_convs x (3x3 'SAME' conv, BN, ReLU), then 'SAME' 2x2/2 max
    pooling."""

    def __init__(self, in_ch: int, fsize: int, num_convs: int):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(in_ch if i == 0 else fsize, fsize, 3, padding=1,
                      bias=False) for i in range(num_convs))
        self.bns = nn.ModuleList(BatchNorm(fsize) for _ in range(num_convs))

    def forward(self, x):
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)))
        return F.max_pool2d(x, 2, 2, ceil_mode=True)


class FullyConnectedLayer(nn.Module):
    """Dense, [BN], activation on [B, T, D]."""

    def __init__(self, in_features: int, nodes: int, act=F.relu,
                 use_bn: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_features, nodes, bias=not use_bn)
        self.bn = BatchNorm(nodes, feature_dim=-1) if use_bn else None
        self.act = act

    def forward(self, x):
        x = self.dense(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


def avg_pool_same(x, window: int, stride: int):
    """Keras 'SAME' average pooling over the time axis of [B, T, C]: edge
    windows divide by their count of frames inside the input."""
    t = x.shape[1]
    n_out = -(-t // stride)
    pad = max((n_out - 1) * stride + window - t, 0)
    lo, hi = pad // 2, pad - pad // 2
    summed = F.pad(x.transpose(1, 2), (lo, hi)).unfold(-1, window, stride)
    ones = F.pad(x.new_ones((1, 1, t)), (lo, hi)).unfold(-1, window, stride)
    return (summed.sum(-1) / ones.sum(-1)).transpose(1, 2)


def max_pool_same(x, pool: int):
    """Keras MaxPooling1D(pool, 1, 'same') over the time axis of [N, T, C]:
    ``(pool - 1) // 2`` frames of -inf before, the rest after."""
    lo = (pool - 1) // 2
    xp = F.pad(x.transpose(-1, -2), (lo, pool - 1 - lo),
               value=float('-inf'))
    return F.max_pool1d(xp, pool, 1).transpose(-1, -2)
