"""Shared model building blocks (counterpart: ``challenge_tpu/models/layers.py``).

Layouts are PyTorch's: convolutions and their BatchNorms take NCHW, the
head's Dense layers and BatchNorms take [B, T, D]. Keras parity:

* BatchNorm has Keras' momentum 0.99 and eps 1e-3 and, like flax with
  ``use_fast_variance=True``, normalizes with the biased
  ``E[x^2] - E[x]^2`` (clipped at 0) and stores that same biased value in
  the running variance; ``nn.BatchNorm2d`` would store the unbiased one.
* A conv or Dense layer that feeds a BatchNorm has no bias.
* 'SAME' 2x2/2 max pooling pads odd sizes at the end with -inf
  (``ceil_mode=True``): 5 -> 3.
* Weights start from flax's defaults: LeCun normal (truncated) kernels,
  zero biases, BN scale 1 and bias 0, running mean 0 and variance 1; the
  LSTM's recurrent kernels orthogonal.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  gen: Optional[torch.Generator] = None) -> None:
    """flax's ``lecun_normal``: truncated normal (+-2 std) with variance
    1/fan_in after truncation, drawn as ``jax.random.truncated_normal``
    draws it: a uniform over [erf(-sqrt 2), erf(sqrt 2)] through
    ``sqrt(2) * erfinv``, clipped to the bounds. (torch's ``trunc_normal_``
    samples the same law by rejection, which is slower on the CPU.)"""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    edge = math.erf(math.sqrt(2.0))
    with torch.no_grad():
        weight.uniform_(-edge, edge, generator=gen).erfinv_()
        weight.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)


def kernel_fan_in(layer: nn.Module) -> int:
    """flax's LeCun fan-in of a conv or transposed-conv layer's kernel,
    in * kh * kw (flax keeps both as [kh, kw, in, out]). torch keeps a
    transposed conv's weight as [in, out, kh, kw], where
    ``weight[0].numel()`` would be out * kh * kw."""
    w = layer.weight
    if isinstance(layer, nn.ConvTranspose2d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


class BatchNorm(nn.Module):
    """Keras-default BatchNormalization over every axis but ``feature_dim``."""

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

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

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
        y = x - mean.reshape(shape)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return y * mul.reshape(shape) + self.bias.reshape(shape)


class ConvMPBlock(nn.Module):
    """num_convs x (Conv3x3 'SAME' -> BN -> ReLU) -> MaxPool 2x2/2 'SAME'
    (reference: sj_train.py:191-201), NCHW."""

    def __init__(self, in_ch: int, fsize: int, num_convs: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(in_ch if i == 0 else fsize, fsize, 3, padding=1,
                      bias=False)
            for i in range(num_convs))
        self.bns = nn.ModuleList(BatchNorm(fsize) for _ in range(num_convs))

    def reset_parameters(self, gen=None) -> None:
        for conv, bn in zip(self.convs, self.bns):
            lecun_normal_(conv.weight, kernel_fan_in(conv), gen)
            bn.reset_parameters()

    def forward(self, x):
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)))
        return max_pool_same(x)


class FullyConnectedLayer(nn.Module):
    """Dense -> [BN] -> activation on [B, T, D] (reference: sj_train.py:204-211)."""

    def __init__(self, in_features: int, nodes: int, act=F.relu,
                 use_bn: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_features, nodes, bias=not use_bn)
        self.bn = BatchNorm(nodes, feature_dim=-1) if use_bn else None
        self.act = act

    def reset_parameters(self, gen=None) -> None:
        lecun_normal_(self.dense.weight, self.dense.in_features, gen)
        if self.dense.bias is not None:
            nn.init.zeros_(self.dense.bias)
        if self.bn is not None:
            self.bn.reset_parameters()

    def forward(self, x):
        x = self.dense(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class Bottleneck(nn.Module):
    """vad v7's 1-3-1 residual bottleneck on NCHW (counterpart:
    ``challenge_tpu/models/vad.py:50-66``; reference: sj_train.py:230-241):
    bias-free convs 1x1 (c -> c/4), 3x3 (c/4 -> c/4) and 1x1 (c/4 -> c),
    each followed by BN and ReLU, then the input added."""

    def __init__(self, ch: int):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(ch, ch // 4, 1, bias=False),
            nn.Conv2d(ch // 4, ch // 4, 3, padding=1, bias=False),
            nn.Conv2d(ch // 4, ch, 1, bias=False)])
        self.bns = nn.ModuleList(BatchNorm(c) for c in (ch // 4, ch // 4, ch))

    def reset_parameters(self, gen=None) -> None:
        for conv, bn in zip(self.convs, self.bns):
            lecun_normal_(conv.weight, kernel_fan_in(conv), gen)
            bn.reset_parameters()

    def forward(self, x):
        skip = x
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)))
        return x + skip


_GATES = ('i', 'f', 'g', 'o')


class LSTM(nn.Module):
    """One direction of flax's ``OptimizedLSTMCell`` scanned over time, on
    [B, T, D] (counterpart: ``nn.RNN(nn.OptimizedLSTMCell(H))``). Each gate
    keeps flax's own parameters: an input kernel without bias
    (``ii``, ``if``, ``ig``, ``io``: Linear D -> H) and a hidden kernel with
    one (``hi``, ``hf``, ``hg``, ``ho``: Linear H -> H). So there is one
    trained bias per gate, as in flax (torch's ``nn.LSTM`` has two, which
    both receive the bias's gradient), and AGC sees each gate's kernel and
    bias as its own tensor, as JAX's per-leaf clipping does. The gates run
    in (i, f, g, o) order: pre = (h W_h + b) + x W_i, sigmoid for i, f and
    o, tanh for g; c' = f c + i g, h' = o tanh(c'); the state starts at
    zero. ``reverse`` scans from the last frame and keeps the output in
    frame order (``reverse=True, keep_order=True``)."""

    def __init__(self, in_features: int, features: int,
                 reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.gates = nn.ModuleDict()
        for g in _GATES:
            self.gates['i' + g] = nn.Linear(in_features, features, bias=False)
        for g in _GATES:
            self.gates['h' + g] = nn.Linear(features, features)

    def reset_parameters(self, gen=None) -> None:
        for g in _GATES:
            lin = self.gates['i' + g]
            lecun_normal_(lin.weight, lin.in_features, gen)
            lin = self.gates['h' + g]
            nn.init.orthogonal_(lin.weight, generator=gen)
            nn.init.zeros_(lin.bias)

    def forward(self, x):
        w_i = torch.cat([self.gates['i' + g].weight for g in _GATES])
        w_h = torch.cat([self.gates['h' + g].weight for g in _GATES])
        b_h = torch.cat([self.gates['h' + g].bias for g in _GATES])
        xw = torch.matmul(x, w_i.T)                      # [B, T, 4H]
        h = x.new_zeros((x.shape[0], w_h.shape[1]))
        c = torch.zeros_like(h)
        steps = range(x.shape[1])
        outs = [None] * x.shape[1]
        for t in (reversed(steps) if self.reverse else steps):
            pre = (torch.matmul(h, w_h.T) + b_h) + xw[:, t]
            i, f, g, o = pre.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs[t] = h
        return torch.stack(outs, dim=1)


class BiLSTM(nn.Module):
    """Bidirectional LSTM, outputs concatenated [forward, backward]
    (counterpart: ``challenge_tpu/models/layers.py:105-116``; reference:
    sj_train.py:252). ``cells.0`` and ``cells.1`` are flax's
    ``OptimizedLSTMCell_0`` and ``_1``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.cells = nn.ModuleList([LSTM(in_features, features),
                                    LSTM(in_features, features, True)])

    def reset_parameters(self, gen=None) -> None:
        for cell in self.cells:
            cell.reset_parameters(gen)

    def forward(self, x):
        return torch.cat([cell(x) for cell in self.cells], dim=-1)


def smoothing_pool(x, k: int):
    """vad v6's smoothing over the time axis (the last) of NCHW (counterpart:
    ``challenge_tpu/models/vad.py:41-49``): an average pool of k frames and
    then a max pool of 2k frames, both with stride 1 and 'SAME' padding.
    An even window pads unevenly, (w - 1) // 2 frames before and the rest
    after; the average divides by the count of frames inside the input and
    the max pool pads with -inf."""
    t = x.shape[-1]
    lo = (k - 1) // 2
    summed = F.pad(x, (lo, k - 1 - lo)).unfold(-1, k, 1).sum(-1)
    counts = F.pad(x.new_ones(t), (lo, k - 1 - lo)).unfold(-1, k, 1).sum(-1)
    lo = (2 * k - 1) // 2
    x = F.pad(summed / counts, (lo, 2 * k - 1 - lo), value=float('-inf'))
    return F.max_pool2d(x, (1, 2 * k), 1)


def max_pool_same(x):
    """Keras 'SAME' 2x2/2 max pooling on NCHW."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def avg_pool_same(x, window: int, stride: int):
    """Keras 'SAME' AveragePooling1D over the time axis of [B, T, C]; edge
    windows divide by their in-bounds count, not the window size."""
    t = x.shape[1]
    n_out = -(-t // stride)
    pad = max((n_out - 1) * stride + window - t, 0)
    lo, hi = pad // 2, pad - pad // 2
    summed = F.pad(x.transpose(1, 2), (lo, hi)).unfold(-1, window, stride)
    ones = F.pad(x.new_ones((1, 1, t)), (lo, hi)).unfold(-1, window, stride)
    return (summed.sum(-1) / ones.sum(-1)).transpose(1, 2)
