"""EfficientNet-SED family (counterpart: ``challenge_tpu/models/effnet.py``;
reference: sj_train.py:340-401).

An EfficientNetB{0..7} backbone (Tan & Le, 2019: a stem conv, 7 stages of
MBConv blocks with squeeze-excite, width and depth scaled per variant, a
1x1 head conv), trained from scratch as the reference's
``weights=None`` does, then a time-major head per version:
  v1: 5 ConvTranspose1d (2, stride 2) back to the input's frame rate;
  v3: bare (the labels are downsampled 32 times);
  v5: a learned map over time to n_frame * 256 // 16000 frames, BN, ReLU
      and a BiGRU;
  v6: a BiGRU and FC 256, 128, 64 with BN;
  v7: a BiGRU gated by tanh(Conv1D) over the raw input's mel axis;
then Dense n_classes and a sigmoid. v2 and v4 are deprecated. The
density trainer's head (``head='density'``, reference: trainer.py:222-236)
has no version: after the gated stack, Dense n_classes and a relu.

The public input layout is JAX's, [B, n_mels, n_frame, n_chan]; the
module permutes to NCHW inside. Kept deviation, as in JAX: no Keras
``Rescaling(1/255)`` front layer (the inputs are log-mel features, and
with ``weights=None`` the first conv absorbs the fixed affine map).

Convolutions pad as TF's 'SAME' does: a strided one pads
``(p // 2, p - p // 2)`` with ``p = max((ceil(n / s) - 1) s + k - n, 0)``,
so more at the end on even sizes. Stochastic depth drops whole samples of
a residual branch, each kept with probability 1 - rate and scaled by
1 / (1 - rate), as flax's ``Dropout(broadcast_dims=(1, 2, 3))``; its
masks come from the ``torch.Generator`` that the training forward is
given. torch cannot draw JAX's stream, so the parity tests give both
packages JAX's masks (``MBConv.keep_mask``).

The state_dict follows flax's variables: ``backbone.blocks.k`` is
``MBConv_k`` with its ``Conv_j`` and ``BatchNorm_j`` as ``convs.j`` and
``bns.j`` (j shifts by one when the block has no expand conv); the head's
top-level ``Dense_i`` and ``BatchNorm_i`` are ``denses.i`` and ``bns.i``,
numbered in flax's order of creation (the gated stack, then v5's BN and
the classifier last).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from challenge_tpu_torch.models.layers import (
    BatchNorm, BiGRU, Conv1d, Conv2d, ConvTranspose1d, FullyConnectedLayer,
    Linear, kernel_fan_in, lecun_normal_, remat_draw, set_compute_dtype)

# (width_coefficient, depth_coefficient) per variant B0..B7
SCALING = {
    0: (1.0, 1.0), 1: (1.0, 1.1), 2: (1.1, 1.2), 3: (1.2, 1.4),
    4: (1.4, 1.8), 5: (1.6, 2.2), 6: (1.8, 2.6), 7: (2.0, 3.1),
}

# kernel, repeats, filters_in, filters_out, expand_ratio, strides
BLOCK_ARGS = (
    (3, 1, 32, 16, 1, 1),
    (3, 2, 16, 24, 6, 2),
    (5, 2, 24, 40, 6, 2),
    (3, 3, 40, 80, 6, 2),
    (5, 3, 80, 112, 6, 1),
    (5, 4, 112, 192, 6, 2),
    (3, 1, 192, 320, 6, 1),
)
VERSIONS = (1, 3, 5, 6, 7)
DROP_CONNECT_RATE = 0.2        # stochastic depth of the last block


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def same_pads(n: int, k: int, s: int):
    """TF 'SAME' padding of one axis of length n: (before, after)."""
    p = max((-(-n // s) - 1) * s + k - n, 0)
    return p // 2, p - p // 2


class Conv2dSame(Conv2d):
    """A bias-free square conv with TF 'SAME' padding: stride 1 with an
    odd kernel pads k // 2 on each side inside the conv; a strided one is
    padded by hand from its input's size."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(in_ch, out_ch, k, stride,
                         padding=k // 2 if stride == 1 else 0,
                         groups=groups, bias=False)

    def forward(self, x):
        if self.stride[0] > 1:
            k, s = self.kernel_size[0], self.stride[0]
            x = F.pad(x, same_pads(x.shape[-1], k, s)
                      + same_pads(x.shape[-2], k, s))
        return super().forward(x)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite (counterpart:
    ``effnet.py:62-105``) on NCHW: [expand 1x1, BN, swish], depthwise
    k x k, BN, swish, squeeze-excite (mean over H and W, 1x1 conv with
    bias down to max(1, int(f_in / 4)), swish, 1x1 conv with bias back,
    sigmoid, multiply), project 1x1 and BN; with stride 1 and f_in ==
    f_out, stochastic depth and the residual add."""

    def __init__(self, kernel: int, f_in: int, f_out: int, expand_ratio: int,
                 stride: int, drop_rate: float = 0.0):
        super().__init__()
        filters = f_in * expand_ratio
        se = max(1, int(f_in * 0.25))
        self.expand = expand_ratio != 1
        convs = [Conv2d(f_in, filters, 1, bias=False)] if self.expand \
            else []
        self.convs = nn.ModuleList(convs + [
            Conv2dSame(filters, filters, kernel, stride, groups=filters),
            Conv2d(filters, se, 1), Conv2d(se, filters, 1),
            Conv2d(filters, f_out, 1, bias=False)])
        self.bns = nn.ModuleList(
            BatchNorm(c) for c in [filters] * (1 + self.expand) + [f_out])
        self.residual = stride == 1 and f_in == f_out
        self.drop_rate = drop_rate if self.residual else 0.0

    def keep_mask(self, x, gen: torch.Generator):
        """[B, 1, 1, 1] bool: each sample's branch kept with probability
        1 - rate, drawn from ``gen`` (flax: ``bernoulli(key, 1 - rate)``,
        a uniform below 1 - rate), in float32 at least, whatever the
        activations' dtype."""
        u = torch.rand((x.shape[0], 1, 1, 1), generator=gen, device=x.device,
                       dtype=torch.promote_types(x.dtype, torch.float32))
        return u < 1.0 - self.drop_rate

    def forward(self, x, gen: Optional[torch.Generator] = None):
        inputs = x
        convs, bns = iter(self.convs), iter(self.bns)
        if self.expand:
            x = F.silu(next(bns)(next(convs)(x)))
        x = F.silu(next(bns)(next(convs)(x)))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = F.silu(next(convs)(se))
        x = x * torch.sigmoid(next(convs)(se))
        x = next(bns)(next(convs)(x))
        if not self.residual:
            return x
        if self.drop_rate > 0 and self.training:
            keep = 1.0 - self.drop_rate
            mask = remat_draw(lambda: self.keep_mask(x, gen))
            x = torch.where(mask, x / keep, 0.0)
        return x + inputs


class EfficientNetBackbone(nn.Module):
    """EfficientNetB{model} without its top (counterpart:
    ``effnet.py:108-142``): NCHW [B, n_chan, H, W] -> [B,
    round_filters(1280), H / 32, W / 32] (each halving rounds up). Block b
    of all the stages' blocks drops at rate 0.2 * b / (the count of
    blocks)."""

    def __init__(self, model: int = 0, in_ch: int = 2):
        super().__init__()
        width, depth = SCALING[model]
        stem = round_filters(32, width)
        self.stem = Conv2dSame(in_ch, stem, 3, 2)
        self.stem_bn = BatchNorm(stem)
        total = sum(round_repeats(r, depth) for _, r, *_ in BLOCK_ARGS)
        blocks = []
        for kernel, repeats, f_in, f_out, expand, stride in BLOCK_ARGS:
            f_in = round_filters(f_in, width)
            f_out = round_filters(f_out, width)
            for j in range(round_repeats(repeats, depth)):
                blocks.append(MBConv(
                    kernel, f_in if j == 0 else f_out, f_out, expand,
                    stride if j == 0 else 1,
                    drop_rate=DROP_CONNECT_RATE * len(blocks) / total))
        self.blocks = nn.ModuleList(blocks)
        self.features = round_filters(1280, width)
        self.head = Conv2d(f_out, self.features, 1, bias=False)
        self.head_bn = BatchNorm(self.features)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x = F.silu(self.stem_bn(self.stem(x)))
        for block in self.blocks:
            x = block(x, gen)
        return F.silu(self.head_bn(self.head(x)))


class TimeAxisResample(nn.Module):
    """A learned linear map over the time axis, per feature (counterpart:
    ``effnet.py:145-154``; reference: sj_train.py:379, ``Conv1D(target, 1,
    data_format='channels_first')``): [B, T, D] -> [B, target, D] with a
    [T, target] weight. It has no compute dtype, as in JAX: a bfloat16
    input and the float32 weight promote to float32 (effnet.py:145-157),
    and the BatchNorm after it casts back."""

    def __init__(self, t_in: int, target: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(t_in, target))

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return torch.einsum('btd,tn->bnd', x.to(dt), self.weight.to(dt))


class EffNetSED(nn.Module):
    """The EfficientNet SED model (counterpart: ``effnet.py:157-220``).
    n_frame, n_mels and n_chan fix the head's widths, which flax infers
    at init. ``forward(x, gen)``: a training forward needs ``gen``, the
    generator of stochastic depth, as JAX's needs a dropout key.
    ``head='density'`` ignores ``v`` (JAX builds it with v=0) and ends in a
    relu; its Dense stays the last of ``denses``, flax's
    ``Dense_{n_layers}``. ``dtype`` is the compute dtype of every layer
    (``layers.set_compute_dtype``); the output is float32.

    With a bfloat16 ``dtype``, as flax's ``dtype=`` does: the input is
    cast at entry, v7's gate reads the cast input (effnet.py:209-213),
    the BiGRU returns its float32 carry, so v6's FC stack and v7's gated
    product start from float32, and v5's time map promotes to float32
    before its BatchNorm."""

    compute_dtype = None

    def __init__(self, model: int = 0, v: int = 1, n_classes: int = 3,
                 n_layers: int = 0, n_dim: int = 256, n_frame: int = 512,
                 n_mels: int = 80, n_chan: int = 2, head: str = 'sed',
                 dtype=None):
        super().__init__()
        if head not in ('sed', 'density'):
            raise ValueError(f'unknown head {head!r}')
        if head == 'density':
            v = 0                  # no version branch below takes it
        elif v in (2, 4):
            raise ValueError(f'version {v} is deprecated')
        elif v not in VERSIONS:
            raise ValueError('wrong version')
        self.density = head == 'density'
        self.n_chan = n_chan
        self.backbone = EfficientNetBackbone(model, n_chan)
        mel_out, t_out = n_mels, n_frame
        for _ in range(5):
            mel_out, t_out = -(-mel_out // 2), -(-t_out // 2)
        d = mel_out * self.backbone.features
        denses, bns = [], []
        for _ in range(n_layers):             # the gated stack
            denses.append(Linear(d, n_dim))
            bns.append(BatchNorm(n_dim, feature_dim=-1))
            d = n_dim
        self.ups = self.resample = self.gru = self.fcs = self.gate = None
        if v == 1:
            widths = (d, 128, 64, 32, 16, 3)
            self.ups = nn.ModuleList(ConvTranspose1d(a, b, 2, stride=2)
                                     for a, b in zip(widths, widths[1:]))
            d = 3
        elif v == 5:
            target = n_frame * 256 // 16000
            if t_out != target:
                self.resample = TimeAxisResample(t_out, target)
                bns.append(BatchNorm(d, feature_dim=-1))
        elif v == 7:
            # over the raw input's mel axis, channels frame * n_chan + chan
            self.gate = Conv1d(n_frame * n_chan, 256, 16, stride=5)
        if v in (5, 6, 7):
            self.gru = BiGRU(d, 128)
            d = 256
        if v == 6:
            self.fcs = nn.ModuleList(FullyConnectedLayer(a, b) for a, b in
                                     ((256, 256), (256, 128), (128, 64)))
            d = 64
        denses.append(Linear(d, n_classes))
        self.denses = nn.ModuleList(denses)
        self.bns = nn.ModuleList(bns)
        set_compute_dtype(self, dtype)

    def reset_parameters(self, gen: torch.Generator = None) -> None:
        """Re-draw every weight from ``gen`` (flax's default initializers:
        LeCun normal kernels, zero biases, BN scale 1 and bias 0, the GRU's
        recurrent kernels orthogonal)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_parameters()
                continue
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
                lecun_normal_(m.weight, kernel_fan_in(m), gen)
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, gen)
            elif isinstance(m, TimeAxisResample):
                lecun_normal_(m.weight, m.weight.shape[0], gen)
            if getattr(m, 'bias', None) is not None:
                nn.init.zeros_(m.bias)
        if self.gru is not None:
            self.gru.reset_parameters(gen)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        if self.training and gen is None:
            raise ValueError('a training forward of the eff family needs a '
                             'dropout generator (gen=)')
        if x.shape[-1] != self.n_chan:
            raise ValueError(f'input has {x.shape[-1]} channels, the model '
                             f'takes {self.n_chan}')
        # compute in compute_dtype or the weights' dtype; the output is
        # float32 like JAX's
        x = x.to(self.compute_dtype or self.denses[-1].weight.dtype)
        out = self.backbone(x.permute(0, 3, 1, 2), gen)  # [B, C, mel', T']
        # time-major [B, T', mel' * C], C fastest, as JAX's flatten
        out = out.permute(0, 3, 2, 1)
        out = out.reshape(out.shape[0], out.shape[1], -1)
        bns = iter(self.bns)
        for dense in self.denses[:-1]:
            out = next(bns)(dense(out))
            out = torch.sigmoid(out) * out
        if self.ups is not None:
            out = out.transpose(1, 2)
            for up in self.ups:
                out = F.relu(up(out))
            out = out.transpose(1, 2)
        if self.resample is not None:
            out = F.relu(next(bns)(self.resample(out)))
        if self.gru is not None:
            out = self.gru(out)
        for fc in self.fcs or ():
            out = fc(out)
        if self.gate is not None:
            big = x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)
            big = F.pad(big, same_pads(big.shape[-1], 16, 5))
            out = out * torch.tanh(self.gate(big)).transpose(1, 2)
        out = self.denses[-1](out)
        return (F.relu(out) if self.density else torch.sigmoid(out)).float()
