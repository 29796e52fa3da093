"""The density trainer's EfficientNet (IRIS-AUDIO/challenge ``trainer.py``:
an EfficientNetB{model} of Tan & Le, arXiv:1905.11946, ``weights=None``,
then Dense n_classes and a relu) as a plain float32 module.

The backbone: a 3x3 stride-2 stem, the seven stages of MBConv blocks
(expand 1x1, depthwise k x k, squeeze-excite to max(1, f_in / 4), project
1x1), widths and repeats scaled by the variant's coefficients, a 1x1 head
conv; swish throughout. Strided convs pad as TF's 'SAME' (more at the
end). Stochastic depth drops a residual branch per sample, kept with
probability 1 - rate and scaled by 1 / (1 - rate), the rate 0.2 * b /
(blocks) for block b; each block draws its [B] uniforms from the
generator it is given, in block order. Input [B, n_mels, n_frame, n_chan],
output [B, n_frame / 32, n_classes]. State-dict names are the measured
program's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.layers import BatchNorm

SCALING = {0: (1.0, 1.0), 1: (1.0, 1.1), 2: (1.1, 1.2), 3: (1.2, 1.4),
           4: (1.4, 1.8), 5: (1.6, 2.2), 6: (1.8, 2.6), 7: (2.0, 3.1)}
# kernel, repeats, filters_in, filters_out, expand_ratio, strides
BLOCK_ARGS = ((3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2),
              (5, 2, 24, 40, 6, 2), (3, 3, 40, 80, 6, 2),
              (5, 3, 80, 112, 6, 1), (5, 4, 112, 192, 6, 2),
              (3, 1, 192, 320, 6, 1))
DROP_CONNECT_RATE = 0.2


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * filters else new)


def same_pads(n: int, k: int, s: int):
    p = max((-(-n // s) - 1) * s + k - n, 0)
    return p // 2, p - p // 2


class ConvSame(nn.Conv2d):
    def __init__(self, in_ch, out_ch, k, stride=1, groups=1):
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
    def __init__(self, kernel, f_in, f_out, expand_ratio, stride, drop_rate):
        super().__init__()
        filters = f_in * expand_ratio
        se = max(1, int(f_in * 0.25))
        self.expand = expand_ratio != 1
        convs = [nn.Conv2d(f_in, filters, 1, bias=False)] if self.expand \
            else []
        self.convs = nn.ModuleList(convs + [
            ConvSame(filters, filters, kernel, stride, groups=filters),
            nn.Conv2d(filters, se, 1), nn.Conv2d(se, filters, 1),
            nn.Conv2d(filters, f_out, 1, bias=False)])
        self.bns = nn.ModuleList(
            BatchNorm(c) for c in [filters] * (1 + self.expand) + [f_out])
        self.residual = stride == 1 and f_in == f_out
        self.drop_rate = drop_rate if self.residual else 0.0

    def forward(self, x, gen):
        inputs = x
        convs, bns = iter(self.convs), iter(self.bns)
        if self.expand:
            x = F.silu(next(bns)(next(convs)(x)))
        x = F.silu(next(bns)(next(convs)(x)))
        se = F.silu(next(convs)(x.mean(dim=(2, 3), keepdim=True)))
        x = x * torch.sigmoid(next(convs)(se))
        x = next(bns)(next(convs)(x))
        if not self.residual:
            return x
        if self.drop_rate > 0 and self.training:
            keep = 1.0 - self.drop_rate
            u = torch.rand((x.shape[0], 1, 1, 1), generator=gen,
                           device=x.device)
            x = torch.where(u < keep, x / keep, 0.0)
        return x + inputs


class Backbone(nn.Module):
    def __init__(self, model: int, in_ch: int):
        super().__init__()
        width, depth = SCALING[model]
        stem = round_filters(32, width)
        self.stem = ConvSame(in_ch, stem, 3, 2)
        self.stem_bn = BatchNorm(stem)
        total = sum(int(math.ceil(depth * r)) for _, r, *_ in BLOCK_ARGS)
        blocks = []
        for kernel, repeats, f_in, f_out, expand, stride in BLOCK_ARGS:
            f_in, f_out = round_filters(f_in, width), round_filters(f_out,
                                                                    width)
            for j in range(int(math.ceil(depth * repeats))):
                blocks.append(MBConv(
                    kernel, f_in if j == 0 else f_out, f_out, expand,
                    stride if j == 0 else 1,
                    DROP_CONNECT_RATE * len(blocks) / total))
        self.blocks = nn.ModuleList(blocks)
        self.features = round_filters(1280, width)
        self.head = nn.Conv2d(f_out, self.features, 1, bias=False)
        self.head_bn = BatchNorm(self.features)

    def forward(self, x, gen):
        x = F.silu(self.stem_bn(self.stem(x)))
        for block in self.blocks:
            x = block(x, gen)
        return F.silu(self.head_bn(self.head(x)))


class DensityEffNet(nn.Module):
    def __init__(self, model: int, n_mels: int, n_chan: int,
                 n_classes: int):
        super().__init__()
        self.backbone = Backbone(model, n_chan)
        mel_out = n_mels
        for _ in range(5):
            mel_out = -(-mel_out // 2)
        self.denses = nn.ModuleList(
            [nn.Linear(mel_out * self.backbone.features, n_classes)])

    def forward(self, x, gen=None):
        out = self.backbone(x.permute(0, 3, 1, 2), gen)   # [B, C, mel', T']
        out = out.permute(0, 3, 2, 1)
        out = out.reshape(out.shape[0], out.shape[1], -1)
        return F.relu(self.denses[0](out))


def build(config: dict) -> nn.Module:
    m = config['model']
    if m.get('n_layers', 0) != 0:
        raise ValueError('the density reference has no gated stack '
                         '(n_layers 0)')
    return DensityEffNet(m['model'], m['n_mels'], m['n_chan'],
                         m['n_classes'])
