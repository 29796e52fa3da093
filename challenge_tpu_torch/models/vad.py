"""VAD CRNN model family (counterpart: ``challenge_tpu/models/vad.py``;
reference: sj_train.py:214-255, ``define_keras_model``).

A VGG-style CNN over [B, n_mels, n_frame, n_chan] log-mel inputs, then a
time-major MLP head. The public input layout is JAX's; the module permutes
to NCHW inside. Every version is built, and every version as the se
cascade's head (``vad_variant=False``), which has none of the extra layers:
  v6: smoothing pools (average, then max, over time) before ConvMPBlocks
      1-4 (reference: sj_train.py:225-229);
  v7: a 1-3-1 residual bottleneck before ConvMPBlocks 1-4 (230-241);
  v8: wider base filters, 48 instead of 32, set by ``get_model`` (216-217);
  v9: FC 512 before FC 256 and a BiLSTM of 128 before FC 64 (247-252).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from challenge_tpu_torch.models.layers import (
    BiLSTM, Bottleneck, ConvMPBlock, FullyConnectedLayer, Linear,
    lecun_normal_, set_compute_dtype, smoothing_pool)

SMOOTH_SECONDS = 0.5                 # v6's pools (reference: sj_train.py:226)


class VADModel(nn.Module):
    """``define_keras_model`` parity. ``vad_variant`` is True for the vad
    family and False for the head of the se cascade, which skips the
    version-specific layers; ``final_act`` is 'sigmoid' for the vad family
    and 'relu' for that head (reference: sj_train.py:254).

    n_mels and n_chan fix the head's and the first conv's input widths,
    which flax infers at init. The state_dict follows flax's variables:
    ``blocks.i`` is ``ConvMPBlock_i``, ``fcs.i`` is
    ``FullyConnectedLayer_i``, ``bottlenecks`` are v7's top-level
    ``Conv_*`` and ``BatchNorm_*`` in threes, ``lstm`` is ``BiLSTM_0``.

    ``dtype`` is the compute dtype of every layer
    (``layers.set_compute_dtype``): the input is cast to it at entry
    (vad.py:37) and the output is float32 (vad.py:84); v9's BiLSTM returns
    its float32 carry, which FC 64 casts again."""

    compute_dtype = None

    def __init__(self, v: int = 1, n_classes: int = 3, base_fsize: int = 32,
                 td_dim: int = 1024, n_mels: int = 80, n_chan: int = 2,
                 vad_variant: bool = True, final_act: str = 'sigmoid',
                 dtype=None):
        super().__init__()
        self.v = v
        self.n_chan = n_chan
        self.smooth = vad_variant and v == 6
        widths = [base_fsize * 2 ** i for i in range(5)]
        self.blocks = nn.ModuleList(
            ConvMPBlock(n_chan if i == 0 else widths[i - 1], widths[i],
                        num_convs=2 if i == 0 else 3)
            for i in range(5))
        self.bottlenecks = nn.ModuleList(
            Bottleneck(c) for c in widths[:4]) if vad_variant and v == 7 \
            else None
        mel_out = n_mels
        for _ in range(5):
            mel_out = -(-mel_out // 2)
        self.td = Linear(mel_out * widths[-1], td_dim)   # TimeDistributed
        v9 = vad_variant and v == 9
        nodes = [td_dim] + ([512] if v9 else []) + [256, 128]
        # the BiLSTM runs after FC 128 (fcs[lstm_after]) and doubles it
        self.lstm_after = len(nodes) - 2 if v9 else None
        self.lstm = BiLSTM(128, 128) if v9 else None
        self.fcs = nn.ModuleList(
            [FullyConnectedLayer(a, b) for a, b in zip(nodes, nodes[1:])]
            + [FullyConnectedLayer(256 if v9 else 128, 64),
               FullyConnectedLayer(
                   64, n_classes, use_bn=False,
                   act=torch.sigmoid if final_act == 'sigmoid' else F.relu)])
        set_compute_dtype(self, dtype)

    def reset_parameters(self, gen: torch.Generator = None) -> None:
        """Re-draw every weight from ``gen`` (flax's default initializers)."""
        for block in self.blocks:
            block.reset_parameters(gen)
        for bottleneck in self.bottlenecks or ():
            bottleneck.reset_parameters(gen)
        lecun_normal_(self.td.weight, self.td.in_features, gen)
        nn.init.zeros_(self.td.bias)
        for fc in self.fcs:
            fc.reset_parameters(gen)
        if self.lstm is not None:
            self.lstm.reset_parameters(gen)

    def forward(self, x):
        if x.shape[-1] != self.n_chan:
            quirk = (' (with n_chan 1 the training features keep 2 channels: '
                     "the reference's mono_chan adds the complex planes as "
                     "[..., :1] + [..., 1:], and the JAX package's first "
                     'step fails the same way)' if self.n_chan == 1 else '')
            raise ValueError(f'input has {x.shape[-1]} channels, the model '
                             f'takes {self.n_chan}{quirk}')
        # compute in compute_dtype or the weights' dtype; the output is
        # float32 like JAX's
        x = x.to(self.compute_dtype or self.td.weight.dtype)
        x = x.permute(0, 3, 1, 2)                           # [B, C, mels, T]
        for i, block in enumerate(self.blocks):
            if i > 0 and self.smooth:
                # kernel from the current time width (reference: 225-229)
                t = x.shape[-1]
                k = int(round(SMOOTH_SECONDS / (256 * (t * 2 ** i) / 16000
                                                / t)))
                x = smoothing_pool(x, max(k, 1))
            if i > 0 and self.bottlenecks is not None:
                x = self.bottlenecks[i - 1](x)
            x = block(x)
        # [B, C, mel', T'] -> time-major [B, T', mel'*C], C fastest like
        # the JAX [B, mel', T', C] -> [B, T', mel', C] flatten
        x = x.permute(0, 3, 2, 1)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = F.relu(self.td(x))
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i == self.lstm_after:
                x = self.lstm(x)
        return x.float()
