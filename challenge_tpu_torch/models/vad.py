"""VAD CRNN model family (counterpart: ``challenge_tpu/models/vad.py``;
reference: sj_train.py:214-255, ``define_keras_model``).

A VGG-style CNN over [B, n_mels, n_frame, n_chan] log-mel inputs, then a
time-major MLP head. The public input layout is JAX's; the module permutes
to NCHW inside. The versions without extra layers (v1-v5 and v8, which only
widens the base filters to 48) are built, and every version as the se
cascade's head (``vad_variant=False``), which has none of the extra layers;
the vad family's v6, v7 and v9 add layers that are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from challenge_tpu_torch.models.layers import (
    ConvMPBlock, FullyConnectedLayer, lecun_normal_)

_NOT_PORTED = {6: 'v6 smoothing pools', 7: 'v7 bottleneck',
               9: 'v9 BiLSTM head'}


class VADModel(nn.Module):
    """``define_keras_model`` parity. ``vad_variant`` is True for the vad
    family and False for the head of the se cascade, which skips the
    version-specific layers; ``final_act`` is 'sigmoid' for the vad family
    and 'relu' for that head (reference: sj_train.py:254).

    n_mels and n_chan fix the head's input width, which flax infers at
    init."""

    def __init__(self, v: int = 1, n_classes: int = 3, base_fsize: int = 32,
                 td_dim: int = 1024, n_mels: int = 80, n_chan: int = 2,
                 vad_variant: bool = True, final_act: str = 'sigmoid'):
        super().__init__()
        if vad_variant and v in _NOT_PORTED:
            raise NotImplementedError(
                f'VADModel {_NOT_PORTED[v]} is not ported yet (ROADMAP A10)')
        self.v = v
        widths = [base_fsize * 2 ** i for i in range(5)]
        self.blocks = nn.ModuleList(
            ConvMPBlock(n_chan if i == 0 else widths[i - 1], widths[i],
                        num_convs=2 if i == 0 else 3)
            for i in range(5))
        mel_out = n_mels
        for _ in range(5):
            mel_out = -(-mel_out // 2)
        self.td = nn.Linear(mel_out * widths[-1], td_dim)   # TimeDistributed
        self.fcs = nn.ModuleList([
            FullyConnectedLayer(td_dim, 256),
            FullyConnectedLayer(256, 128),
            FullyConnectedLayer(128, 64),
            FullyConnectedLayer(
                64, n_classes, use_bn=False,
                act=torch.sigmoid if final_act == 'sigmoid' else F.relu),
        ])

    def reset_parameters(self, gen: torch.Generator = None) -> None:
        """Re-draw every weight from ``gen`` (flax's default initializers)."""
        for block in self.blocks:
            block.reset_parameters(gen)
        lecun_normal_(self.td.weight, self.td.in_features, gen)
        nn.init.zeros_(self.td.bias)
        for fc in self.fcs:
            fc.reset_parameters(gen)

    def forward(self, x):
        # compute in the weights' dtype; the output is float32 like JAX's
        x = x.to(self.td.weight.dtype).permute(0, 3, 1, 2)  # [B, C, mels, T]
        for block in self.blocks:
            x = block(x)
        # [B, C, mel', T'] -> time-major [B, T', mel'*C], C fastest like
        # the JAX [B, mel', T', C] -> [B, T', mel', C] flatten
        x = x.permute(0, 3, 2, 1)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = F.relu(self.td(x))
        for fc in self.fcs:
            x = fc(x)
        return x.float()
