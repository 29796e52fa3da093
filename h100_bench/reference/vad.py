"""vad v8, the VGG-style CRNN of IRIS-AUDIO/challenge ``sj_train.py``
(``define_keras_model``, v8: base filters 48), as a plain float32 module.

Input [B, n_mels, n_frame, n_chan]; five ConvMPBlocks of 2, 3, 3, 3 and 3
convs with widths base * 2**i; the time-major flatten [B, T', mel' * C]
(C fastest); a time-distributed Dense of ``td_dim`` with ReLU; FC 256,
128 and 64 with BN and ReLU; Dense n_classes with a sigmoid. The state
dict's names are the measured program's, so one drawn state dict loads
into both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.layers import ConvMPBlock, FullyConnectedLayer


class VAD(nn.Module):
    def __init__(self, base_fsize: int, td_dim: int, n_mels: int,
                 n_chan: int, n_classes: int):
        super().__init__()
        widths = [base_fsize * 2 ** i for i in range(5)]
        self.blocks = nn.ModuleList(
            ConvMPBlock(n_chan if i == 0 else widths[i - 1], widths[i],
                        2 if i == 0 else 3) for i in range(5))
        mel_out = n_mels
        for _ in range(5):
            mel_out = -(-mel_out // 2)
        self.td = nn.Linear(mel_out * widths[-1], td_dim)
        self.fcs = nn.ModuleList([
            FullyConnectedLayer(td_dim, 256), FullyConnectedLayer(256, 128),
            FullyConnectedLayer(128, 64),
            FullyConnectedLayer(64, n_classes, act=torch.sigmoid,
                                use_bn=False)])

    def forward(self, x, gen=None):
        x = x.permute(0, 3, 1, 2)                    # [B, C, mels, T]
        for block in self.blocks:
            x = block(x)
        x = x.permute(0, 3, 2, 1)                    # [B, T', mel', C]
        x = F.relu(self.td(x.reshape(x.shape[0], x.shape[1], -1)))
        for fc in self.fcs:
            x = fc(x)
        return x


def build(config: dict) -> nn.Module:
    m = config['model']
    if m['v'] != 8:
        raise ValueError(f"the vad reference is v8, not v{m['v']}")
    return VAD(m['base_fsize'], m['td_dim'], m['n_mels'], m['n_chan'],
               m['n_classes'])
