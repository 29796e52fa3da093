"""se v9, the speech-enhancement U-Net cascade of IRIS-AUDIO/challenge
``sj_train.py`` (``--model_type se --v 9``: ConvSets and Upsampling
:258-292, the cascade and its freeze :299-339), as a plain float32 module.

Input [B, 256, n_frame, 2], the real half of the two channels with the DC
row dropped (``se_data.preprocess``). The U-Net (Ronneberger et al.,
arXiv:1505.04597) runs NCHW [B, 2, n_frame, 256]: four ConvSets (two 3x3
'SAME' convs, BN, ReLU each, then 2x2/2 max pooling) of 64, 128, 256 and
512 channels, then two decoders of their own weights (speech, noise), each
four Upsamplings (3x3 conv, BN, ReLU, 2x2/2 transposed conv with a bias)
of 256, 128, 64 and 2 channels, the last three after a skip
concatenation [encoder map, decoder map]. The head is the cascade's VAD
(the v8 reference's layers at base 32 filters, td 1024, 256 rows, 2
channels; the source builds the same head for every version), with a
ReLU output, since the source keys the sigmoid off ``model_type ==
'vad'`` (:254, 312-318). Output (class [B, n_frame / 32, n_classes],
speech, noise), the last two [B, 256, n_frame, 2].

Departures from the source, noted: the transposed conv is torch's
``conv_transpose2d`` on a weight [in, out, 2, 2]. The source's Keras
layer (and flax's, which the program's weights bridge follows) applies its
kernel [2, 2, in, out] unflipped, which is this weight flipped in both
spatial dims; a state dict drawn in torch's layout loads into the
program and this module alike, so both apply the same map. ``pretrain``
freezes the head: :meth:`SECascade.train` keeps its BatchNorms in
inference mode, as Keras' ``trainable = False`` does; the optimizer is
handed the U-Net's leaves only (``se_train``). The state dict's names are
the measured program's, so one drawn state dict loads into both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.layers import BatchNorm, ConvMPBlock
from h100_bench.reference.vad import VAD

WIDTHS = (64, 128, 256, 512)
# each decoder's Upsamplings as (input channels, channels)
DECODER = ((512, 256), (512, 128), (256, 64), (128, 2))
ROWS = 256                  # frequency rows of the input, DC dropped


class Upsampling(nn.Module):
    def __init__(self, in_ch: int, chan: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, chan, 3, padding=1, bias=False)
        self.bn = BatchNorm(chan)
        self.up = nn.ConvTranspose2d(chan, chan, 2, stride=2)

    def forward(self, x):
        return self.up(F.relu(self.bn(self.conv(x))))


class UNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.convsets = nn.ModuleList(
            ConvMPBlock(2 if i == 0 else WIDTHS[i - 1], w, 2)
            for i, w in enumerate(WIDTHS))
        self.ups = nn.ModuleList(Upsampling(i, o)
                                 for _ in range(2) for i, o in DECODER)

    def forward(self, x):
        skips = []
        for block in self.convsets:
            x = block(x)
            skips.append(x)
        inp1, inp2, inp3, latent = skips

        def decoder(ups):
            out = ups[0](latent)
            for up, skip in zip(ups[1:], (inp3, inp2, inp1)):
                out = up(torch.cat([skip, out], 1))
            return out
        return decoder(self.ups[:4]), decoder(self.ups[4:])


class SECascade(nn.Module):
    def __init__(self, n_classes: int, pretrain: bool):
        super().__init__()
        self.pretrain = pretrain
        self.se = UNet()
        self.vad = VAD(32, 1024, ROWS, 2, n_classes)
        self.vad.fcs[-1].act = F.relu

    def train(self, mode: bool = True) -> 'SECascade':
        super().train(mode)
        if mode:
            (self.vad if self.pretrain else self.se).train(False)
        return self

    def forward(self, x):
        speech, noise = self.se(x.permute(0, 3, 2, 1))   # [B, 2, T, 256]
        speech = speech.permute(0, 3, 2, 1)              # [B, 256, T, 2]
        return self.vad(speech), speech, noise.permute(0, 3, 2, 1)


def build(config: dict) -> nn.Module:
    m = config['model']
    if m['v'] != 9:
        raise ValueError(f"the se reference is v9, not v{m['v']}")
    return SECascade(m['n_classes'], config['train']['pretrain'])
