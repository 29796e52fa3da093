"""Speech-enhancement U-Net family (counterpart:
``challenge_tpu/models/senet.py``; reference: sj_train.py:258-339), NCHW.

``SpeechEnhancementModel``: a 4-level encoder (64 -> 512 channels) with two
skip-connected decoders of their own weights, giving (speech, noise)
estimates of the real-half spectrogram. ``SECascade`` runs a VAD head on
the enhanced speech and trains in two phases: pretrain trains the U-Net
with the head frozen, finetune the head with the U-Net frozen. The
frozen half's weights are held by the train step's gradient mask
(``ModelBundle.trainable_mask``); its BatchNorms run in inference mode,
which :meth:`SECascade.train` sets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from challenge_tpu_torch.models.layers import (
    BatchNorm, Conv2d, ConvMPBlock, ConvTranspose2d, kernel_fan_in,
    lecun_normal_, set_compute_dtype)
from challenge_tpu_torch.models.vad import VADModel

WIDTHS = (64, 128, 256, 512)
# each decoder's Upsampling stages as (input channels, channels)
DECODER = ((512, 256), (512, 128), (256, 64), (128, 2))


class Upsampling(nn.Module):
    """Conv3x3 -> BN -> ReLU -> 2x2/2 transposed conv with a bias
    (reference: sj_train.py:268-273).

    The last is flax's ``ConvTranspose((2, 2), strides=(2, 2),
    padding='SAME')``: each input pixel writes its own 2x2 output block,
    as ``nn.ConvTranspose2d(k=2, s=2)`` does, but flax
    (``transpose_kernel=False``) applies its kernel [kh, kw, in, out]
    unflipped, so torch's weight [in, out, kh, kw] is that kernel flipped
    in both spatial dims (the bridge in ``interop/jax_weights.py`` flips
    it). Its LeCun fan-in is flax's, kh * kw * in
    (``layers.kernel_fan_in``)."""

    def __init__(self, in_ch: int, chan: int):
        super().__init__()
        self.conv = Conv2d(in_ch, chan, 3, padding=1, bias=False)
        self.bn = BatchNorm(chan)
        self.up = ConvTranspose2d(chan, chan, 2, stride=2)

    def reset_parameters(self, gen=None) -> None:
        lecun_normal_(self.conv.weight, kernel_fan_in(self.conv), gen)
        self.bn.reset_parameters()
        lecun_normal_(self.up.weight, kernel_fan_in(self.up), gen)
        nn.init.zeros_(self.up.bias)

    def forward(self, x):
        return self.up(F.relu(self.bn(self.conv(x))))


class SpeechEnhancementModel(nn.Module):
    """U-Net over NCHW [B, 2, n_frame, 256] -> (speech, noise), each
    [B, 2, n_frame, 256] (reference: sj_train.py:276-292). The encoder's
    ConvSets (2 x (Conv3x3 + BN + ReLU) -> MaxPool 2x2, sj_train.py:258-265)
    are two-conv ``ConvMPBlock``s. ``ups[0:4]`` is the speech decoder and
    ``ups[4:8]`` the noise decoder, flax's ``Upsampling_0..7``."""

    def __init__(self):
        super().__init__()
        self.convsets = nn.ModuleList(
            ConvMPBlock(2 if i == 0 else WIDTHS[i - 1], w, num_convs=2)
            for i, w in enumerate(WIDTHS))
        self.ups = nn.ModuleList(Upsampling(i, o)
                                 for _ in range(2) for i, o in DECODER)

    def reset_parameters(self, gen=None) -> None:
        for m in (*self.convsets, *self.ups):
            m.reset_parameters(gen)

    def forward(self, x):
        inp1 = self.convsets[0](x)
        inp2 = self.convsets[1](inp1)
        inp3 = self.convsets[2](inp2)
        latent = self.convsets[3](inp3)

        def decoder(ups):
            out3 = ups[0](latent)
            out2 = ups[1](torch.cat([inp3, out3], 1))
            out1 = ups[2](torch.cat([inp2, out2], 1))
            return ups[3](torch.cat([inp1, out1], 1))
        return decoder(self.ups[:4]), decoder(self.ups[4:])


class SECascade(nn.Module):
    """The 'se' composite model (reference: sj_train.py:299-339).

    Input [B, 256, n_frame, 2], the speech_enhancement_preprocess layout
    (DC row dropped, real half of the two channels). Output (class
    [B, n_frame / 32, n_classes] from the ReLU head, speech [B, 256,
    n_frame, 2], noise [B, 256, n_frame, 2]), all float32. The head is the
    same for every version (``vad_variant=False``); only v9 trains.
    ``dtype`` is the compute dtype of both halves: the U-Net's outputs are
    cast to float32 (senet.py:110-111) and the head casts them again."""

    compute_dtype = None

    def __init__(self, n_classes: int = 3, pretrain: bool = False,
                 dtype=None):
        super().__init__()
        self.pretrain = pretrain
        self.se = SpeechEnhancementModel()
        # the head on the enhanced speech: n_mels := 256, n_chan := 2, and
        # a relu output, since the reference keys the sigmoid off
        # model_type == 'vad' (sj_train.py:254, 312-318)
        self.vad = VADModel(v=9, n_classes=n_classes, n_mels=256, n_chan=2,
                            vad_variant=False, final_act='relu')
        set_compute_dtype(self, dtype)

    def reset_parameters(self, gen=None) -> None:
        self.se.reset_parameters(gen)
        self.vad.reset_parameters(gen)

    def train(self, mode: bool = True) -> 'SECascade':
        """Keras' ``submodel.trainable = False`` (sj_train.py:306, 316-318)
        also puts the submodel's BatchNorms in inference mode: the frozen
        half (the head in pretrain, the U-Net in finetune) stays in eval
        mode, normalizing by its running statistics and leaving them as
        they are."""
        super().train(mode)
        if mode:
            (self.vad if self.pretrain else self.se).train(False)
        return self

    def forward(self, x):
        # bf16 spectra -> compute_dtype or the weights' dtype
        x = x.to(self.compute_dtype or self.vad.td.weight.dtype)
        speech, noise = self.se(x.permute(0, 3, 2, 1))   # [B, C, T, 256]
        speech = speech.permute(0, 3, 2, 1).float()      # [B, 256, T, 2]
        noise = noise.permute(0, 3, 2, 1).float()
        return self.vad(speech), speech, noise
