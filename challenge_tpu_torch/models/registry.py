"""``get_model(config)`` (counterpart: ``challenge_tpu/models/registry.py``;
reference: sj_train.py:295-403). The vad and se families are ported; the
EfficientNet-SED family waits for ROADMAP A12."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.models.senet import SECascade
from challenge_tpu_torch.models.vad import VADModel


@dataclass
class ModelBundle:
    module: nn.Module
    input_shape: Tuple[int, ...]      # per example, no batch dim
    config: Config
    device: torch.device
    multi_output: bool = False        # True for the se triple head

    def init(self, seed: int = 0) -> None:
        """Re-draw the module's weights from ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.module.reset_parameters(gen)

    def trainable_mask(self) -> List[bool]:
        """One flag per tensor of ``module.parameters()``: the se cascade's
        freeze flow (reference: sj_train.py:306, 316-318; counterpart:
        registry.py:71-86) trains the U-Net (``se.*``) in pretrain and the
        head (``vad.*``) in finetune; every other model trains all."""
        names = [n for n, _ in self.module.named_parameters()]
        if self.config.model_type != 'se':
            return [True] * len(names)
        pretrain = bool(self.config.pretrain)
        return [n.startswith('se.') == pretrain for n in names]


def get_model(config: Config, device=None, seed: int = 0) -> ModelBundle:
    """Build the model family of ``config.model_type`` on ``device``
    (default ``cuda``), weights drawn from ``seed``."""
    device = resolve_device(device)
    if getattr(config, 'compute_dtype', 'float32') != 'float32':
        raise NotImplementedError(
            f'compute_dtype={config.compute_dtype} is not ported yet '
            '(ROADMAP A14)')
    if config.model_type == 'vad':
        module = VADModel(
            v=config.v, n_classes=config.n_classes,
            base_fsize=48 if config.v == 8 else 32,
            n_mels=config.n_mels, n_chan=config.n_chan).to(device)
        bundle = ModelBundle(module, (config.n_mels, config.n_frame,
                                      config.n_chan), config, device)
        bundle.init(seed)
        return bundle
    if config.model_type == 'eff':
        raise NotImplementedError(
            'the EfficientNet-SED family is not ported yet (ROADMAP A12)')
    if config.model_type == 'se':
        if config.v != 9:
            # SECascade builds for any v, but only v9 has a loss in the
            # JAX package (losses.py:117-119) and an eval branch
            raise ValueError(f'se v{config.v} cannot train or evaluate: '
                             'only se v9 has a loss and an eval branch')
        module = SECascade(n_classes=config.n_classes,
                           pretrain=bool(config.pretrain)).to(device)
        # input: the speech_enhancement_preprocess layout, 256 freq rows
        bundle = ModelBundle(module, (256, config.n_frame, config.n_chan),
                             config, device, multi_output=True)
        bundle.init(seed)
        return bundle
    raise ValueError(f'unknown model_type: {config.model_type!r}')
