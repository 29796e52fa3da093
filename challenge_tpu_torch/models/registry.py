"""``get_model(config)`` (counterpart: ``challenge_tpu/models/registry.py``;
reference: sj_train.py:295-403). Only the vad family is ported so far."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.models.vad import VADModel


@dataclass
class ModelBundle:
    module: nn.Module
    input_shape: Tuple[int, ...]      # per example, no batch dim
    config: Config
    device: torch.device

    def init(self, seed: int = 0) -> None:
        """Re-draw the module's weights from ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.module.reset_parameters(gen)


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
        raise NotImplementedError(
            'the se family is not ported yet (ROADMAP A11)')
    raise ValueError(f'unknown model_type: {config.model_type!r}')
