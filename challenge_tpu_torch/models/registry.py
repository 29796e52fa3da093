"""``get_model(config)`` (counterpart: ``challenge_tpu/models/registry.py``;
reference: sj_train.py:295-403): the vad, EfficientNet-SED (eff) and se
families; ``get_density_model(config)``, the density trainer's
EfficientNet (reference: trainer.py:222-236)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.models.effnet import EffNetSED
from challenge_tpu_torch.models.senet import SECascade
from challenge_tpu_torch.models.vad import VADModel


@dataclass
class ModelBundle:
    module: nn.Module
    input_shape: Tuple[int, ...]      # per example, no batch dim
    config: Config
    device: torch.device
    multi_output: bool = False        # True for the se triple head
    # True for the eff family: its training forward takes the generator
    # of stochastic depth (JAX: needs_dropout_rng)
    needs_dropout_gen: bool = False

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


def _dtype(config: Config):
    """The compute dtype of ``config.compute_dtype`` (counterpart:
    ``registry.py:89-91``): bfloat16 for 'bfloat16' or 'bf16', else
    ``None``, the weights' own float32."""
    name = getattr(config, 'compute_dtype', 'float32')
    return torch.bfloat16 if str(name) in ('bfloat16', 'bf16') else None


def _eff_bundle(config: Config, device, seed: int, model: int,
                head: str) -> ModelBundle:
    module = EffNetSED(
        model=model, v=config.v, n_classes=config.n_classes,
        n_layers=config.n_layers, n_dim=config.n_dim,
        n_frame=config.n_frame, n_mels=config.n_mels,
        n_chan=config.n_chan, head=head, dtype=_dtype(config)).to(device)
    bundle = ModelBundle(module, (config.n_mels, config.n_frame,
                                  config.n_chan), config, device,
                         needs_dropout_gen=True)
    bundle.init(seed)
    return bundle


def get_model(config: Config, device=None, seed: int = 0) -> ModelBundle:
    """Build the model family of ``config.model_type`` on ``device``
    (default ``cuda``), weights drawn from ``seed``, float32 weights
    computing in ``config.compute_dtype``."""
    device = resolve_device(device)
    if config.model_type == 'vad':
        module = VADModel(
            v=config.v, n_classes=config.n_classes,
            base_fsize=48 if config.v == 8 else 32,
            n_mels=config.n_mels, n_chan=config.n_chan,
            dtype=_dtype(config)).to(device)
        bundle = ModelBundle(module, (config.n_mels, config.n_frame,
                                      config.n_chan), config, device)
        bundle.init(seed)
        return bundle
    if config.model_type == 'eff':
        return _eff_bundle(config, device, seed, config.model, 'sed')
    if config.model_type == 'se':
        if config.v != 9:
            # SECascade builds for any v, but only v9 has a loss in the
            # JAX package (losses.py:117-119) and an eval branch
            raise ValueError(f'se v{config.v} cannot train or evaluate: '
                             'only se v9 has a loss and an eval branch')
        module = SECascade(n_classes=config.n_classes,
                           pretrain=bool(config.pretrain),
                           dtype=_dtype(config)).to(device)
        # input: the speech_enhancement_preprocess layout, 256 freq rows
        bundle = ModelBundle(module, (256, config.n_frame, config.n_chan),
                             config, device, multi_output=True)
        bundle.init(seed)
        return bundle
    raise ValueError(f'unknown model_type: {config.model_type!r}')


def parse_model_id(model) -> int:
    """The EfficientNet B-number of ``model``: an int, or a name such as
    'EfficientNetB4' (reference: trainer.py:18; counterpart:
    ``registry.py:125-130``)."""
    return model if isinstance(model, int) else int(str(model)[-1])


def get_density_model(config: Config, device=None,
                      seed: int = 0) -> ModelBundle:
    """The density trainer's EfficientNet{config.model} with the density
    head (counterpart: ``registry.py:138-148``) on ``device`` (default
    ``cuda``), weights drawn from ``seed``. Its training forward takes the
    generator of stochastic depth, as the eff family's does."""
    device = resolve_device(device)
    return _eff_bundle(config, device, seed, parse_model_id(config.model),
                       'density')
