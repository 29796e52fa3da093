from challenge_tpu_torch.data.mixture import Banks, Draws, draw, synthesize
from challenge_tpu_torch.data.pipeline import (
    LABEL_DOWNSAMPLE_MODELS, DevicePipeline, FeatureFn, build_banks)
from challenge_tpu_torch.data.specset import SpecBank, build_bank

__all__ = ['Banks', 'Draws', 'draw', 'synthesize', 'LABEL_DOWNSAMPLE_MODELS',
           'DevicePipeline', 'FeatureFn', 'build_banks', 'SpecBank',
           'build_bank']
