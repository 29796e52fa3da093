from challenge_tpu_torch.models.effnet import EffNetSED, EfficientNetBackbone
from challenge_tpu_torch.models.registry import (
    ModelBundle, get_density_model, get_model)
from challenge_tpu_torch.models.senet import SECascade, SpeechEnhancementModel
from challenge_tpu_torch.models.vad import VADModel

__all__ = ['EffNetSED', 'EfficientNetBackbone', 'ModelBundle',
           'get_density_model', 'get_model', 'SECascade',
           'SpeechEnhancementModel', 'VADModel']
