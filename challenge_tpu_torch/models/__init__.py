from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.vad import VADModel

__all__ = ['ModelBundle', 'get_model', 'VADModel']
