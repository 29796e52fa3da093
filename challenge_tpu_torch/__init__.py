"""challenge_tpu_torch: the PyTorch + CUDA port of challenge_tpu for NVIDIA
Hopper GPUs.

The JAX package ``challenge_tpu`` is the reference and is left as it is;
this package mirrors its module layout and imports neither JAX nor it.
Entry points run on ``cuda`` unless given ``device='cpu'``:

    cfg = Config(model_type='vad', v=8)
    banks = build_banks(bgs, voices, labels, noises, n_frame=cfg.n_frame)
    loop = TrainLoop(get_model(cfg))
    loop.fit(DevicePipeline(banks, cfg), epochs=1, steps_per_epoch=N)
"""

__version__ = '0.1.0'      # the JAX package's, whose API this mirrors

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.ops.norms import EPSILON
from challenge_tpu_torch.data.pipeline import DevicePipeline, build_banks
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.train.loop import TrainLoop

__all__ = ['Config', 'DevicePipeline', 'EPSILON', 'build_banks', 'get_model',
           'TrainLoop']
