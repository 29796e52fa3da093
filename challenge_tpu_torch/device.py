"""Device selection for the port's entry points.

Every entry point (``build_banks``, ``DevicePipeline``, ``TrainLoop``,
``get_model``) runs on the GPU unless the caller asks for the CPU with
``device='cpu'``. A missing GPU is an error, never a quiet fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raises when CUDA is asked for and absent.

    On CUDA it also sets three process-wide backend flags. It pins float32
    numerics: cuDNN would otherwise run float32 convolutions in TF32 (about
    three decimal digits), while the JAX reference computes them in full
    float32. ``matmul.allow_tf32`` is already False by default and stays
    so. And it lets cuDNN time its algorithms once per shape
    (``cudnn.benchmark``): for vad v8's float32 convolutions the heuristic
    picks FFT-tiled algorithms of some 66,000 small GEMM launches a step.
    On an H100 at 700 W the full-width model step took 737-844 ms with the
    flag off and 39-41 ms with it on, each in a fresh process
    (``chip_smoke.py --cudnn-ab``).
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'challenge_tpu_torch runs on a CUDA GPU by default and none '
                "is available; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
        if device.index is None:    # comparable with a tensor's .device
            device = torch.device('cuda', torch.cuda.current_device())
    return device
