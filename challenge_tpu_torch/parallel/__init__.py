from challenge_tpu_torch.parallel.mesh import device_count, devices_for_config
from challenge_tpu_torch.parallel.train import (
    FusedEvalStep, FusedTrainStep, make_fused_eval_step,
    make_fused_train_step)

__all__ = ['FusedEvalStep', 'FusedTrainStep', 'device_count',
           'devices_for_config', 'make_fused_eval_step',
           'make_fused_train_step']
