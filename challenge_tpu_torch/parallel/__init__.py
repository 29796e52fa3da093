from challenge_tpu_torch.parallel.train import (
    FusedEvalStep, FusedTrainStep, make_fused_eval_step,
    make_fused_train_step)

__all__ = ['FusedEvalStep', 'FusedTrainStep', 'make_fused_eval_step',
           'make_fused_train_step']
