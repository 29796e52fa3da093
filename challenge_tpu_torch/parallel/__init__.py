from challenge_tpu_torch.parallel.mesh import (
    Mesh, current, device_count, make_mesh, mesh_for_config, replicate,
    shard_banks, shard_batch)
from challenge_tpu_torch.parallel.train import (
    FusedEvalStep, FusedTrainStep, make_fused_eval_step,
    make_fused_train_step, make_sharded_eval_step, make_sharded_feature_fn,
    make_sharded_train_step)

__all__ = ['FusedEvalStep', 'FusedTrainStep', 'Mesh', 'current',
           'device_count', 'make_fused_eval_step', 'make_fused_train_step',
           'make_mesh', 'make_sharded_eval_step', 'make_sharded_feature_fn',
           'make_sharded_train_step', 'mesh_for_config', 'replicate',
           'shard_banks', 'shard_batch']
