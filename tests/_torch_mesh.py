"""What each rank of the 2-rank CPU meshes of tests/test_torch_mesh.py
runs (``parallel.launch.run`` imports it in each rank by name).

It imports neither JAX nor the JAX package, so a rank starts in about a
second: the test process computes every input with numpy (and JAX) and
hands it over, and holds what the ranks return against its own runs.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import torch

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.evaluate import infer
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.parallel import mesh as mesh_lib
from challenge_tpu_torch.parallel.train import (
    make_fused_train_step, make_sharded_train_step)
from challenge_tpu_torch.train import state as state_lib
from challenge_tpu_torch.train.optim import make_optimizer
from challenge_tpu_torch.train.state import TrainState, init_state

N_MELS, N_FRAME, HOP = 32, 64, 64


def bundle(cfg: dict, state_dict=None) -> ModelBundle:
    """The small vad model (base_fsize 8, td_dim 32) of ``cfg`` on the
    CPU, with ``state_dict`` (numpy) loaded when given."""
    config = Config(**cfg)
    module = VADModel(v=config.v, base_fsize=8, td_dim=32,
                      n_mels=config.n_mels, n_chan=config.n_chan)
    if state_dict is not None:
        module.load_state_dict({k: torch.from_numpy(np.asarray(a))
                                for k, a in state_dict.items()})
    return ModelBundle(module, (config.n_mels, config.n_frame,
                                config.n_chan), config, torch.device('cpu'))


def numpy_state(state: TrainState) -> dict:
    """The state's weights and statistics, and each parameter's Keras Adam
    moments, as numpy."""
    names = {id(p): n for n, p in state.module.named_parameters()}
    return {
        'sd': {k: v.numpy().copy()
               for k, v in state.module.state_dict().items()},
        'm': {names[id(p)]: s['m'].numpy().copy()
              for p, s in state.optimizer.state.items()},
        'v': {names[id(p)]: s['v'].numpy().copy()
              for p, s in state.optimizer.state.items()},
        'step': state.step}


def train_steps(cfg: dict, init: dict, batches, mesh=None) -> dict:
    """``make_sharded_train_step`` (or, without a mesh, the one-process
    step) in float64 from ``init`` over the global ``batches``: the final
    state and each step's metrics."""
    b = bundle(cfg, init)
    b.module.double()
    state = TrainState(b.module, make_optimizer(b.config,
                                                b.module.parameters()))
    step = make_sharded_train_step(b, mesh) if mesh is not None else \
        state_lib.make_train_step(b)
    logs = []
    for x, y in batches:
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        if mesh is not None:
            batch = mesh_lib.shard_batch(batch, mesh)
        logs.append({k: v.numpy().copy()
                     for k, v in step(state, batch).items()})
    return dict(numpy_state(state), logs=logs)


@contextlib.contextmanager
def _per_replica_statistics(mesh):
    yield


def fused_steps(cfg: dict, sources, calls: int, bank_sharded: bool,
                mesh) -> dict:
    """``calls`` calls of the fused mesh step of ``cfg`` (its grad_accum
    and steps_per_call) on banks built on the host from ``sources``, the
    rank's block of them with ``bank_sharded``; the rank draws with its
    own generator."""
    b = bundle(cfg)
    state = init_state(b, seed=1)
    mesh_lib.replicate(state.module, mesh)
    bg, voices, labels, noises = sources
    banks = build_banks(bg, voices, labels, noises, n_frame=N_FRAME,
                        flat_dtype=b.config.bank_dtype, device='cpu')
    if bank_sharded:
        banks = mesh_lib.shard_banks(banks, mesh)
    step = make_fused_train_step(b, b.config, mesh=mesh,
                                 bank_sharded=bank_sharded)
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    logs = [{k: v.numpy().copy()
             for k, v in step(state, banks, gen).items()}
            for _ in range(calls)]
    return dict(numpy_state(state), logs=logs,
                opt_step=int(state.optimizer.param_groups[0]['step']),
                n_voices=banks.voices.n)


def eval_grids(cfg: dict, state_dict: dict, dev: str, mesh=None) -> dict:
    """``evaluate`` of the small vad v8 on the dev set in ``dev`` and the
    grids of its batched chain (one chunk and chunks of 2 clips) and of
    its per-clip chain, over ``mesh`` or in one process."""
    b = bundle(cfg, state_dict)
    module = b.module.eval()
    config = b.config
    paths = sorted(os.path.join(dev, p) for p in os.listdir(dev)
                   if p.endswith('.wav'))
    # two clips a chunk: a 44-byte header, then the int16 samples
    cap = 2 * (max(os.path.getsize(p) for p in paths) - 44)
    return {
        'ers': infer.evaluate(config, module, HOP, eval_dir=dev, mesh=mesh),
        'ers_per_clip': infer.evaluate(config, module, HOP, eval_dir=dev,
                                       batched=False, mesh=mesh),
        'grids': infer.batched_grids(config, module, paths, HOP, mesh=mesh),
        'chunked': infer.batched_grids(config, module, paths, HOP,
                                       cap=cap, mesh=mesh),
        'per_clip': [infer.clip_scores(config, module, p, HOP, i, mesh)
                     .numpy() for i, p in enumerate(paths)]}


def rank_checks(inputs: dict) -> dict:
    """Every check of one rank: the sharded train step with cross-replica
    and with per-replica BN statistics, the fused step with grad_accum 2
    and steps_per_call 2 on replicated f32 and sharded int8 banks, and the
    evaluation over the mesh."""
    mesh = mesh_lib.current()
    out = {'rank': mesh.rank, 'backend': mesh.backend}
    out['sharded'] = train_steps(inputs['cfg'], inputs['init'],
                                 inputs['batches'], mesh)
    with mock.patch.object(state_lib, 'cross_replica',
                           _per_replica_statistics):
        out['per_replica'] = train_steps(inputs['cfg'], inputs['init'],
                                         inputs['batches'], mesh)
    for name, dtype, sharded in (('fused_f32', 'float32', False),
                                 ('fused_int8', 'int8', True)):
        out[name] = fused_steps(dict(inputs['fused_cfg'], bank_dtype=dtype),
                                inputs['sources'], 2, sharded, mesh)
    out['eval'] = eval_grids(inputs['eval_cfg'], inputs['eval_init'],
                             inputs['dev'], mesh)
    return out


def fail_on(rank: int) -> int:
    """Raise in rank ``rank``, after a collective every rank joins; the
    others then wait on a collective the dead rank never joins."""
    mesh = mesh_lib.current()
    mesh.all_reduce_([torch.ones(1)])
    if mesh.rank == rank:
        raise RuntimeError(f'rank {rank} fails on purpose')
    mesh.all_reduce_([torch.ones(1)])
    return mesh.rank
