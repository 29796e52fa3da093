"""What each rank of the CPU meshes of tests/test_torch_mesh.py (2, 3 and
4 ranks) and tests/test_torch_mesh_graph.py (2 ranks) runs
(``parallel.launch.run`` imports it in each rank by name).

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
from challenge_tpu_torch.data import pipeline
from challenge_tpu_torch.data.pipeline import FeatureFn, build_banks
from challenge_tpu_torch.data.streaming import build_streaming_banks
from challenge_tpu_torch.dryrun import digest
from challenge_tpu_torch.evaluate import infer
from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.parallel import mesh as mesh_lib
from challenge_tpu_torch.parallel import train as ptrain
from challenge_tpu_torch.parallel.train import (
    make_fused_eval_step, make_fused_train_step, make_sharded_eval_step,
    make_sharded_train_step)
from challenge_tpu_torch.train import state as state_lib
from challenge_tpu_torch.train.loop import TrainLoop
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


def _cat(parts):
    """The shares ``parts`` (tensors, or nested tuples of them) joined on
    the leading axis, as the global batch they make."""
    if isinstance(parts[0], (tuple, list)):
        return type(parts[0])(_cat(p) for p in zip(*parts))
    return torch.cat(parts)


def _double(batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_double(b) for b in batch)
    return batch.double()


def rank_seed(key, rank: int) -> int:
    """The generator seed of ``key`` (a list of ints) on ``rank``."""
    return int(np.random.SeedSequence(list(key) + [rank])
               .generate_state(1)[0])


class Shares:
    """The one-process stand-in of a mesh's draws: ``(gen, banks)`` ->
    the global batch as the ``size`` ranks of a mesh draw it, each its
    ``batch_size // size`` share from ``banks`` with its own generator
    (``gens``, seeded by the caller as each rank's), joined in rank
    order; the ``gen`` the step passes is not used."""

    def __init__(self, config: Config, size: int):
        local = config.replace(batch_size=config.batch_size // size)
        self.features = FeatureFn(local, True, 'cpu')
        self.gens = [torch.Generator() for _ in range(size)]

    def __call__(self, gen, banks):
        return _cat([self.features(g, banks) for g in self.gens])


@contextlib.contextmanager
def float64_features():
    """Every ``FeatureFn`` batch cast to float64, for a float64 model."""
    call = FeatureFn.__call__
    with mock.patch.object(pipeline.FeatureFn, '__call__',
                           lambda self, *a: _double(call(self, *a))):
        yield


def se_step(cfg: dict, sources, mesh=None, ranks: int = 0) -> dict:
    """One float32 fused step of full-width se v9 (``cfg``'s batch, its
    pretrain flag) on float32 banks from ``sources``, from seed-1
    weights: over ``mesh``, each rank drawing its share with the
    generator of seed 100 + rank, or in one process on the global batch
    that ``ranks`` ranks draw so (:class:`Shares`)."""
    config = Config(**cfg)
    b = get_model(config, 'cpu')
    state = init_state(b, seed=1)
    banks = build_banks(*sources, n_frame=config.n_frame, device='cpu')
    if mesh is not None:
        mesh_lib.replicate(state.module, mesh)
        step = make_fused_train_step(b, config, mesh=mesh)
        gen = torch.Generator().manual_seed(100 + mesh.rank)
    else:
        step = make_fused_train_step(b, config)
        step.features = Shares(config, ranks)
        for r, g in enumerate(step.features.gens):
            g.manual_seed(100 + r)
        gen = None
    metrics = {k: v.numpy().copy() for k, v in step(state, banks,
                                                    gen).items()}
    return {'logs': [metrics], 'digest': digest(state.module),
            'step': state.step}


def stream_fit(cfg: dict, sources, epochs: int, steps: int,
               mesh=None, ranks: int = 0) -> dict:
    """``TrainLoop.fit`` of the small vad model of ``cfg`` in float64
    over a 2-chunk rotation of ``sources`` (``build_streaming_banks``):
    on ``mesh``,
    each rank drawing its share with its own generator, or in one process
    on the global batches that ``ranks`` ranks draw (:class:`Shares`,
    seeded as ``TrainLoop.phase_gen`` seeds each rank's). The final state
    and the epochs' logs."""
    b = bundle(cfg)
    stream = build_streaming_banks(*sources, n_chunks=2, n_frame=N_FRAME,
                                   chunk_steps=b.config.chunk_steps,
                                   device='cpu')
    with float64_features():
        loop = TrainLoop(b, seed=0, banks=stream, mesh=mesh)
        loop.state.module.double()
        if mesh is None:
            shares = Shares(b.config, ranks)
            loop.train_step.features = shares
            phase_gen = loop.phase_gen

            def reseeded(epoch, training):
                for r, g in enumerate(shares.gens):
                    g.manual_seed(rank_seed([loop.seed, epoch,
                                             int(training)], r))
                return phase_gen(epoch, training)
            loop.phase_gen = reseeded
        hist = loop.fit(epochs=epochs, steps_per_epoch=steps, verbose=0)
    return dict(numpy_state(loop.state),
                logs=[{k: v for k, v in h.items() if k != 'time'}
                      for h in hist],
                chunk=stream.current_chunk, dispatches=stream.dispatches)


def rank_checks(inputs: dict) -> dict:
    """Every check of one rank: the sharded train step with cross-replica
    and with per-replica BN statistics, the fused step with grad_accum 2
    and steps_per_call 2 on replicated f32 and sharded int8 banks, and the
    evaluation over the mesh; where ``inputs`` asks for them, one se v9
    fused step and a fit over a bank rotation."""
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
    if 'se_cfg' in inputs:
        out['se'] = se_step(inputs['se_cfg'], inputs['sources'], mesh)
    if 'stream_cfg' in inputs:
        out['stream'] = stream_fit(inputs['stream_cfg'], inputs['sources'],
                                   *inputs['stream_fit'], mesh)
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


# ------------------------------------- the mesh steps' graphs (gloo, CPU)
class CapturableMesh(mesh_lib.Mesh):
    """The joined gloo mesh, reporting itself capturable, so the steps
    built on it take their graphed path."""
    capturable = True


@contextlib.contextmanager
def graphed_path():
    """The steps' gate open on the CPU: ``on_cuda`` answers True in the
    modules of the four steps."""
    with mock.patch.object(state_lib, 'on_cuda', lambda state: True), \
            mock.patch.object(ptrain, 'on_cuda', lambda state: True):
        yield


def _run_body(fn, state, batch, *refs):
    """A stand-in for ``StepGraphs``: the body that would be captured,
    run eagerly."""
    return fn(state, batch, *refs)


def _mesh_steps(cfg: dict, init: dict, sources, mesh):
    """The four mesh steps of the small vad model: ``name -> make``,
    ``make()`` a fresh (state, step, args) from ``init``, a call being
    ``step(state, *args)``. The sharded steps in
    float64 on the rank's share of a fixed global batch; the fused ones in
    float32 (their features are float32) on host-built int8 banks, the
    rank's block of them, with grad_accum 2 and steps_per_call 2."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((8, N_MELS, N_FRAME, 2)))
    y = torch.from_numpy((rng.random((8, N_FRAME // 32, 3)) > 0.5)
                         .astype(np.float64))
    batch = mesh_lib.shard_batch((x, y), mesh)
    fcfg = dict(cfg, batch_size=4, grad_accum=2, steps_per_call=2,
                bank_dtype='int8', bank_shard=True)
    banks = mesh_lib.shard_banks(build_banks(
        *sources, n_frame=N_FRAME, flat_dtype='int8', device='cpu'), mesh)

    def sharded(make_step):
        def make():
            b = bundle(cfg, init)
            b.module.double()
            return (TrainState(b.module, make_optimizer(
                b.config, b.module.parameters())), make_step(b, mesh),
                (batch,))
        return make

    def fused(make_step):
        def make():
            b = bundle(fcfg, init)
            state = TrainState(b.module, make_optimizer(
                b.config, b.module.parameters()))
            return (state, make_step(b, b.config, mesh=mesh,
                                     bank_sharded=True),
                    (banks, torch.Generator().manual_seed(40 + mesh.rank)))
        return make
    return {'sharded_train': sharded(make_sharded_train_step),
            'sharded_eval': sharded(make_sharded_eval_step),
            'fused_train': fused(make_fused_train_step),
            'fused_eval': fused(make_fused_eval_step)}


def _record(state, metrics) -> dict:
    """The metrics, weights, BN statistics and optimizer slots, numpy."""
    out = {f'metric.{k}': v.detach().numpy().copy()
           for k, v in metrics.items()}
    out.update({f'w.{k}': v.detach().numpy().copy()
                for k, v in state.module.state_dict().items()})
    for i, (p, s) in enumerate(state.optimizer.state.items()):
        out.update({f'slot{i}.{k}': v.detach().numpy().copy()
                    for k, v in s.items()})
    return out


@contextlib.contextmanager
def _no_host(mesh_cls):
    """Every host sync and host-side collective a step could make,
    patched to raise."""
    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f'{name} in a step')
        return fn
    with contextlib.ExitStack() as stack:
        for name in ('item', 'cpu', 'tolist', 'numpy', '__float__',
                     '__int__', '__bool__'):
            stack.enter_context(mock.patch.object(torch.Tensor, name,
                                                  refuse(name)))
        for name in ('all_gather', 'broadcast_object'):
            stack.enter_context(mock.patch.object(mesh_cls, name,
                                                  refuse(name)))
        yield


class _Graphs:
    """Stand-ins for torch's CUDA graph, stream and capture context. The
    capture runs the step's body, whose collectives are logged as
    recorded into the graph, not executed; a replay logs them as
    executed, as a CUDA graph replays what it captured."""

    def __init__(self):
        self.capturing = None
        self.log = []             # (executed or recorded, collective, ...)

    def patches(self):
        rec = self

        class Graph:
            def __init__(self):
                self.recorded = []

            def register_generator_state(self, gen):
                pass

            def replay(self):
                rec.log += [('executed',) + e[1:] for e in self.recorded]

        @contextlib.contextmanager
        def graph(g, stream=None):
            rec.capturing = g
            try:
                yield
            finally:
                rec.capturing = None

        class Stream:
            def __init__(self, device=None):
                pass

            def wait_stream(self, other):
                pass

        flat = mesh_lib.Mesh._flat

        def logged_flat(mesh, tensors, collective):
            entry = (collective.__qualname__.split('.')[1],
                     tuple((str(t.dtype), t.numel()) for t in tensors))
            if rec.capturing is not None:
                rec.capturing.recorded.append(('recorded',) + entry)
                rec.log.append(('recorded',) + entry)
            else:
                rec.log.append(('executed',) + entry)
            return flat(mesh, tensors, collective)
        return [mock.patch.object(torch.cuda, 'CUDAGraph', Graph),
                mock.patch.object(torch.cuda, 'graph', graph),
                mock.patch.object(torch.cuda, 'Stream', Stream),
                mock.patch.object(torch.cuda, 'stream',
                                  lambda s: contextlib.nullcontext()),
                mock.patch.object(torch.cuda, 'current_stream',
                                  lambda device=None: Stream()),
                mock.patch.object(mesh_lib.Mesh, '_flat', logged_flat)]

    def take(self):
        out, self.log = self.log, []
        return out


def graph_checks(inputs: dict) -> dict:
    """tests/test_torch_mesh_graph.py's checks in one rank, for each of the
    four mesh steps: (b) the graphed path with its body run eagerly in
    place of the graph against ``.plain``; (c) the graphed path under
    ``_no_host``; (d) the collectives of a call that captures, a call
    that replays and a ``.plain`` call, through ``StepGraphs`` with
    ``_Graphs``' stand-ins."""
    joined = mesh_lib.current()
    mesh = CapturableMesh(joined.devices, joined.rank, joined.group)
    out = {'rank': mesh.rank, 'backend': mesh.backend,
           'joined_capturable': joined.capturable, 'bodies': {},
           'no_host': {}, 'collectives': {}}
    steps = _mesh_steps(inputs['cfg'], inputs['init'], inputs['sources'],
                        mesh)
    for name, make in steps.items():
        # (b) the graphed path's computation against .plain, from one init
        recs = []
        for graphed in (True, False):
            state, step, args = make()
            if graphed:
                step.graphs = _run_body
                with graphed_path():
                    metrics = step(state, *args)
            else:
                metrics = step.plain(state, *args)
            recs.append(_record(state, metrics))
        out['bodies'][name] = recs
        # (c) no host sync, no host-side collective: 'ok', or what ran
        state, step, args = make()
        step.graphs = _run_body
        try:
            with graphed_path(), _no_host(CapturableMesh):
                step(state, *args)
            out['no_host'][name] = 'ok'
        except AssertionError as e:
            out['no_host'][name] = str(e)
        # (d) the collectives a capture call, a replay call and a plain
        # call execute
        stand_in = _Graphs()
        with contextlib.ExitStack() as stack:
            for p in stand_in.patches():
                stack.enter_context(p)
            state, step, args = make()
            with graphed_path():
                step(state, *args)
                capture_call = stand_in.take()
                step(state, *args)
                replay_call = stand_in.take()
                captures = step.graphs.captures
            state, step, args = make()
            step.plain(state, *args)
            plain_call = stand_in.take()
        out['collectives'][name] = {
            'capture_call': capture_call, 'replay_call': replay_call,
            'plain_call': plain_call, 'captures': captures}
    return out


