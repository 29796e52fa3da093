"""The iterator-mode train and eval steps as step objects
(challenge_tpu_torch/train/state.py ``TrainStep``, ``EvalStep``), the
capture scheme they share with the fused steps (train/graph.py
``StepGraphs``), and the address stability the graphs rely on.

On the CPU the steps run eagerly, their plain version; the graphs run only
on the card, where chip_smoke.py phase 5l holds them against ``.plain`` at
0.0. Here:

* the step objects' eager path equals the step functions they replace
  (reproduced below from their previous bodies) at 0.0: metrics, every
  parameter, BN statistic and optimizer slot, for vad v8, eff B0 with
  stochastic depth and the density head with its kernel penalty;
* ``StepGraphs``' bookkeeping, with torch's CUDA graph and stream
  classes replaced by recording stand-ins (a stand-in graph replays the
  call it captured): the first call of a signature runs eagerly and
  captures, later calls copy the batch into the graph's buffers and
  replay, a batch of a new shape builds a second graph, ``state.step``
  and the launch counts advance per replay, and a changed address, state
  or generator drops the graphs and captures anew;
* every write path keeps the ``data_ptr`` of every parameter, buffer,
  optimizer slot, ``lr`` and ``step``: ``set_weights`` (from a state
  dict, a ``torch.save`` file and a Keras HDF5 file), SWA's train end,
  ``restore_train_state``, the CLIs' ``resume``, ``set_learning_rate``
  through ``LearningRateScheduler`` and ``ReduceLROnPlateau``, and
  ``TrainStateCheckpoint``;
* a mesh whose collectives cannot be captured (gloo) keeps the eager
  path, as the gloo mesh fused step does.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from _torch_parity import N_FRAME, N_MELS
from challenge_tpu_torch.cli import sj_train
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.models import effnet
from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.train import callbacks as cb
from challenge_tpu_torch.train import graph as graph_lib
from challenge_tpu_torch.train import regularizers
from challenge_tpu_torch.train import state as state_lib
from challenge_tpu_torch.train.checkpoint import (
    load_weights, restore_train_state, save_train_state, save_weights)
from challenge_tpu_torch.train.losses import density_loss, get_loss
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.metrics import batch_metrics
from challenge_tpu_torch.train.optim import make_optimizer, set_learning_rate
from challenge_tpu_torch.train.state import (
    EvalStep, TrainState, TrainStep, make_eval_step, make_grad_update,
    make_train_step)

SHAPE = (N_MELS, N_FRAME, 2)


def _batch(seed, batch=2, label_frames=N_FRAME // 32):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((batch,) + SHAPE,
                                                 dtype=np.float32)),
            torch.from_numpy(rng.integers(0, 2, (batch, label_frames, 3))
                             .astype(np.float32)))


def _vad():
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 batch_size=2)
    module = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    module.reset_parameters(torch.Generator().manual_seed(0))
    return ModelBundle(module, SHAPE, cfg, torch.device('cpu')), None, \
        _batch(1)


def _eff():
    cfg = Config(model_type='eff', model=0, v=3, n_mels=N_MELS,
                 n_frame=N_FRAME, batch_size=2)
    return get_model(cfg, device='cpu', seed=4), None, _batch(2)


def _density():
    module = effnet.EffNetSED(n_mels=N_MELS, n_frame=N_FRAME,
                              head='density')
    module.reset_parameters(torch.Generator().manual_seed(0))
    cfg = Config(model_type='eff', v=0, optimizer='adabelief')
    bundle = ModelBundle(module, SHAPE, cfg, torch.device('cpu'),
                         needs_dropout_gen=True)
    base = density_loss()
    loss_fn = regularizers.apply_kernel_regularizer(
        lambda t, p: (base(t, p), {}), regularizers.l1_l2(0.0, 1e-3))
    x, _ = _batch(3)
    y = torch.from_numpy(np.random.default_rng(4).random(
        (2, 2, 3), dtype=np.float32))
    return bundle, loss_fn, (x, y)


MODELS = {'vad_v8': _vad, 'eff_b0_v3': _eff, 'density_l2': _density}


def _previous_train_step(bundle, loss_fn=None):
    """``make_train_step``'s body before it returned a step object."""
    grad_fn, update_fn = make_grad_update(bundle, loss_fn)

    def train_step(state, batch, gen=None):
        grads, metrics = grad_fn(state.module, batch, gen)
        update_fn(state, grads)
        return metrics
    return train_step


def _previous_eval_step(bundle, loss_fn=None):
    """``make_eval_step``'s body before it returned a step object."""
    loss_fn = loss_fn or get_loss(bundle.config)
    metric_fns = batch_metrics(bundle.config)

    @torch.no_grad()
    def eval_step(state, batch):
        x, y = batch
        state.module.eval()
        out = state.module(x)
        loss, parts = state_lib._loss_of(loss_fn, y, out, state.module)
        return state_lib._metrics(metric_fns, loss, parts, y, out)
    return eval_step


def _state(bundle):
    module = copy.deepcopy(bundle.module)
    return TrainState(module, make_optimizer(bundle.config,
                                             module.parameters()))


def _tensors(state):
    """Every tensor of the state by name: the state_dict and the slots."""
    out = dict(state.module.state_dict())
    names = {id(p): n for n, p in state.module.named_parameters()}
    for p, s in state.optimizer.state.items():
        out.update({f'{names[id(p)]}/{k}': v for k, v in s.items()})
    for i, g in enumerate(state.optimizer.param_groups):
        out.update({f'group{i}/lr': g['lr'], f'group{i}/step': g['step']})
    return out


@pytest.mark.parametrize('name', list(MODELS))
def test_eager_steps_equal_the_previous_functions(name):
    """Two train steps then an eval step, through the step objects and
    through the previous functions, from one init and one generator seed:
    the metrics and every tensor of the state equal at 0.0."""
    bundle, loss_fn, batch = MODELS[name]()
    runs = []
    for train, evaluate in (
            (make_train_step(bundle, loss_fn), make_eval_step(bundle,
                                                              loss_fn)),
            (_previous_train_step(bundle, loss_fn),
             _previous_eval_step(bundle, loss_fn))):
        state = _state(bundle)
        gen = torch.Generator().manual_seed(7)
        logs = [train(state, batch, gen) for _ in range(2)]
        logs.append(evaluate(state, batch))
        runs.append((logs, _tensors(state), state.step))
    (new_logs, new_t, new_step), (old_logs, old_t, old_step) = runs
    assert isinstance(make_train_step(bundle), TrainStep)
    assert isinstance(make_eval_step(bundle), EvalStep)
    assert new_step == old_step == 2
    for a, b in zip(new_logs, old_logs):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert new_t.keys() == old_t.keys()
    assert all(torch.equal(new_t[k], old_t[k]) for k in new_t), \
        [k for k in new_t if not torch.equal(new_t[k], old_t[k])]


def test_plain_is_callable_beside_the_step():
    """``.plain`` is the eager step the graph is held against."""
    bundle, _, batch = _vad()
    a, b = _state(bundle), _state(bundle)
    step = make_train_step(bundle)
    la, lb = step(a, batch), step.plain(b, batch)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    ev = make_eval_step(bundle)
    assert torch.equal(ev(a, batch)['loss'], ev.plain(b, batch)['loss'])


def test_flatten_round_trips_the_batch_tree():
    x, y = torch.zeros(2, 3), torch.ones(2)
    batch = (x, (y, x + 1, y + 2))
    leaves, tree = graph_lib.flatten(batch)
    assert len(leaves) == 4 and leaves[0] is x
    back = graph_lib.unflatten(tree, leaves)
    assert back[0] is x and back[1][0] is y and len(back[1]) == 3
    assert graph_lib.flatten(None) == ([], None)


# ------------------------------------------------ StepGraphs, stand-ins
class _Recorder:
    """Stand-ins for torch's CUDA graph, stream and capture context: while
    "capturing", the step's calls are recorded, not run; a replay runs the
    recorded call (the step function) on the graph's buffers."""

    def __init__(self):
        self.capturing = None
        self.graphs = []

    def install(self, mp):
        rec = self

        class Graph:
            def __init__(self):
                self.call = None
                self.generators = []
                self.replays = 0
                rec.graphs.append(self)

            def register_generator_state(self, gen):
                self.generators.append(gen)

            def replay(self):
                self.replays += 1
                out = self.call()
                for k, v in out.items():
                    self.outputs[k].copy_(v)

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

        mp.setattr(torch.cuda, 'CUDAGraph', Graph)
        mp.setattr(torch.cuda, 'graph', graph)
        mp.setattr(torch.cuda, 'Stream', Stream)
        mp.setattr(torch.cuda, 'stream',
                   lambda s: contextlib.nullcontext())
        mp.setattr(torch.cuda, 'current_stream', lambda device=None:
                   Stream())


def _toy_step(recorder, runs):
    """A step that adds the batch's mean to the weight, counts one launch
    of a kernel and one optimizer step; recorded while capturing."""
    def run(state, batch, gen=None):
        def body():
            x, y = batch
            with torch.no_grad():
                state.module.weight.add_(x.mean() + y.mean())
            runs.append(x.shape)
            return {'loss': state.module.weight.sum().detach().clone()}
        state.step += 1
        cuda.count_launch('toy')
        if recorder.capturing is not None:
            g = recorder.capturing
            g.call = body              # a replay runs no Python but this
            g.outputs = {'loss': torch.zeros(())}
            return g.outputs
        return body()
    return run


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    rec.install(monkeypatch)
    cuda.reset_launch_counts()
    yield rec
    cuda.reset_launch_counts()


def _toy_state():
    module = torch.nn.Linear(3, 1, bias=False)
    return TrainState(module, make_optimizer(Config(),
                                             module.parameters()))


def test_step_graphs_capture_then_replay_per_signature(recorder):
    state, runs = _toy_state(), []
    graphs = graph_lib.StepGraphs(lambda refs: refs)
    step = _toy_step(recorder, runs)
    gen = torch.Generator()
    small = (torch.ones(2, 3), torch.ones(2))
    # first call: the eager step, then the capture (which runs nothing)
    out = graphs(step, state, small, gen)
    assert state.step == 1 and len(runs) == 1 and len(recorder.graphs) == 1
    assert recorder.graphs[0].generators == [gen]
    assert cuda.LAUNCHES['toy'] == 1            # the eager step's launch
    # a replay copies the new batch into the graph's buffers
    before = state.module.weight.clone()
    out = graphs(step, state, (torch.full((2, 3), 2.0), torch.zeros(2)),
                 gen)
    assert recorder.graphs[0].replays == 1 and state.step == 2
    assert torch.equal(state.module.weight, before + 2.0)
    assert torch.equal(out['loss'], state.module.weight.sum())
    assert cuda.LAUNCHES['toy'] == 2
    # a batch of another shape is another signature: a second graph
    graphs(step, state, (torch.ones(4, 3), torch.ones(4)), gen)
    assert len(graphs.graphs) == 2 and len(recorder.graphs) == 2
    assert graphs.captures == 2
    assert state.step == 3 and runs[-1] == (4, 3)
    graphs(step, state, small, gen)
    assert recorder.graphs[0].replays == 2 and state.step == 4
    assert cuda.LAUNCHES['toy'] == 4


@pytest.mark.parametrize('change', ['address', 'state', 'generator'])
def test_step_graphs_never_replay_a_stale_graph(recorder, change):
    state, runs = _toy_state(), []
    graphs = graph_lib.StepGraphs(lambda refs: refs)
    step = _toy_step(recorder, runs)
    gen = torch.Generator()
    batch = (torch.ones(2, 3), torch.ones(2))
    graphs(step, state, batch, gen)
    graphs(step, state, batch, gen)
    assert len(recorder.graphs) == 1 and recorder.graphs[0].replays == 1
    if change == 'address':
        state.module.weight.data = state.module.weight.data.clone()
    elif change == 'state':
        state = TrainState(state.module, state.optimizer, state.step)
    else:
        gen = torch.Generator()
    n_runs = len(runs)
    graphs(step, state, batch, gen)
    # dropped and captured anew: the call ran eagerly, a new graph exists
    assert len(recorder.graphs) == 2 and len(runs) == n_runs + 1
    assert graphs.captures == 2 and len(graphs.graphs) == 1
    assert recorder.graphs[0].replays == 1
    graphs(step, state, batch, gen)
    assert recorder.graphs[1].replays == 1


def test_fused_steps_share_the_scheme():
    from challenge_tpu_torch.parallel.train import (
        FusedEvalStep, FusedTrainStep)
    bundle, _, _ = _vad()
    cfg = bundle.config
    assert isinstance(FusedTrainStep(bundle, cfg).graphs,
                      graph_lib.StepGraphs)
    assert isinstance(FusedEvalStep(bundle, cfg).graphs,
                      graph_lib.StepGraphs)


def test_a_mesh_keeps_the_eager_path(monkeypatch):
    """With a mesh that cannot be captured (gloo) the step runs ``plain``
    even on a CUDA module; without one it goes to its graphs."""
    bundle, _, batch = _vad()
    monkeypatch.setattr(state_lib, 'on_cuda', lambda state: True)

    def no_graph(*a, **kw):
        raise AssertionError('captured')
    monkeypatch.setattr(graph_lib.StepGraphs, '__call__', no_graph)
    mesh = type('Mesh', (), {'size': 1, 'capturable': False})()
    monkeypatch.setattr(state_lib, 'reduce_metrics',
                        lambda metrics, m: metrics)
    for step in (TrainStep(bundle, mesh=mesh), EvalStep(bundle, mesh=mesh)):
        step.mesh = mesh
        calls = []
        monkeypatch.setattr(step, 'plain', lambda *a: calls.append(a) or {})
        step(_state(bundle), batch)
        assert len(calls) == 1
    with pytest.raises(AssertionError, match='captured'):
        TrainStep(bundle)(_state(bundle), batch)


def test_iterator_loop_steps_are_step_objects():
    bundle, _, _ = _eff()
    loop = TrainLoop(bundle)
    assert isinstance(loop.train_step, TrainStep)
    assert isinstance(loop.eval_step, EvalStep)
    # one persistent stochastic-depth generator, reseeded per epoch: the
    # generator a graph registers is the one the loop reseeds
    assert loop.dropout_gen(0) is loop.dropout_gen(1)


# ---------------------------------------------------- address stability
def _trained_loop(tmp_path):
    """A vad loop after two iterator steps, so every slot exists."""
    bundle, _, batch = _vad()
    loop = TrainLoop(bundle)
    for _ in range(2):
        loop.train_step(loop.state, batch)
    return loop, batch


def _other_weights(loop):
    return {k: (v + 1 if v.is_floating_point() else v + 1)
            for k, v in loop.state.module.state_dict().items()}


WRITE_PATHS = ['set_weights', 'torch_save_file', 'keras_h5_file',
               'swa_train_end', 'restore_train_state', 'cli_resume',
               'lr_scheduler', 'reduce_lr_on_plateau',
               'train_state_checkpoint']


@pytest.mark.parametrize('path', WRITE_PATHS)
def test_write_paths_keep_every_address(tmp_path, path):
    loop, batch = _trained_loop(tmp_path)
    state = loop.state
    before = graph_lib.state_addresses(state)
    n = len(before)
    assert n == len(list(state.module.parameters())) * 3 + len(
        list(state.module.buffers())) + 2
    want = None
    if path == 'set_weights':
        want = _other_weights(loop)
        loop.set_weights(want)
    elif path == 'torch_save_file':
        want = _other_weights(loop)
        save_weights(str(tmp_path / 'w.h5'), want)
        loop.set_weights(load_weights(str(tmp_path / 'w.h5')))
    elif path == 'keras_h5_file':
        pytest.importorskip('h5py')
        want = _other_weights(loop)
        save_weights(str(tmp_path / 'k.h5'), want, keras=True,
                     bundle=loop.bundle)
        loop.set_weights(load_weights(str(tmp_path / 'k.h5'),
                                      bundle=loop.bundle))
    elif path == 'swa_train_end':
        swa = cb.SWA(start_epoch=0)
        swa.set_loop(loop)
        swa.on_epoch_end(0, {})
        loop.train_step(state, batch)
        swa.on_train_end()
    elif path in ('restore_train_state', 'cli_resume'):
        save_train_state(str(tmp_path / 'ck'), state)
        loop.train_step(state, batch)
        if path == 'cli_resume':
            cfg = loop.config.replace(ckpt_dir=str(tmp_path / 'ck'),
                                      resume=True, steps_per_epoch=1)
            assert sj_train.resume(cfg, loop) == 2
        else:
            restore_train_state(str(tmp_path / 'ck'), state)
        assert state.step == 2
    elif path == 'lr_scheduler':
        sched = cb.LearningRateScheduler(lambda epoch: 0.5)
        sched.set_loop(loop)
        sched.on_epoch_begin(3)
        assert float(state.optimizer.param_groups[0]['lr']) == 0.5
    elif path == 'reduce_lr_on_plateau':
        plateau = cb.ReduceLROnPlateau(monitor='loss', factor=0.5,
                                       patience=1)
        plateau.set_loop(loop)
        lr = float(state.optimizer.param_groups[0]['lr'])
        for v in (1.0, 2.0):
            plateau.on_epoch_end(0, {'loss': v})
        assert float(state.optimizer.param_groups[0]['lr']) == \
            float(np.float32(lr) * np.float64(0.5))
    else:
        ckpt = cb.TrainStateCheckpoint(str(tmp_path / 'ck'), every_epochs=1)
        ckpt.set_loop(loop)
        ckpt.on_epoch_end(0, {})
        ckpt.on_train_end()
    assert graph_lib.state_addresses(state) == before
    if want is not None:
        got = state.module.state_dict()
        assert all(torch.equal(got[k], want[k].to(got[k].dtype))
                   for k in want)


def test_set_learning_rate_fills_in_place():
    state = _toy_state()
    lr = state.optimizer.param_groups[0]['lr']
    assert set_learning_rate(state.optimizer, 0.25) is state.optimizer
    assert state.optimizer.param_groups[0]['lr'] is lr
    assert float(lr) == 0.25 and lr.dtype == torch.float32
