"""The data-parallel mesh steps as CUDA graphs on an NCCL mesh
(challenge_tpu_torch/parallel/mesh.py ``Mesh.capturable``,
train/graph.py ``StepGraphs``, train/state.py ``TrainStep``,
``EvalStep``, parallel/train.py ``FusedTrainStep``, ``FusedEvalStep``).

No graph captures on the CPU, and gloo's collectives cannot be captured,
so the graphs themselves run only on the card (chip_smoke.py phase 5m).
Here:

* (a) the gate: a step runs as graphs only on a CUDA module, alone or on
  a mesh that reports itself capturable (joined, NCCL, on a card); a gloo
  mesh and any CPU module run ``.plain``. Routing is read through
  recording stand-ins for ``StepGraphs`` and ``.plain``;
* on the 2-rank gloo CPU mesh of tests/_torch_mesh.py, with the gate
  opened (``_torch_mesh.graphed_path``, a mesh flagged capturable), for
  each of the four mesh steps:
  (b) the graphed path, its body run eagerly where a graph would replay
  it, equals ``.plain`` bit for bit: the global batch's metrics (equal on
  both ranks), every weight, BN statistic and optimizer slot. The sharded
  steps run in float64, the fused ones in float32 (their features are
  float32) on ``--bank_shard`` int8 banks with grad_accum 2 and
  steps_per_call 2;
  (c) that path makes no host sync and no host-side collective:
  ``Tensor.item``, ``cpu``, ``tolist``, ``numpy``, ``__float__``,
  ``__int__``, ``__bool__``, ``Mesh.all_gather`` and
  ``Mesh.broadcast_object`` raise while it runs;
  (d) a call that captures, a call that replays and a ``.plain`` call
  execute the same collectives in the same order, counted through
  ``Mesh._flat`` with stand-ins for torch's graph and streams whose
  capture logs the collectives as recorded, not executed, and whose
  replay executes what was recorded.

Tolerance: 0.0 everywhere; the graphed path runs the same operations on
the same tensors as ``.plain``.
"""

import types

import numpy as np
import pytest
import torch

import _torch_mesh as tm
from _torch_parity import small_sources
from challenge_tpu_torch.parallel import launch
from challenge_tpu_torch.parallel import mesh as mesh_lib
from challenge_tpu_torch.parallel import train as ptrain
from challenge_tpu_torch.train import state as state_lib

CFG = dict(model_type='vad', v=3, n_mels=tm.N_MELS, n_frame=tm.N_FRAME,
           batch_size=8)
STEPS = ['sharded_train', 'sharded_eval', 'fused_train', 'fused_eval']


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- (a) gate
@pytest.mark.parametrize('devices,joined,want', [
    (('cuda:0', 'cuda:1'), True, True),
    (('cuda:0',), True, True),                 # a one-rank NCCL mesh
    (('cuda:0', 'cuda:1'), False, False),      # a plan, not joined
    (('cuda:0', 'cuda:0'), True, False),       # ranks share a card: gloo
    (('cpu', 'cpu'), True, False)])
def test_mesh_is_capturable_joined_over_nccl_on_cards(devices, joined,
                                                     want):
    mesh = mesh_lib.Mesh(devices, 0, object() if joined else None)
    assert mesh.capturable is want
    assert (mesh.backend == 'nccl') is (want or not joined)


def _step(name, mesh):
    module = tm.bundle(dict(CFG, batch_size=2))
    if name == 'sharded_train':
        return state_lib.make_train_step(module, mesh=mesh)
    if name == 'sharded_eval':
        return state_lib.make_eval_step(module, mesh=mesh)
    make = (ptrain.make_fused_train_step if name == 'fused_train'
            else ptrain.make_fused_eval_step)
    return make(module, module.config, mesh=mesh)


MESHES = {None: None,
          'gloo': (('cpu', 'cpu'), 0, object()),
          'nccl': (('cuda:0', 'cuda:1'), 0, object())}


@pytest.mark.parametrize('on_card,mesh,want', [
    (False, None, 'plain'), (False, 'nccl', 'plain'),
    (True, 'gloo', 'plain'), (True, None, 'graphs'),
    (True, 'nccl', 'graphs')])
@pytest.mark.parametrize('name', STEPS)
def test_gate_sends_only_capturable_steps_to_their_graphs(
        monkeypatch, name, on_card, mesh, want):
    monkeypatch.setattr(state_lib, 'on_cuda', lambda state: on_card)
    monkeypatch.setattr(ptrain, 'on_cuda', lambda state: on_card)
    step = _step(name, mesh and mesh_lib.Mesh(*MESHES[mesh]))
    calls = []
    step.graphs = lambda fn, *a: calls.append('graphs') or {}
    step.plain = lambda *a: calls.append('plain') or {}
    args = ((None,) if name.startswith('sharded')
            else (None, torch.Generator()))
    step(types.SimpleNamespace(), *args)
    assert set(calls) == {want}


# ------------------------------------------- (b)-(d) on 2 gloo CPU ranks
@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """What ranks 0 and 1 of one 2-rank CPU mesh returned from
    ``_torch_mesh.graph_checks``."""
    b = tm.bundle(CFG)
    b.init(3)
    inputs = {'cfg': CFG, 'sources': small_sources(2),
              'init': {k: v.numpy().copy()
                       for k, v in b.module.state_dict().items()}}
    return launch.run('_torch_mesh:graph_checks', (inputs,),
                      ['cpu', 'cpu'],
                      workdir=str(tmp_path_factory.mktemp('mesh_graph')))


def test_a_joined_gloo_mesh_is_not_capturable(ranks):
    assert [(r['rank'], r['backend'], r['joined_capturable'])
            for r in ranks] == [(0, 'gloo', False), (1, 'gloo', False)]


def _equal(a: dict, b: dict) -> list:
    """The keys where two records differ (shape, dtype or a bit)."""
    assert a.keys() == b.keys()
    return [k for k in a if a[k].dtype != b[k].dtype
            or not np.array_equal(a[k], b[k])]


@pytest.mark.parametrize('name', STEPS)
def test_graph_body_equals_plain_bit_for_bit(ranks, name):
    for r in ranks:
        graphed, plain = r['bodies'][name]
        assert any(k.startswith('metric.') for k in graphed)
        assert _equal(graphed, plain) == [], (r['rank'], name)
    # the global batch's metrics and the replicated state, on both ranks
    assert _equal(ranks[0]['bodies'][name][0],
                  ranks[1]['bodies'][name][0]) == []


@pytest.mark.parametrize('name', STEPS)
def test_graph_body_makes_no_host_sync(ranks, name):
    assert [r['no_host'][name] for r in ranks] == ['ok', 'ok']


def _executed(log):
    return [e[1:] for e in log if e[0] == 'executed']


@pytest.mark.parametrize('name', STEPS)
def test_capture_and_replay_calls_execute_the_plain_collectives(ranks,
                                                                name):
    for r in ranks:
        c = r['collectives'][name]
        assert c['captures'] == 1
        plain = _executed(c['plain_call'])
        kinds = {e[0] for e in plain}
        assert kinds == ({'all_reduce_', 'broadcast_'}
                         if name.endswith('train') else {'all_reduce_'})
        # the capture call executes the eager step's collectives, records
        # them into the graph, and executes none of what it records
        assert _executed(c['capture_call']) == plain
        recorded = [e[1:] for e in c['capture_call'] if e[0] == 'recorded']
        assert recorded and recorded == plain[:len(recorded)]
        # a replay call executes what the graph recorded
        assert _executed(c['replay_call']) == plain
    assert (ranks[0]['collectives'][name]['plain_call']
            == ranks[1]['collectives'][name]['plain_call'])
