"""The data-parallel mesh of the port (challenge_tpu_torch/parallel/mesh.py,
launch.py, train.py; BatchNorm's cross-replica statistics in
models/layers.py; the global gradient and metrics in train/state.py;
evaluate(mesh=)) against one process and against JAX's mesh.

Every multi-process check runs in one 2-rank gloo mesh on the CPU
(``ranks``: this process is rank 0, one child is rank 1, through a
``file://`` rendezvous under the test's tmp_path), on inputs made here
with numpy and JAX, and returns what each rank computed
(tests/_torch_mesh.py). tests/test_torch_mesh_sizes.py runs the same
checks (``check_*``) on 3 and 4 ranks.

Tolerances: the float64 mesh step against the one-process step on the
same global batch within 1e-10 of each tensor's peak (the shares' means
and the gradient sum reorder float64 sums; measured 2.6e-13), the
metrics of the float32 model outputs (cos_sim, er) within 1e-6 (a
float32 mean of means; measured 6.7e-8); against
JAX's ``make_sharded_train_step`` at the float64 bounds of
tests/test_torch_train.py (losses rtol 1e-5, weights, statistics and Adam
moments atol 1e-5). Ranks, grids and ERs are held equal exactly.
"""

import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh as tm
from _torch_parity import small_sources, strip_flat, vad_variables, \
    write_dev_set
from challenge_tpu.config import Config as JConfig
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.parallel import launch
from challenge_tpu_torch.parallel import mesh as mesh_lib
from challenge_tpu_torch.train import callbacks as cb

CFG = dict(model_type='vad', v=3, n_mels=tm.N_MELS, n_frame=tm.N_FRAME,
           batch_size=8)
SHAPE = (tm.N_MELS, tm.N_FRAME, 2)
EVAL_CFG = dict(model_type='vad', v=8, n_mels=tm.N_MELS,
                n_frame=tm.N_FRAME, n_chan=2)


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_inputs(tmp_path_factory, batch: int, fused_batch: int) -> dict:
    """The ranks' inputs: vad v3 (base_fsize 8, td_dim 32) from JAX's
    numpy-filled variables, two global batches of ``batch``, spec sources
    for the fused step (``fused_batch``), and the small vad v8 with a dev
    set of 3 clips."""
    jm = JVADModel(v=3, base_fsize=8, td_dim=32)
    variables = vad_variables(jm, SHAPE, seed=3)
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((batch,) + SHAPE),
                (rng.random((batch, tm.N_FRAME // 32, 3)) > 0.5).astype(
                    np.float64)) for _ in range(2)]
    ev = tm.bundle(EVAL_CFG)
    ev.init(5)
    with torch.no_grad():      # class 0 fires, 1 varies, 2 rests
        ev.module.state_dict()['fcs.3.dense.bias'].copy_(
            torch.tensor([1.5, 0.0, -1.5]))
    dev = write_dev_set(tmp_path_factory.mktemp('dev'),
                        seconds=(2.0, 2.7, 3.3))
    cfg = dict(CFG, batch_size=batch)
    return dict(
        variables=variables, batches=batches,
        init={k: v.double().numpy()
              for k, v in flax_to_state_dict(variables).items()},
        cfg=cfg, sources=small_sources(1),
        fused_cfg=dict(cfg, batch_size=fused_batch, grad_accum=2,
                       steps_per_call=2),
        eval_cfg=EVAL_CFG, dev=str(dev),
        eval_init={k: v.numpy().copy()
                   for k, v in ev.module.state_dict().items()})


def run_ranks(inputs: dict, size: int, d) -> list:
    """What the ranks of one ``size``-rank CPU mesh computed."""
    args = {k: v for k, v in inputs.items() if k != 'variables'}
    return launch.run('_torch_mesh:rank_checks', (args,), ['cpu'] * size,
                      workdir=str(d))


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory, 8, 4)


@pytest.fixture(scope='module')
def ranks(inputs, tmp_path_factory):
    """What ranks 0 and 1 of one 2-rank CPU mesh computed."""
    return run_ranks(inputs, 2, tmp_path_factory.mktemp('mesh'))


def one_process_run(inputs: dict):
    return (tm.train_steps(inputs['cfg'], inputs['init'], inputs['batches']),
            tm.eval_grids(EVAL_CFG, inputs['eval_init'], inputs['dev']))


@pytest.fixture(scope='module')
def one_process(inputs):
    return one_process_run(inputs)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def check_shard_banks(sources, dtype: str, size: int) -> None:
    """Host-built banks split over ``size`` devices: device d's block of
    every bank equals what JAX's ``shard_banks`` puts on its device d of
    ``make_mesh(size)``, the cyclic padding included (the voices' labels
    with them; an int8 bank's scales with it). Returns the whole banks."""
    from challenge_tpu.data.pipeline import build_banks as jbuild
    from challenge_tpu.parallel import mesh as jmesh
    jm = jmesh.make_mesh(size)
    jb = jmesh.shard_banks(jbuild(*sources, n_frame=tm.N_FRAME,
                                  flat_dtype=dtype, host=True), jm)
    pb = build_banks(*sources, n_frame=tm.N_FRAME, flat_dtype=dtype,
                     device='cpu')

    def block(x, d):
        return next(np.asarray(s.data) for s in x.addressable_shards
                    if s.device == jm.devices[d])
    for d in range(size):
        got = mesh_lib.shard_banks(pb, mesh_lib.Mesh(('cpu',) * size, d))
        np.testing.assert_array_equal(got.voice_labels.numpy(),
                                      block(jb.voice_labels, d))
        for which in ('backgrounds', 'voices', 'noises'):
            g, j = getattr(got, which), getattr(jb, which)
            assert g.n == j.lens.shape[0] // size
            np.testing.assert_array_equal(g.lens.numpy(), block(j.lens, d))
            np.testing.assert_array_equal(g.pos_mask.numpy(),
                                          block(j.pos_mask, d))
            rows = g.flat.shape[1]
            np.testing.assert_array_equal(
                g.flat.float().numpy(),
                strip_flat(block(j.flat, d)[:, :rows].astype(np.float32),
                           4, 257))
            if dtype == 'int8':
                np.testing.assert_array_equal(g.flat_scale.numpy(),
                                              block(j.flat_scale, d))
            assert g.contig_exact_frames == getattr(pb,
                                                    which).contig_exact_frames
    return pb


@pytest.mark.parametrize('dtype', ['float32', 'int8'])
def test_shard_banks_places_what_jax_places(dtype):
    """Host-built banks split over 2 devices as JAX's ``shard_banks``
    splits them (5 voices -> 6, their labels with them; an int8 bank's
    scales with it)."""
    pb = check_shard_banks(small_sources(1), dtype, 2)
    assert pb.voices.n == 5


def jax_mesh_run(inputs: dict, size: int) -> dict:
    """JAX's ``make_sharded_train_step`` over ``make_mesh(size)`` of the
    host devices, in float64, on the same init and global batches: the
    losses, the state_dict and the Adam moments."""
    from challenge_tpu.parallel import mesh as jmesh
    from challenge_tpu.parallel.train import make_sharded_train_step
    from challenge_tpu.train.state import TrainState as JState
    with jax.enable_x64(True):
        jm = JVADModel(v=3, base_fsize=8, td_dim=32, dtype=jnp.float64)
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 inputs['variables'])
        mesh = jmesh.make_mesh(size)
        step, opt = make_sharded_train_step(
            JBundle(jm, SHAPE, JConfig(**inputs['cfg'])), mesh)
        params = variables['params']
        # placed as the step's outputs are, so its second call reuses the
        # first one's program
        state = jmesh.replicate(JState(
            step=jnp.zeros([], jnp.int32), params=params,
            batch_stats=variables['batch_stats'], opt_state=opt.init(params),
            swa_params=params, swa_batch_stats=variables['batch_stats'],
            swa_count=jnp.zeros([], jnp.int32)), mesh)
        losses = []
        for i, batch in enumerate(inputs['batches']):
            state, metrics = step(state, jmesh.shard_batch(batch, mesh),
                                  jmesh.replicate(jax.random.PRNGKey(i),
                                                  mesh))
            losses.append(float(metrics['loss']))
        state = jax.device_get(state)
    adam = state.opt_state.inner_state[1]
    return dict(losses=losses, sd=flax_to_state_dict(
        {'params': state.params, 'batch_stats': state.batch_stats}),
        **{w: flax_to_state_dict({'params': getattr(adam, w)})
           for w in ('m', 'v')})


@pytest.fixture(scope='module')
def jax_run(inputs):
    return jax_mesh_run(inputs, 2)


def _assert_jax(got, ref):
    """float64 bounds of tests/test_torch_train.py."""
    np.testing.assert_allclose([float(m['loss']) for m in got['logs']],
                               ref['losses'], rtol=1e-5)
    for part in ('sd', 'm', 'v'):
        assert set(ref[part]) == set(got[part])
        for k, v in ref[part].items():
            np.testing.assert_allclose(got[part][k], v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f'{part} {k}')


def test_one_process_step_equals_jax_mesh_step(jax_run, one_process):
    """The port's one-process step on the global batch is what JAX's mesh
    step computes (the reference the mesh is held to below)."""
    _assert_jax(one_process[0], jax_run)


def check_identical_ranks(ranks, size: int, names) -> None:
    """A gloo mesh of ``size`` ranks whose states, optimizer slots and
    logs in each of the runs ``names`` equal bit for bit."""
    assert [r['rank'] for r in ranks] == list(range(size))
    assert {r['backend'] for r in ranks} == {'gloo'}
    for name in names:
        a = ranks[0][name]
        for b in ranks[1:]:
            b = b[name]
            for part in ('sd', 'm', 'v'):
                assert a[part].keys() == b[part].keys()
                assert all(np.array_equal(a[part][k], b[part][k])
                           for k in a[part]), (name, part)
            for la, lb in zip(a['logs'], b['logs']):
                assert all(np.array_equal(la[k], lb[k]) for k in la), name


def test_the_ranks_are_a_gloo_mesh_that_keeps_them_identical(ranks):
    check_identical_ranks(ranks, 2, ('sharded', 'fused_f32', 'fused_int8'))


def check_sharded_step(inputs, got, ref) -> None:
    """Loss and metrics, weights, BN running statistics and both Adam
    moments of the mesh run ``got`` against the one-process run ``ref``:
    float64 within 1e-10 of each tensor's peak, the float32 outputs'
    metrics within 1e-6."""
    assert got['step'] == ref['step'] == 2
    for lg, lr in zip(got['logs'], ref['logs']):
        np.testing.assert_array_equal(lg['f1_counts'], lr['f1_counts'])
        assert _rel(lg['loss'], lr['loss']) <= 1e-10
        for k in ('cos_sim', 'er'):       # of the float32 model outputs
            assert _rel(lg[k], lr[k]) <= 1e-6, k
    for part in ('sd', 'm', 'v'):
        assert got[part].keys() == ref[part].keys()
        for k in ref[part]:
            assert _rel(got[part][k], ref[part][k]) <= 1e-10, (part, k)
    assert all(not np.array_equal(got['sd'][k], inputs['init'][k])
               for k in got['sd'] if 'running' in k)


def test_sharded_step_equals_the_one_process_step(inputs, ranks,
                                                  one_process):
    """Loss and metrics, weights, BN running statistics and both Adam
    moments after 2 float64 steps over the 2-rank mesh equal the
    one-process steps on the same global batches."""
    check_sharded_step(inputs, ranks[0]['sharded'], one_process[0])


def check_per_replica(ranks, ref) -> None:
    """The mesh step with each rank's BN statistics over its share only
    (DDP's default): the ranks' running statistics part, and the weights
    and loss leave the one-process step ``ref`` by far more than the
    bound the cross-replica step holds."""
    got = ranks[0]['per_replica']
    for other in ranks[1:]:
        other = other['per_replica']
        assert not all(np.array_equal(got['sd'][k], other['sd'][k])
                       for k in got['sd'] if 'running' in k)
    assert _rel(got['logs'][0]['loss'], ref['logs'][0]['loss']) > 1e-3
    worst = max(_rel(got['sd'][k], ref['sd'][k]) for k in ref['sd'])
    assert worst > 1e-3


def test_per_replica_statistics_fail_that_bound(ranks, one_process):
    """The same mesh step with each rank's BN statistics over its share
    only (DDP's default): the ranks' running statistics part, and the
    weights and loss leave the one-process step by far more than the
    bound the cross-replica step holds."""
    check_per_replica(ranks, one_process[0])


def test_sharded_step_matches_jax_make_sharded_train_step(jax_run, ranks):
    """Each rank's state after the mesh steps, against JAX's mesh step."""
    for r in ranks:
        _assert_jax(r['sharded'], jax_run)


def check_fused(ranks, size: int) -> None:
    """grad_accum 2 and steps_per_call 2 over the mesh: each call advances
    the step by steps_per_call (JAX's scan, parallel/train.py:218-225),
    the optimizer counts the same steps, and with --bank_shard's int8
    banks each rank holds ceil(5 / size) of the 5 voices padded
    cyclically."""
    for name in ('fused_f32', 'fused_int8'):
        for r in ranks:
            assert r[name]['step'] == r[name]['opt_step'] == 4
            assert all(np.isfinite(float(m['loss'])) for m in r[name]['logs'])
    assert ranks[0]['fused_f32']['n_voices'] == 5
    assert [r['fused_int8']['n_voices'] for r in ranks] == \
        [-(-5 // size)] * size


def test_fused_mesh_step_accumulates_and_advances_as_jax(ranks):
    """grad_accum 2 and steps_per_call 2 over the mesh: each call advances
    the step by steps_per_call (JAX's scan, parallel/train.py:218-225),
    the optimizer counts the same steps, and with --bank_shard's int8
    banks each rank holds half of the 5 voices padded to 6."""
    check_fused(ranks, 2)


def check_eval(ranks, ref) -> None:
    """3 clips over the mesh: the batched chain (one chunk, and chunks of
    2 clips), the per-clip chain and evaluate's ERs are the one-process
    ones ``ref``, on every rank."""
    assert any(g.any() for g in ref['grids'])
    for r in ranks:
        got = r['eval']
        assert got['ers'] == ref['ers'] == got['ers_per_clip']
        for name in ('grids', 'chunked'):
            assert len(got[name]) == 3
            for a, b in zip(got[name], ref['grids']):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(got['per_clip'], ref['per_clip']):
            np.testing.assert_array_equal(a, b)


def test_evaluate_over_the_mesh_equals_one_process(ranks, one_process):
    """3 clips over 2 ranks: the batched chain (one chunk, and chunks of
    2 clips), the per-clip chain and evaluate's ERs are the one-process
    ones, on both ranks."""
    check_eval(ranks, one_process[1])


@pytest.mark.parametrize('target,match', [
    ('_torch_mesh:fail_on', 'rank 1 exited with code 1'),
    ('_torch_mesh:no_such_function', 'rank 1 exited with code 1 before '
                                     'the rendezvous')])
def test_a_failing_rank_fails_the_run(tmp_path, target, match):
    """A rank that raises mid-run (while rank 0 waits in a collective), or
    dies before the rendezvous, makes ``launch.run`` raise at once, naming
    it; nothing is left running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        launch.run(target, (1,), ['cpu', 'cpu'], workdir=str(tmp_path))
    assert time.monotonic() - t0 < 30
    assert mesh_lib.current() is None
    assert not list(tmp_path.iterdir())


def test_only_rank_0_writes_but_every_rank_decides(tmp_path, monkeypatch):
    """On rank 1 the CSV log, ModelCheckpoint, TrainStateCheckpoint and
    TensorBoard write nothing, while ModelCheckpoint and EarlyStopping
    track the same best as on rank 0 and stop at the same epoch."""
    monkeypatch.chdir(tmp_path)
    written = []
    monkeypatch.setitem(
        sys.modules, 'torch.utils.tensorboard',
        types.SimpleNamespace(SummaryWriter=lambda d: written.append(d)))
    logs = [{'val_loss': 1.0, 'loss': 1.0}, {'val_loss': 0.5, 'loss': 1.0},
            {'val_loss': 0.7, 'loss': 1.0}, {'val_loss': 0.8, 'loss': 1.0}]
    stops = {}
    for rank in (1, 0):
        monkeypatch.setattr(mesh_lib, '_current',
                            mesh_lib.Mesh(('cpu', 'cpu'), rank))
        loop = _StubLoop()
        cbs = [cb.CSVLogger(f'r{rank}.csv'),
               cb.ModelCheckpoint(f'r{rank}.h5'),
               cb.EarlyStopping(patience=2), cb.TensorBoard(f'tb{rank}'),
               cb.TrainStateCheckpoint(f'ck{rank}', every_epochs=1)]
        for c in cbs:
            c.set_loop(loop)
        for epoch, log in enumerate(logs):
            for c in cbs:
                c.on_epoch_end(epoch, dict(log))
            if loop.stop_training:
                break
        stops[rank] = (epoch, cbs[1].best, cbs[2].best)
    assert stops[0] == stops[1] == (3, 0.5, 0.5)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ['ck0', 'r0.csv', 'r0.h5']
    assert written == ['tb0']


class _StubLoop:
    """The loop surface the callbacks read: a one-layer model's state."""

    def __init__(self):
        from challenge_tpu_torch.train.optim import make_optimizer
        from challenge_tpu_torch.train.state import TrainState
        module = torch.nn.Linear(2, 1)
        self.state = TrainState(module, make_optimizer(
            Config(**CFG), module.parameters()), swa={}, swa_count=0)
        self.bundle = None
        self.stop_training = False

    def get_weights(self):
        return {k: v.clone() for k, v in self.state.module.state_dict()
                .items()}

    def set_weights(self, w):
        self.state.module.load_state_dict(w)


def test_torchrun_world_must_match_the_policy(monkeypatch):
    """Under torchrun's WORLD_SIZE the ranks are the visible devices, and
    a policy that would train on fewer raises instead of training each
    rank alone."""
    monkeypatch.setenv('TORCHELASTIC_RUN_ID', 'x')
    monkeypatch.setenv('WORLD_SIZE', '2')
    config = Config(**dict(CFG, batch_size=3))
    with pytest.raises(ValueError, match='2 ranks were started'):
        mesh_lib.mesh_for_config(config, torch.device('cpu'))


def test_a_mesh_needs_banks_mode_and_exclusive_capacity_axes():
    """JAX's ValueErrors: a stream rotation with --bank_shard on a mesh;
    the port's: a mesh in iterator mode."""
    from challenge_tpu_torch.data.streaming import build_streaming_banks
    from challenge_tpu_torch.train.loop import TrainLoop
    b = tm.bundle(dict(CFG, batch_size=2, bank_shard=True))
    mesh = mesh_lib.Mesh(('cpu', 'cpu'), 0)
    with pytest.raises(ValueError, match='banks mode'):
        TrainLoop(b, mesh=mesh)
    stream = build_streaming_banks(*small_sources(1), n_chunks=2,
                                   n_frame=tm.N_FRAME, device='cpu')
    with pytest.raises(ValueError, match='exclusive'):
        TrainLoop(b, banks=stream, mesh=mesh)
