"""The port's CLIs, callbacks, loop and checkpoints
(challenge_tpu_torch/cli/, train/callbacks.py, train/loop.py,
train/checkpoint.py) against the JAX package.

The CLI runs on the CPU (``--device cpu``) at a small size on the pickled
spec sets of ``tests/_helpers.make_datafiles``. The callbacks are held
against JAX's on stub loops: the same epochs fold SWA, stop early and
restore the same weights, set the same learning rates and stop on a NaN.
A JAX-written msgpack checkpoint, decoded and bridged, gives the port the
forward of the JAX model within 1e-5 (float32, reduction order); the
port's own checkpoints round-trip exactly.
"""

import csv
import dataclasses
import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

from _helpers import DATA_FLAGS, make_datafiles, write_wav
from _torch_parity import (
    N_FRAME, N_MELS, shape_bundle, small_sources, vad_variables)
from challenge_tpu import config as jconfig
from challenge_tpu.train import callbacks as jcb
from challenge_tpu.train import optim as joptim
from challenge_tpu_torch.cli import eval as eval_cli
from challenge_tpu_torch.cli import sj_train
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.parallel import mesh
from challenge_tpu_torch.train import callbacks as cb
from challenge_tpu_torch.train import checkpoint
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.optim import KerasAdam, custom_scheduler

ARGV = ['--model_type', 'vad', '--v', '3', '--n_frame', '64',
        '--batch_size', '2', '--epochs', '3', '--steps_per_epoch', '2']


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """As tests/test_torch_fused.py: on every core, each of the suite's
    workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('bank_dtype', ['float32', 'int8'])
def test_sj_train_then_eval_cli_on_the_cpu(tmp_path, monkeypatch, capsys,
                                           bank_dtype):
    """3 epochs x 2 steps: ModelCheckpoint writes {run}.h5, SWA folds at
    epoch 1, EvalCallback scores the dev set at epoch 2 and writes
    _sample.h5, the CLI writes _SWA.h5; then the eval CLI with --p."""
    monkeypatch.chdir(tmp_path)
    # no tensorboard writer: its import pulls in TensorFlow here
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    make_datafiles(tmp_path)
    write_wav(tmp_path / 'clip01.wav', seconds=4.0, seed=1, tone_hz=440)
    with open(tmp_path / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': {'clip01': [[0, 1.0, 2.0]]}}, f)
    argv = ARGV + ['--datapath', str(tmp_path), '--bank_dtype',
                   bank_dtype] + DATA_FLAGS
    run = sj_train.main(argv + ['--device', 'cpu'])
    assert run == jconfig.config_from_args(argv).run_name()
    for suffix in ('.h5', '_SWA.h5', '_sample.h5', '.csv'):
        assert (tmp_path / f'{run}{suffix}').exists(), suffix
    with open(tmp_path / f'{run}.csv') as f:
        rows = list(csv.reader(f))
    assert len(rows) == 4 and rows[0][0] == 'epoch'
    assert [r[0] for r in rows[1:]] == ['0', '1', '2']
    assert 'val_er' in rows[0] and 'challenge_er' not in rows[0]
    out = capsys.readouterr().out
    assert 'WARNING: TensorBoard logging disabled' in out
    assert 'Saving Weights...  1' in out and 'FINAL SCORE' in out
    ers = eval_cli.main(['--name', run, '--p', '--device', 'cpu'])
    assert len(ers) == 1 and np.isfinite(ers[0])


def _jax_reads_the_trio(jb, stems, pb):
    """Each of the files ``stems`` is a Keras HDF5 file that JAX's
    ``load_weights(..., bundle=)`` reads to the state_dict the port's
    ``load_weights`` reads, exactly."""
    from challenge_tpu.train import checkpoint as jckpt
    for stem in stems:
        with open(stem, 'rb') as f:
            assert f.read(8) == checkpoint._HDF5_MAGIC, stem
        ref = flax_to_state_dict(jax.device_get(
            jckpt.load_weights(stem, None, bundle=shape_bundle(jb))))
        got = checkpoint.load_weights(stem, 'cpu', pb)
        assert got.keys() == ref.keys() == pb.module.state_dict().keys()
        assert all(torch.equal(got[k], ref[k]) for k in ref), stem


@pytest.mark.parametrize('flag', [['--keras_ckpt', 'True'],
                                  ['--bank_shard', 'True']])
def test_sj_train_refuses_unported_flags(tmp_path, monkeypatch, flag):
    """``--bank_shard`` where two devices divide the batch, so JAX would
    shard the banks over a mesh (ROADMAP A14, C14). ``--keras_ckpt``, once
    refused here (A15), now trains: 3 epochs of 2 steps on int8 banks and
    32 mels
    write {run}.h5, _SWA.h5 and, from the eval callback at epoch 2,
    _sample.h5 as Keras HDF5 files that JAX reads."""
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    if flag[0] == '--keras_ckpt':
        from challenge_tpu.models import get_model as jget_model
        from challenge_tpu_torch.models.registry import get_model
        monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
        write_wav(tmp_path / 'clip01.wav', seconds=4.0, seed=1, tone_hz=440)
        with open(tmp_path / 'sample_answer.json', 'w') as f:
            json.dump({'task2_answer': {'clip01': [[0, 1.0, 2.0]]}}, f)
        argv = ARGV + DATA_FLAGS + ['--bank_dtype', 'int8', '--n_mels',
                                    '32'] + flag
        run = sj_train.main(argv + ['--device', 'cpu'])
        jcfg = jconfig.config_from_args(argv)
        _jax_reads_the_trio(
            jget_model(jcfg), [f'{run}{s}.h5' for s in ('', '_SWA',
                                                       '_sample')],
            get_model(Config(**dataclasses.asdict(jcfg)), device='cpu'))
        return
    monkeypatch.setattr(mesh, 'device_count', lambda device: 2)
    with pytest.raises(NotImplementedError, match='ROADMAP A1[45]'):
        sj_train.main(ARGV + DATA_FLAGS + flag + ['--device', 'cpu'])


# ------------------------------------------------ the device policy (C14)
POLICY_CASES = [  # (visible devices, --n_devices, batch, --bank_shard)
    (1, 0, 12, False), (1, 0, 12, True), (1, 4, 12, False),
    (2, 0, 12, False), (2, 1, 12, True), (2, 1, 12, False),
    (5, 0, 12, False), (5, 0, 12, True), (8, 3, 12, False),
    (8, 0, 2, False), (4, 0, 2, True), (8, 0, 8, True)]


@pytest.mark.parametrize('avail,n_devices,batch,bank_shard', POLICY_CASES)
def test_device_policy_is_jax_mesh_for_config(monkeypatch, capsys, avail,
                                              n_devices, batch,
                                              bank_shard):
    """ROADMAP C14: over the same device count, JAX's ``mesh_for_config``
    and the port's ``devices_for_config`` print the same lines and raise
    the same ValueErrors; where JAX trains single-device the port returns
    1, and where JAX builds a mesh the port raises naming A14."""
    from challenge_tpu.parallel import mesh as jmesh
    cfg = dict(model_type='vad', v=8, n_devices=n_devices,
               batch_size=batch, bank_shard=bank_shard)
    monkeypatch.setattr(jmesh.jax, 'devices',
                        lambda devices=jax.devices(): devices[:avail])
    monkeypatch.setattr(mesh, 'device_count', lambda device: avail)
    try:
        ref = jmesh.mesh_for_config(jconfig.Config(**cfg))
    except ValueError as e:
        ref = e
    jax_out = capsys.readouterr().out
    if isinstance(ref, ValueError):
        with pytest.raises(ValueError) as got:
            mesh.devices_for_config(Config(**cfg), torch.device('cpu'))
        assert str(got.value) == str(ref)
    elif ref is None:
        assert mesh.devices_for_config(Config(**cfg),
                                       torch.device('cpu')) == 1
    else:
        assert ref.devices.size > 1
        with pytest.raises(NotImplementedError,
                           match=f'mesh over {ref.devices.size} devices.*'
                                 'ROADMAP A14'):
            mesh.devices_for_config(Config(**cfg), torch.device('cpu'))
    assert capsys.readouterr().out == jax_out


def test_device_count_is_cuda_s_or_one_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 3)
    assert mesh.device_count(torch.device('cuda', 0)) == 3
    assert mesh.device_count(torch.device('cpu')) == 1


@pytest.mark.parametrize('cli,count,flags,expect', [
    ('sj_train', 1, ['--n_devices', '2'], 'trains'),
    ('sj_train', 2, ['--batch_size', '12'], 'A14'),
    ('sj_train', 5, [], 'does not divide'),
    ('sj_train', 1, ['--bank_shard', 'True'], 'bank_shard has no effect'),
    ('sj_train', 2, ['--n_devices', '1', '--bank_shard', 'True'],
     'n_devices caps it'),
    ('trainer', 1, ['--n_devices', '2'], 'trains'),
    ('trainer', 2, ['--batch_size', '12'], 'A14'),
    ('trainer', 5, [], 'does not divide'),
    ('trainer', 5, ['--bank_shard', 'True'], 'does not divide the 5')])
def test_clis_follow_the_device_policy(tmp_path, monkeypatch, capsys, cli,
                                       count, flags, expect):
    """Both CLIs take JAX's policy over the (monkeypatched) device count,
    before any data is read: one device trains, with the bank_shard note;
    an indivisible batch trains single-device with JAX's line; a mesh
    raises naming A14; bank_shard that cannot shard raises JAX's
    ValueError."""
    from challenge_tpu_torch.cli import trainer
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    monkeypatch.setattr(mesh, 'device_count', lambda device: count)
    if cli == 'sj_train':
        main = sj_train.main
        argv = ARGV[:-4] + ['--epochs', '1', '--steps_per_epoch', '1']
    else:
        main = trainer.main
        argv = DENSITY_ARGV[:-4] + ['--epochs', '2', '--steps_per_epoch',
                                    '1']
    argv += ['--datapath', str(tmp_path), '--device', 'cpu'] + DATA_FLAGS
    if expect in ('A14', 'n_devices caps it', 'does not divide the 5'):
        err = NotImplementedError if expect == 'A14' else ValueError
        with pytest.raises(err, match=expect):
            main(argv + flags)       # no data files: raised before reading
        return
    make_datafiles(tmp_path)
    main(argv + flags)
    out = capsys.readouterr().out
    assert 'Epoch 1/' in out
    if expect != 'trains':
        assert expect in out


EVAL_RUN = 'vad_v3_lr0.001_batch2_opt_adam_mel32_chan2_BCE_framelen512'


def _eval_run_dir(d, seconds=(2.0, 2.5)):
    """A directory with the Keras checkpoint of ``EVAL_RUN`` (vad v3, 32
    mels x 512 frames, weights from seed 3) and a dev set; returns the
    bundle."""
    from challenge_tpu_torch.models.registry import get_model
    bundle = get_model(Config(model_type='vad', v=3, n_mels=32, n_frame=512,
                              n_chan=2), device='cpu', seed=3)
    checkpoint.save_weights(str(d / f'{EVAL_RUN}.h5'),
                            bundle.module.state_dict(), keras=True,
                            bundle=bundle)
    answers = {}
    for i, secs in enumerate(seconds):
        write_wav(d / f'clip{i}.wav', seconds=secs, seed=i, tone_hz=440)
        answers[f'clip{i}'] = [[0, 0.2, 0.8]]
    with open(d / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': answers}, f)
    return bundle


def test_eval_cli_refuses_aot_export(tmp_path, monkeypatch):
    """``--export_aot``, once refused (A15): the eval CLI reads the Keras
    checkpoint, scores the dev set and writes a ``torch.export`` artifact
    that, loaded without the model, gives the model's outputs."""
    from challenge_tpu_torch.interop.aot import load_infer
    monkeypatch.chdir(tmp_path)
    bundle = _eval_run_dir(tmp_path)
    ers = eval_cli.main(['--name', EVAL_RUN, '--p', '--export_aot',
                         'serve.pt2', '--device', 'cpu'])
    assert len(ers) == 2 and all(np.isfinite(ers))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2,) + bundle.input_shape).astype(np.float32))
    with torch.no_grad():
        want = bundle.module.eval()(x)
    assert torch.equal(load_infer('serve.pt2')(x), want)


def test_eval_cli_export_aot_eval(tmp_path, monkeypatch):
    """``--export_aot_eval``: the eval chain sized to the corpus in the
    working directory; its grids, cut to each clip's valid rows and scored,
    give the CLI's ERs."""
    from challenge_tpu_torch.evaluate import events
    from challenge_tpu_torch.evaluate.infer import _prepare_batched_pcm
    from challenge_tpu_torch.interop.aot import load_infer
    monkeypatch.chdir(tmp_path)
    _eval_run_dir(tmp_path)
    ers = eval_cli.main(['--name', EVAL_RUN, '--p', '--export_aot_eval',
                         'chain.pt2', '--device', 'cpu'])
    pcm, lens = _prepare_batched_pcm(['clip0.wav', 'clip1.wav'])
    grids = load_infer('chain.pt2')(torch.from_numpy(pcm),
                                    torch.from_numpy(lens)).numpy()
    to_metric = events.output_to_metric(256, 16000)
    got = [events.get_er(np.array([[0, 0.2, 0.8]]), to_metric(
        *events.get_start_end_frame(g[:int(n) // 256 + 1])))
        for g, n in zip(grids, lens)]
    assert got == ers


def test_eval_cli_export_aot_eval_needs_a_uniform_corpus(tmp_path,
                                                         monkeypatch):
    """JAX's checks and messages: no ``*.wav`` in the working directory,
    or WAVs of mixed rates, raise before anything is exported."""
    monkeypatch.chdir(tmp_path)
    _eval_run_dir(tmp_path)
    argv = ['--name', EVAL_RUN, '--p', '--export_aot_eval', 'chain.pt2']
    empty = tmp_path / 'empty'
    empty.mkdir()
    monkeypatch.chdir(empty)
    with pytest.raises(ValueError, match='no \\*.wav files here'):
        eval_cli.main(argv + ['--path', str(tmp_path), '--device', 'cpu'])
    monkeypatch.chdir(tmp_path)
    write_wav(tmp_path / 'clip9.wav', seconds=1.0, sr=8000, seed=9)
    with pytest.raises(ValueError, match='mixed-format') as err:
        eval_cli.main(argv + ['--device', 'cpu'])
    assert 'the 3 *.wav files here are mixed-format' in str(err.value)
    assert not (tmp_path / 'chain.pt2').exists()


# ------------------------------------------------------------- callbacks
class _JaxStubLoop:
    """What JAX's callbacks touch: state.weights(), set_weights,
    stop_training."""

    def __init__(self):
        self.epoch, self.restored, self.stop_training = 0, None, False
        self.state = types.SimpleNamespace(
            weights=lambda: {'w': np.array(float(self.epoch))})

    def set_weights(self, w):
        self.restored = float(w['w'])


class _PortStubLoop:
    def __init__(self):
        self.epoch, self.restored, self.stop_training = 0, None, False
        self.state = None

    def get_weights(self):
        return {'w': torch.tensor(float(self.epoch))}

    def set_weights(self, w):
        self.restored = float(w['w'])


def _run_epochs(callback, loop, logs_per_epoch):
    callback.set_loop(loop)
    for epoch, logs in enumerate(logs_per_epoch):
        loop.epoch = epoch
        callback.on_epoch_begin(epoch)
        callback.on_epoch_end(epoch, logs)
        if loop.stop_training:
            return epoch
    return None


def test_swa_folds_at_the_epochs_jax_folds(monkeypatch):
    calls = []
    monkeypatch.setattr(jcb, 'swa_update', lambda s: calls.append(1) or s)
    monkeypatch.setattr(cb, 'swa_update', lambda s: calls.append(1))
    folds = {}
    for side, swa, loop in (('jax', jcb.SWA(12 // 4, 2, verbose=False),
                             _JaxStubLoop()),
                            ('port', cb.SWA(12 // 4, 2, verbose=False),
                             _PortStubLoop())):
        swa.set_loop(loop)
        folds[side] = []
        for epoch in range(12):
            calls.clear()
            swa.on_epoch_end(epoch, {})
            if calls:
                folds[side].append(epoch)
    assert folds['port'] == folds['jax'] == [2, 4, 6, 8, 10]


def test_swa_without_a_fold_raises_and_swaps_in_the_average():
    loop = TrainLoop(ModelBundle(VADModel(v=8, base_fsize=8, td_dim=32,
                                          n_mels=N_MELS),
                                 (N_MELS, N_FRAME, 2),
                                 Config(model_type='vad', v=8),
                                 torch.device('cpu')))
    swa = cb.SWA(start_epoch=100, verbose=False)
    swa.set_loop(loop)
    with pytest.raises(cb.NO_SWA_ERROR, match="Didn't use SWA"):
        swa.on_train_end()
    swa = cb.SWA(start_epoch=1, verbose=False)
    swa.set_loop(loop)
    swa.on_epoch_end(0, {})
    before = loop.get_weights()
    with torch.no_grad():
        for p in loop.state.module.parameters():
            p.add_(1.0)
    swa.on_train_end()
    after = loop.state.module.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before)
    # set_weights copies: the average is not aliased by the module
    next(loop.state.module.parameters()).data.add_(1.0)
    assert all(torch.equal(loop.state.swa[k], before[k]) for k in before)


def test_early_stopping_restores_the_weights_jax_restores():
    losses = [1.0, 0.8, 0.9, 0.7, 0.75, 0.72, 0.71, 0.9]
    logs = [{'val_loss': v} for v in losses]
    jl, pl = _JaxStubLoop(), _PortStubLoop()
    j_stop = _run_epochs(jcb.EarlyStopping('val_loss', patience=3), jl, logs)
    p_stop = _run_epochs(cb.EarlyStopping('val_loss', patience=3), pl, logs)
    assert p_stop == j_stop == 6
    assert pl.restored == jl.restored == 3.0


def test_learning_rate_each_epoch_equals_custom_scheduler():
    module = torch.nn.Linear(2, 2)
    loop = types.SimpleNamespace(state=types.SimpleNamespace(
        optimizer=KerasAdam(module.parameters(), lr=0.5)))
    sched = cb.LearningRateScheduler(custom_scheduler(4096, 12 / 12, 2.0))
    sched.set_loop(loop)
    jsched = joptim.custom_scheduler(4096, 12 / 12, 2.0)
    for epoch in range(12):
        sched.on_epoch_begin(epoch)
        # the optimizer keeps its rate in float32, as JAX's hyperparams
        assert float(loop.state.optimizer.param_groups[0]['lr']) == \
            np.float32(jsched(epoch))


def test_terminate_on_nan_stops_as_jax_does():
    logs = [{'loss': 0.5}, {'loss': 0.4}, {'loss': float('nan')},
            {'loss': 0.3}]
    assert _run_epochs(cb.TerminateOnNaN(), _PortStubLoop(), logs) == \
        _run_epochs(jcb.TerminateOnNaN(), _JaxStubLoop(), logs) == 2


def test_tensorboard_writes_every_scalar_through_the_writer(monkeypatch):
    written = []

    class Writer:
        def __init__(self, log_dir):
            written.append(('dir', log_dir))

        def add_scalar(self, k, v, step):
            written.append((k, v, step))

        def flush(self):
            pass

        def close(self):
            written.append('closed')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard',
                        types.SimpleNamespace(SummaryWriter=Writer))
    tb = cb.TensorBoard('logs/run')
    tb.on_epoch_end(4, {'loss': 0.5, 'val_er': 1.0})
    tb.on_train_end()
    assert written == [('dir', 'logs/run'), ('loss', 0.5, 4),
                       ('val_er', 1.0, 4), 'closed']


# ------------------------------------------------------------- the loop
def _banks_loop(seed):
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 batch_size=2)
    banks = build_banks(*small_sources(1), n_frame=N_FRAME, device='cpu')
    bundle = ModelBundle(VADModel(v=8, base_fsize=8, td_dim=32,
                                  n_mels=N_MELS), (N_MELS, N_FRAME, 2), cfg,
                         torch.device('cpu'))
    return TrainLoop(bundle, seed=seed, banks=banks, val_banks=banks)


def _draws(loop, n, training, epoch):
    """The first n batches banks mode draws in (epoch, phase)."""
    step = loop.train_step if training else loop.eval_step
    gen = loop.phase_gen(epoch, training)
    return [step.features(gen, loop.banks) for _ in range(n)]


def test_banks_mode_draws_per_seed_epoch_and_phase():
    """The batches of an epoch depend on (seed, epoch, phase) only."""
    a, b = _banks_loop(0), _banks_loop(0)
    x = _draws(a, 2, True, epoch=3)
    y = _draws(b, 2, True, epoch=3)
    assert all(torch.equal(u[0], v[0]) for u, v in zip(x, y))
    other = _draws(a, 1, True, epoch=4)[0][0]
    val = _draws(a, 1, False, epoch=3)[0][0]
    assert not torch.equal(other, x[0][0]) and not torch.equal(val, x[0][0])
    hist = a.fit(epochs=2, steps_per_epoch=1, validation_steps=1, verbose=0,
                 initial_epoch=1)
    assert len(hist) == 1 and np.isfinite(hist[0]['val_loss'])
    assert a.state.step == 1 and not a.stop_training


# ------------------------------------------------------------ checkpoints
def test_jax_msgpack_checkpoint_bridges_to_the_same_forward(tmp_path):
    from flax import serialization

    from challenge_tpu.models.vad import VADModel as JVADModel
    from challenge_tpu.train.checkpoint import save_weights as jax_save
    shape = (N_MELS, N_FRAME, 2)
    jm = JVADModel(v=8, base_fsize=8, td_dim=32)
    variables = vad_variables(jm, shape, seed=7)
    jax_save(str(tmp_path / 'run.h5'), variables)
    tree = serialization.msgpack_restore((tmp_path / 'run.h5').read_bytes())
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS).eval()
    pm.load_state_dict(flax_to_state_dict(tree))
    x = np.random.default_rng(2).standard_normal((2,) + shape)
    x = x.astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, x)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_port_checkpoint_round_trips_exactly(tmp_path):
    """``torch.save`` and, with ``keras=True`` and the bundle, Keras HDF5
    (once refused, A15): both round-trip exactly through ``load_weights``,
    which tells them apart by the HDF5 magic and needs the bundle for the
    second."""
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    pm.reset_parameters(torch.Generator().manual_seed(3))
    path = str(tmp_path / 'run_SWA.h5')
    checkpoint.save_weights(path, pm.state_dict())
    back = checkpoint.load_weights(path)
    assert set(back) == set(pm.state_dict())
    assert all(torch.equal(back[k], v) for k, v in pm.state_dict().items())
    assert not (tmp_path / 'run_SWA.h5.tmp').exists()
    bundle = ModelBundle(pm, (N_MELS, N_FRAME, 2),
                         Config(model_type='vad', v=8, n_mels=N_MELS,
                                n_frame=N_FRAME), torch.device('cpu'))
    kpath = str(tmp_path / 'k.h5')
    with pytest.raises(ValueError, match='bundle'):
        checkpoint.save_weights(kpath, pm.state_dict(), keras=True)
    checkpoint.save_weights(kpath, pm.state_dict(), keras=True,
                            bundle=bundle)
    assert not (tmp_path / 'k.h5.tmp').exists()
    back = checkpoint.load_weights(kpath, 'cpu', bundle)
    assert set(back) == set(pm.state_dict())
    assert all(torch.equal(back[k], v) for k, v in pm.state_dict().items())
    with pytest.raises(ValueError, match='Keras HDF5.*bundle'):
        checkpoint.load_weights(kpath)


# ------------------------------------------------------ the density trainer
DENSITY_ARGV = ['--name', 'dens', '--model', 'EfficientNetB0', '--n_chan',
                '2', '--n_mels', '32', '--n_frame', '64', '--batch_size',
                '2', '--epochs', '2', '--steps_per_epoch', '2']


@pytest.fixture(scope='module')
def density_run(tmp_path_factory):
    """``cli.trainer`` on the CPU for 2 epochs of 2 steps (16 validation
    steps each; SWA folds at epoch 0), in a directory of its own; returns
    the directory and the standard output."""
    import contextlib
    import io

    from challenge_tpu_torch.cli import trainer
    d = tmp_path_factory.mktemp('density')
    make_datafiles(d)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(d)
        run = trainer.main(DENSITY_ARGV + ['--datapath', str(d), '--device',
                                           'cpu'] + DATA_FLAGS)
    assert run == 'dens'
    return d, out.getvalue()


def test_trainer_cli_writes_the_trio_and_a_cos_sim_log(density_run):
    """{name}.h5 (best val_loss), {name}_SWA.h5 and the {name}.log CSV,
    whose metrics are cos_sim only, as JAX's (tests/test_cli.py:246-252)."""
    d, out = density_run
    for f in ('dens.h5', 'dens_SWA.h5', 'dens.log'):
        assert (d / f).exists(), f
    with open(d / 'dens.log') as f:
        rows = list(csv.reader(f))
    header = rows[0]
    assert 'cos_sim' in header and 'val_cos_sim' in header
    assert 'er' not in header and 'f1_score' not in header
    assert [r[0] for r in rows[1:]] == ['0', '1']
    assert all(np.isfinite(float(r[header.index(k)])) for r in rows[1:]
               for k in ('loss', 'val_loss', 'cos_sim'))
    assert 'Saving Weights...  0' in out and 'loaded pretrained' not in out
    w = checkpoint.load_weights(str(d / 'dens_SWA.h5'))
    assert w['denses.0.weight'].shape == (3, 1280)


def test_trainer_cli_pretrain_loads_and_cuts_on_plateaus(density_run,
                                                         tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``--pretrain True`` (any value: the reference's bool flag) loads
    {name}.h5 and takes ReduceLROnPlateau instead of the warmup
    schedule, whose learning rate it keeps over 2 epochs. It runs in a
    copy of the first run's directory, which stays as that run left it."""
    import shutil

    from challenge_tpu_torch.cli import trainer
    d = tmp_path / 'run'
    shutil.copytree(density_run[0], d)
    monkeypatch.chdir(d)
    seen = {}

    class Plateau(cb.ReduceLROnPlateau):
        def on_train_begin(self):
            seen['plateau'] = self

    def no_schedule(*a, **kw):
        raise AssertionError('the pretrain branch takes no scheduler')
    loaded = []
    orig = trainer.load_weights
    monkeypatch.setattr(trainer, 'ReduceLROnPlateau', Plateau)
    monkeypatch.setattr(trainer, 'LearningRateScheduler', no_schedule)
    monkeypatch.setattr(trainer, 'load_weights',
                        lambda *a: loaded.append(a[0]) or orig(*a))
    trainer.main(DENSITY_ARGV + ['--pretrain', 'False', '--datapath', str(d),
                                 '--device', 'cpu'] + DATA_FLAGS)
    assert loaded == ['dens.h5']
    assert 'loaded pretrained model' in capsys.readouterr().out
    p = seen['plateau']
    assert (p.monitor, p.factor, p.patience) == ('loss', 0.9, 5)
    assert p.loop.state.optimizer.param_groups[0]['lr'] == 1e-4
    with open(d / 'dens.log') as f:
        assert len(f.read().strip().splitlines()) == 5   # appended


def test_trainer_to_config_equals_jax_field_by_field():
    import dataclasses

    from challenge_tpu.cli import trainer as jtrainer
    from challenge_tpu_torch.cli import trainer
    for argv in (['--name', 'dens'],
                 DENSITY_ARGV + ['--bank_dtype', 'int8', '--pretrain', 'x',
                                 '--lr', '3e-4', '--multiplier', '4',
                                 '--loss_alpha', '0.5', '--seed', '3']):
        jns = jtrainer.build_args().parse_args(argv)
        ns = trainer.build_args().parse_args(argv)
        assert {k: v for k, v in vars(ns).items()
                if k not in ('device', 'datapath')} == \
            {k: v for k, v in vars(jns).items() if k != 'datapath'}
        ref = dataclasses.asdict(jtrainer.to_config(jns))
        got = dataclasses.asdict(trainer.to_config(ns))
        assert set(got) == set(ref)
        for k in ref:
            if k != 'datapath':
                assert got[k] == ref[k], k
        assert got['model'] in ('EfficientNetB4', 'EfficientNetB0')
        assert got['v'] == 0 and got['model_type'] == 'eff'
    assert trainer.build_args().parse_args(['--name', 'x']).datapath == ''


@pytest.mark.parametrize('n_chan', ['1', '3'])
def test_trainer_refuses_n_chan_but_2(n_chan):
    """ROADMAP C9: at the default --n_chan 1 (and 3) the density features
    keep 2 channels, so JAX's first step fails; the port refuses."""
    from challenge_tpu_torch.cli import trainer
    argv = ['--name', 'd', '--device', 'cpu']
    with pytest.raises(ValueError, match='C9'):
        trainer.main(argv + ([] if n_chan == '1' else ['--n_chan', n_chan]))


@pytest.mark.parametrize('flag,item', [
    (['--n_devices', '2'], 'A14'), (['--bank_shard', 'True'], 'A14'),
    (['--keras_ckpt', 'True'], 'A15')])
def test_trainer_refuses_unported_flags(monkeypatch, tmp_path, flag, item):
    """Each unported flag raises naming its ROADMAP item, before any data
    is read; ``--n_devices`` and ``--bank_shard`` where two devices divide
    the default batch of 12, so JAX would build a mesh (C14).
    ``--keras_ckpt``, once refused (A15), now trains: 2 epochs of 2 steps
    write dens.h5 and dens_SWA.h5 as Keras HDF5 files that JAX reads."""
    from challenge_tpu_torch.cli import trainer
    if item == 'A15':
        from challenge_tpu.models.registry import get_density_model as jdens
        from challenge_tpu_torch.models.registry import get_density_model
        monkeypatch.chdir(tmp_path)
        make_datafiles(tmp_path)
        trainer.main(DENSITY_ARGV + flag + ['--datapath', str(tmp_path),
                                            '--device', 'cpu'] + DATA_FLAGS)
        cfg = dict(model_type='eff', model='EfficientNetB0', n_mels=32,
                   n_frame=64, n_chan=2)
        _jax_reads_the_trio(jdens(jconfig.Config(**cfg)),
                            ['dens.h5', 'dens_SWA.h5'],
                            get_density_model(Config(**cfg), device='cpu'))
        return
    monkeypatch.setattr(mesh, 'device_count', lambda device: 2)
    with pytest.raises(NotImplementedError,
                       match=f'{flag[0][2:]}.*ROADMAP {item}'):
        trainer.main(['--name', 'd', '--model', 'EfficientNetB0', '--n_chan',
                      '2', '--device', 'cpu'] + flag)


def test_trainer_runs_on_cuda_unless_told_the_cpu(monkeypatch):
    """Without a GPU and without --device cpu, the CLI raises."""
    from challenge_tpu_torch.cli import trainer
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        trainer.main(['--name', 'd', '--n_chan', '2'])
