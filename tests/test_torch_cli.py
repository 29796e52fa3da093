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
import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

from _helpers import DATA_FLAGS, make_datafiles, write_wav
from _torch_parity import N_FRAME, N_MELS, small_sources, vad_variables
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
from challenge_tpu_torch.train import callbacks as cb
from challenge_tpu_torch.train import checkpoint
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.optim import custom_scheduler

ARGV = ['--model_type', 'vad', '--v', '3', '--n_frame', '64',
        '--batch_size', '2', '--epochs', '3', '--steps_per_epoch', '2']


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


@pytest.mark.parametrize('flag', [['--keras_ckpt', 'True'],
                                  ['--ckpt_dir', 'ck'],
                                  ['--resume', 'True'],
                                  ['--stream_chunks', '2'],
                                  ['--bank_shard', 'True']])
def test_sj_train_refuses_unported_flags(tmp_path, monkeypatch, flag):
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    with pytest.raises(NotImplementedError, match='ROADMAP A1[45]'):
        sj_train.main(ARGV + DATA_FLAGS + flag + ['--device', 'cpu'])


def test_eval_cli_refuses_aot_export():
    with pytest.raises(NotImplementedError, match='ROADMAP A15'):
        eval_cli.main(['--name', 'x', '--export_aot', 'a', '--device',
                       'cpu'])


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
        optimizer=torch.optim.SGD(module.parameters(), lr=0.5)))
    sched = cb.LearningRateScheduler(custom_scheduler(4096, 12 / 12, 2.0))
    sched.set_loop(loop)
    jsched = joptim.custom_scheduler(4096, 12 / 12, 2.0)
    for epoch in range(12):
        sched.on_epoch_begin(epoch)
        assert loop.state.optimizer.param_groups[0]['lr'] == jsched(epoch)


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


def test_banks_mode_draws_per_seed_epoch_and_phase():
    """The batches of an epoch depend on (seed, epoch, phase) only."""
    a, b = _banks_loop(0), _banks_loop(0)
    x = list(a._batches(None, 2, True, epoch=3))
    y = list(b._batches(None, 2, True, epoch=3))
    assert all(torch.equal(u[0], v[0]) for u, v in zip(x, y))
    other = list(a._batches(None, 1, True, epoch=4))[0][0]
    val = list(a._batches(None, 1, False, epoch=3))[0][0]
    assert not torch.equal(other, x[0][0]) and not torch.equal(val, x[0][0])
    hist = a.fit(epochs=2, steps_per_epoch=1, validation_steps=1, verbose=0,
                 initial_epoch=1)
    assert len(hist) == 1 and np.isfinite(hist[0]['val_loss'])
    assert a.state.step == 1 and not a.stop_training


@pytest.mark.parametrize('field', ['steps_per_call', 'grad_accum'])
def test_loop_refuses_unported_scale_out(field):
    bundle = ModelBundle(VADModel(v=8, base_fsize=8, td_dim=32,
                                  n_mels=N_MELS), (N_MELS, N_FRAME, 2),
                         Config(model_type='vad', v=8, **{field: 2}),
                         torch.device('cpu'))
    with pytest.raises(NotImplementedError, match='ROADMAP A14'):
        TrainLoop(bundle)


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
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    pm.reset_parameters(torch.Generator().manual_seed(3))
    path = str(tmp_path / 'run_SWA.h5')
    checkpoint.save_weights(path, pm.state_dict())
    back = checkpoint.load_weights(path)
    assert set(back) == set(pm.state_dict())
    assert all(torch.equal(back[k], v) for k, v in pm.state_dict().items())
    assert not (tmp_path / 'run_SWA.h5.tmp').exists()
    with pytest.raises(NotImplementedError, match='ROADMAP A15'):
        checkpoint.save_weights(path, pm.state_dict(), keras=True)
    (tmp_path / 'k.h5').write_bytes(b'\x89HDF\r\n\x1a\n' + b'\0' * 8)
    with pytest.raises(NotImplementedError, match='ROADMAP A15'):
        checkpoint.load_weights(str(tmp_path / 'k.h5'))
