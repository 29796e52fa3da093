"""Full-state checkpoints and resume of ``challenge_tpu_torch``
(train/checkpoint.py ``save_train_state``, ``checkpoint_steps``,
``restore_train_state``; train/callbacks.py ``TrainStateCheckpoint``;
the CLIs' ``--ckpt_dir``, ``--resume`` and ``--ckpt_every_epochs``)
against ``challenge_tpu``'s, on the CPU.

* Round trip: every tensor of the state (weights, BN statistics, each
  optimizer's slots, the device ``lr`` and ``step``, the SWA average) and
  the step and SWA count come back exactly, into the live tensors, whose
  addresses (``data_ptr``) stay: a captured step reads them there.
* The schedule: the steps kept after JAX's ``TrainStateCheckpoint`` runs
  on JAX's Orbax manager equal the port's, and the port keeps 3.
* Resume in banks mode: a run stopped after epoch k, saved, restored into
  a fresh loop and run on equals the uninterrupted run bit for bit,
  because each epoch's generators are reseeded by (seed, epoch, phase).
  Also streamed, where the chunk sequence equals the uninterrupted run's
  (tests/test_streaming.py:292).
* The CLIs: JAX's resume line and epoch arithmetic, the CSV continued
  under its header.

Models are shrunk as in test_torch_fused.py: vad v8 at base 8, eff B0 and
the density head on 32 mels x 64 frames, batch 2.
"""

import contextlib
import csv
import io
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _helpers import DATA_FLAGS, make_datafiles, write_wav
from _torch_parity import N_FRAME, N_MELS, small_sources
from challenge_tpu.train import callbacks as jcb
from challenge_tpu.train import checkpoint as jckpt
from challenge_tpu.train.loop import TrainLoop as JTrainLoop
from challenge_tpu_torch.cli import sj_train, trainer
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.data.streaming import build_streaming_banks
from challenge_tpu_torch.models.registry import (
    ModelBundle, get_density_model, get_model)
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.train import callbacks as cb
from challenge_tpu_torch.train import checkpoint
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.optim import AdaBelief, custom_scheduler
from challenge_tpu_torch.train.state import init_state, swa_update

SHAPE = (N_MELS, N_FRAME, 2)
VAD = dict(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
           batch_size=2)
DENSITY_ARGV = ['--name', 'dens', '--model', 'EfficientNetB0', '--n_chan',
                '2', '--n_mels', str(N_MELS), '--n_frame', str(N_FRAME),
                '--batch_size', '2', '--steps_per_epoch', '1']


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """As tests/test_torch_fused.py: on every core, each of the suite's
    workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vad_bundle(base=8, **kw):
    return ModelBundle(VADModel(v=8, base_fsize=base, td_dim=32,
                                n_mels=N_MELS), SHAPE, Config(**VAD, **kw),
                       torch.device('cpu'))


def _trained_state(bundle, seed, steps=2, optimizer=None):
    """A fresh state of ``seed`` after ``steps`` updates on numpy gradients
    and one SWA fold; ``optimizer`` replaces the config's."""
    state = init_state(bundle, seed)
    if optimizer is not None:
        state.optimizer = optimizer(state.module.parameters())
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for p in state.module.parameters():
            p.grad = torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32))
        state.optimizer.step()
        state.step += 1
    swa_update(state)
    return state


def _assert_states_equal(a, b):
    ta = checkpoint.train_state_tensors(a)
    tb = checkpoint.train_state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (a.step, a.swa_count) == (b.step, b.swa_count)


OPTIMIZERS = {
    'adam': None, 'sgd': None, 'rmsprop': None, 'adabelief': None,
    'adabelief_amsgrad': lambda params: AdaBelief(params, lr=1e-3,
                                                  clipvalue=0.01,
                                                  amsgrad=True)}


@pytest.mark.parametrize('opt', list(OPTIMIZERS))
@pytest.mark.parametrize('target_trained', [True, False],
                         ids=['live_slots', 'no_slots_yet'])
def test_train_state_round_trips_into_the_live_tensors(tmp_path, opt,
                                                       target_trained):
    """Every tensor comes back exactly; the live tensors keep their
    addresses, and a slot the target's optimizer has not made yet is made
    as zeros like its parameter, then filled."""
    name = 'adabelief' if opt == 'adabelief_amsgrad' else opt
    bundle = _vad_bundle(optimizer=name)
    saved = _trained_state(bundle, 1, optimizer=OPTIMIZERS[opt])
    checkpoint.save_train_state(str(tmp_path), saved)
    assert checkpoint.checkpoint_steps(str(tmp_path)) == [2]
    assert not any(f.endswith('.tmp') for f in os.listdir(tmp_path))
    want = {k: v.clone() for k, v in
            checkpoint.train_state_tensors(saved).items()}
    target = (_trained_state(bundle, 2, steps=1, optimizer=OPTIMIZERS[opt])
              if target_trained else init_state(bundle, 2))
    if OPTIMIZERS[opt] is not None and not target_trained:
        target.optimizer = OPTIMIZERS[opt](target.module.parameters())
    before = {k: v.data_ptr() for k, v in
              checkpoint.train_state_tensors(target).items()
              if v is not None}
    assert checkpoint.restore_train_state(str(tmp_path), target) is target
    got = checkpoint.train_state_tensors(target)
    assert set(got) == set(want) and all(v is not None for v in got.values())
    for k in want:
        assert torch.equal(got[k], want[k]), k
        if k in before:
            assert got[k].data_ptr() == before[k], k
    assert (target.step, target.swa_count) == (2, 1)
    if target_trained:
        assert len(before) == len(want)
    group = target.optimizer.param_groups[0]
    assert group['lr'].shape == () and group['lr'].device.type == 'cpu'


def test_only_three_steps_are_kept_and_a_saved_step_is_not_rewritten(
        tmp_path):
    """max_to_keep=3; as Orbax's manager does, a step at or below the latest
    kept one is skipped, so a train-end save of the last epoch's step keeps
    that epoch's state."""
    bundle = _vad_bundle()
    state = init_state(bundle, 0)
    for step in (3, 6, 9, 12, 15):
        state.step = step
        checkpoint.save_train_state(str(tmp_path), state)
    assert checkpoint.checkpoint_steps(str(tmp_path)) == [9, 12, 15]
    assert sorted(os.listdir(tmp_path)) == ['12', '15', '9']
    w = next(state.module.parameters())
    kept = w.detach().clone()
    with torch.no_grad():
        w.add_(1.0)
    checkpoint.save_train_state(str(tmp_path), state)      # step 15 again
    checkpoint.save_train_state(str(tmp_path), state, step=10)
    assert checkpoint.checkpoint_steps(str(tmp_path)) == [9, 12, 15]
    checkpoint.restore_train_state(str(tmp_path), state)
    assert torch.equal(w, kept) and state.step == 15
    checkpoint.restore_train_state(str(tmp_path), state, step=9)
    assert state.step == 9


def test_no_checkpoint_raises_file_not_found(tmp_path):
    state = init_state(_vad_bundle(), 0)
    with pytest.raises(FileNotFoundError, match='no checkpoints under'):
        checkpoint.restore_train_state(str(tmp_path / 'none'), state)
    checkpoint.save_train_state(str(tmp_path), _trained_state(
        _vad_bundle(), 0))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(tmp_path), state, step=7)


@pytest.mark.parametrize('other', ['wider_model', 'other_optimizer'])
def test_a_checkpoint_of_another_state_raises_before_copying(tmp_path,
                                                             other):
    """JAX's diagnosis (checkpoint.py:113-125), never a partial load."""
    checkpoint.save_train_state(str(tmp_path), _trained_state(
        _vad_bundle(), 0))
    bundle = (_vad_bundle(base=16) if other == 'wider_model'
              else _vad_bundle(optimizer='sgd'))
    target = _trained_state(bundle, 3, steps=1)
    before = {k: v.clone() for k, v in
              checkpoint.train_state_tensors(target).items()}
    with pytest.raises(ValueError, match='does not match the current '
                                         'train-state structure'):
        checkpoint.restore_train_state(str(tmp_path), target)
    after = checkpoint.train_state_tensors(target)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert target.step == 1


# ------------------------------------------------------------- the schedule
@pytest.fixture
def jax_state_cls():
    import flax

    @flax.struct.dataclass
    class State:
        step: jax.Array
        w: jax.Array
    return State


def _jax_schedule(d, state_cls, epochs, every, spe, initial_epoch=0):
    """JAX's TrainStateCheckpoint over epochs [initial_epoch, epochs) of
    ``spe`` steps each, on its Orbax manager; the steps it keeps."""
    loop = types.SimpleNamespace(state=state_cls(
        jnp.int32(initial_epoch * spe), jnp.zeros(2)))
    c = jcb.TrainStateCheckpoint(d, every_epochs=every)
    c.set_loop(loop)
    for epoch in range(initial_epoch, epochs):
        loop.state = loop.state.replace(step=jnp.int32((epoch + 1) * spe))
        c.on_epoch_end(epoch, {})
    c.on_train_end()
    return jckpt.checkpoint_steps(d)


def _port_schedule(d, epochs, every, spe, initial_epoch=0):
    loop = types.SimpleNamespace(state=init_state(_vad_bundle(), 0))
    c = cb.TrainStateCheckpoint(d, every_epochs=every)
    c.set_loop(loop)
    for epoch in range(initial_epoch, epochs):
        loop.state.step = (epoch + 1) * spe
        c.on_epoch_end(epoch, {})
    c.on_train_end()
    return checkpoint.checkpoint_steps(d)


@pytest.mark.parametrize('epochs,every,spe', [(2, 1, 2), (5, 2, 3),
                                              (4, 10, 1)])
def test_checkpoint_schedule_keeps_the_steps_jax_keeps(tmp_path,
                                                       jax_state_cls,
                                                       epochs, every, spe):
    """Every ``every`` epochs and at train end, the last 3, then a resumed
    run from epoch 1 on the same directory."""
    j = _jax_schedule(str(tmp_path / 'jax'), jax_state_cls, epochs, every,
                      spe)
    p = _port_schedule(str(tmp_path / 'port'), epochs, every, spe)
    assert p == j
    j = _jax_schedule(str(tmp_path / 'jax'), jax_state_cls, epochs + 2,
                      every, spe, initial_epoch=epochs)
    p = _port_schedule(str(tmp_path / 'port'), epochs + 2, every, spe,
                       initial_epoch=epochs)
    assert p == j


@pytest.mark.parametrize('spc,spe,step', [(1, 3, 7), (2, 3, 8), (2, 4, 9),
                                          (4, 1, 12), (3, 0, 6)])
def test_initial_epoch_is_jax_arithmetic(spc, spe, step):
    """``state.step // steps_per_fused_epoch(steps_per_epoch)``, in banks
    mode and in iterator mode (cli/sj_train.py:125-127)."""
    for fused in (True, False):
        jloop = types.SimpleNamespace(fused=fused,
                                      steps_per_call=spc if fused else 1)
        ref = step // JTrainLoop.steps_per_fused_epoch(jloop, spe)
        banks = build_banks(*small_sources(1), n_frame=N_FRAME,
                            device='cpu') if fused else None
        loop = TrainLoop(_vad_bundle(steps_per_call=spc), banks=banks)
        assert step // loop.steps_per_fused_epoch(spe) == ref


# ------------------------------------------------- resume, bit for bit
def _callbacks(d):
    return [cb.SWA(start_epoch=1, swa_freq=1, verbose=False),
            cb.LearningRateScheduler(custom_scheduler(4096, 1, 2)),
            cb.TrainStateCheckpoint(str(d), every_epochs=1)]


def _loop(case, seed=0):
    """A fresh banks-mode loop of ``case``, and (steps an epoch, epochs,
    the epoch the interrupted run stops after)."""
    banks = build_banks(*small_sources(1), n_frame=N_FRAME, device='cpu')
    if case in ('adam', 'sgd', 'rmsprop'):
        return TrainLoop(_vad_bundle(optimizer=case, steps_per_call=2),
                         seed=seed, banks=banks, val_banks=banks), (3, 4, 2)
    if case == 'streamed':
        sb = build_streaming_banks(*small_sources(1), n_chunks=3,
                                   n_frame=N_FRAME, chunk_steps=1,
                                   device='cpu')
        return TrainLoop(_vad_bundle(steps_per_call=2), seed=seed,
                         banks=sb, val_banks=banks), (3, 4, 1)
    if case == 'eff_stochastic_depth':
        cfg = Config(model_type='eff', model=0, v=3, n_mels=N_MELS,
                     n_frame=N_FRAME, batch_size=2)
        return TrainLoop(get_model(cfg, device='cpu', seed=4), seed=seed,
                         banks=banks, val_banks=banks), (2, 3, 1)
    ns = trainer.build_args().parse_args(DENSITY_ARGV + ['--grad_accum',
                                                         '2'])
    cfg = trainer.to_config(ns)
    dbanks = build_banks(*small_sources(1), n_frame=N_FRAME, device='cpu')
    return TrainLoop(get_density_model(cfg, device='cpu', seed=cfg.seed),
                     seed=seed, loss_fn=trainer.make_loss_fn(ns),
                     variant='density', banks=dbanks,
                     val_banks=dbanks), (1, 3, 1)


def _record_chunks(loop):
    seq = []
    if loop.streaming:
        nb = loop.banks.next_banks

        def wrapped():
            seq.append(loop.banks.current_chunk)
            return nb()
        loop.banks.next_banks = wrapped
    return seq


@pytest.mark.parametrize('case', ['adam', 'sgd', 'rmsprop',
                                  'eff_stochastic_depth',
                                  'density_grad_accum', 'streamed'])
def test_resumed_run_equals_the_uninterrupted_run(tmp_path, case):
    """Stopped after epoch k, saved, restored into a fresh loop at JAX's
    ``initial_epoch`` and run on: weights, BN statistics, optimizer slots,
    lr, step and SWA average equal the uninterrupted run's, bit for bit."""
    full, (spe, epochs, stop) = _loop(case)
    seq_full = _record_chunks(full)
    full.fit(epochs=epochs, steps_per_epoch=spe, validation_steps=1,
             callbacks=_callbacks(tmp_path / 'full'), verbose=0)
    part, _ = _loop(case)
    seq_a = _record_chunks(part)
    part.fit(epochs=stop, steps_per_epoch=spe, validation_steps=1,
             callbacks=_callbacks(tmp_path / 'part'), verbose=0)
    resumed, _ = _loop(case)
    seq_b = _record_chunks(resumed)
    checkpoint.restore_train_state(str(tmp_path / 'part'), resumed.state)
    initial = resumed.state.step // resumed.steps_per_fused_epoch(spe)
    assert initial == stop
    resumed.fit(epochs=epochs, steps_per_epoch=spe, validation_steps=1,
                callbacks=_callbacks(tmp_path / 'resumed'), verbose=0,
                initial_epoch=initial)
    _assert_states_equal(full.state, resumed.state)
    assert full.state.swa_count == epochs
    if case == 'streamed':
        # 2 dispatches an epoch over a 3-chunk rotation, one each
        assert seq_a + seq_b == seq_full == [0, 1, 2, 0, 1, 2, 0, 1]


# -------------------------------------------------------------- the CLIs
def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        name = main(argv)
    return name, out.getvalue()


def test_sj_train_resumes_where_jax_resumes(tmp_path, monkeypatch,
                                            jax_state_cls):
    """tests/test_cli.py:84: checkpoints at the steps JAX's schedule keeps;
    ``--resume True`` prints JAX's line, trains the remaining epoch only,
    and the CSV continues under its one header."""
    monkeypatch.chdir(tmp_path)
    # no tensorboard writer: its import pulls in TensorFlow here
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    make_datafiles(tmp_path)
    base = ['--model_type', 'vad', '--v', '3', '--n_mels', str(N_MELS),
            '--n_frame', str(N_FRAME), '--batch_size', '2',
            '--steps_per_epoch', '2', '--datapath', str(tmp_path),
            '--ckpt_dir', str(tmp_path / 'ck'), '--ckpt_every_epochs', '1',
            '--device', 'cpu'] + DATA_FLAGS
    run, _ = _run(sj_train.main, base + ['--epochs', '2'])
    ref = _jax_schedule(str(tmp_path / 'jax'), jax_state_cls, 2, 1, 2)
    assert checkpoint.checkpoint_steps(str(tmp_path / 'ck')) == ref == [2, 4]
    write_wav(tmp_path / 'clip01.wav', seconds=4.0, seed=1)
    with open(tmp_path / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': {'clip01': [[0, 1, 2]]}}, f)
    _, out = _run(sj_train.main, base + ['--epochs', '3', '--resume', 'True'])
    assert 'resumed from step 4 (epoch 2)' in out
    assert 'Epoch 3/3' in out and 'Epoch 1/3' not in out \
        and 'Epoch 2/3' not in out
    assert checkpoint.checkpoint_steps(str(tmp_path / 'ck')) == [2, 4, 6]
    with open(tmp_path / f'{run}.csv') as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows] == ['epoch', '0', '1', '2']
    for suffix in ('.h5', '_SWA.h5', '_sample.h5'):
        assert (tmp_path / f'{run}{suffix}').exists(), suffix


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    argv = DENSITY_ARGV + ['--epochs', '2', '--resume', 'True', '--ckpt_dir',
                           str(tmp_path / 'none'), '--ckpt_every_epochs',
                           '5', '--datapath', str(tmp_path),
                           '--device', 'cpu'] + DATA_FLAGS
    _, out = _run(trainer.main, argv)
    assert f"no checkpoint under {str(tmp_path / 'none')!r}; " \
           'starting fresh' in out
    assert 'Epoch 1/2' in out
    # the train-end save
    assert checkpoint.checkpoint_steps(str(tmp_path / 'none')) == [2]


def test_trainer_resumes_with_grad_accum(tmp_path, monkeypatch):
    """``cli.trainer --grad_accum 2 --ckpt_dir`` for 2 epochs of 1 step,
    then ``--resume True --epochs 3``: the third epoch only, from the
    restored step, its log continued."""
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    base = DENSITY_ARGV + ['--grad_accum', '2', '--ckpt_dir',
                           str(tmp_path / 'ck'), '--ckpt_every_epochs', '1',
                           '--datapath', str(tmp_path), '--device',
                           'cpu'] + DATA_FLAGS
    _run(trainer.main, base + ['--epochs', '2'])
    assert checkpoint.checkpoint_steps(str(tmp_path / 'ck')) == [1, 2]
    loops = []
    init = TrainLoop.__init__
    monkeypatch.setattr(TrainLoop, '__init__', lambda self, *a, **kw: (
        init(self, *a, **kw), loops.append(self))[0])
    _, out = _run(trainer.main, base + ['--epochs', '3', '--resume', 'True'])
    assert 'resumed from step 2 (epoch 2)' in out
    assert 'Epoch 3/3' in out and 'Epoch 2/3' not in out
    assert loops[0].fused and loops[0].state.step == 3
    with open(tmp_path / 'dens.log') as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows] == ['epoch', '0', '1', '2']
