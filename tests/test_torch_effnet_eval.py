"""The EfficientNet-SED family through the port's loop, eval chain and CLIs
(challenge_tpu_torch/train/loop.py, evaluate/infer.py, cli/) against the
JAX package, on the CPU at a small size (B0, 32 mels, 64 frames).

* ``evaluate()``: the 0/1 frame grids and the per-clip ERs identical to
  JAX's for v1 (every frame out), v3 (32 times upsampled) and v5 (one
  frame a window of 64, JAX's coarse grid kept) with bridged weights;
* ``TrainLoop``: each training epoch's stochastic depth comes from a
  generator seeded by (seed, epoch), so a fit drops the same samples
  again, and a fit moves every weight and BN statistic;
* the ``sj_train`` -> ``eval`` CLI chain with ``--model_type eff``.
"""

import json
import sys

import numpy as np
import pytest
import torch

from _helpers import DATA_FLAGS, make_datafiles, write_wav
from _torch_parity import record_grids, small_sources, vad_variables
from _torch_parity import write_dev_set
from challenge_tpu.config import Config as JConfig
from challenge_tpu.evaluate import infer as jinfer
from challenge_tpu.models.effnet import EffNetSED as JEffNetSED
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu_torch.cli import eval as eval_cli
from challenge_tpu_torch.cli import sj_train
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.evaluate import infer
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.effnet import EffNetSED
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.train.loop import TrainLoop

N_MELS, N_FRAME = 32, 64


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def dev_set(tmp_path_factory):
    return write_dev_set(tmp_path_factory.mktemp('dev'))


@pytest.mark.parametrize('v', [1, 3, 5])
def test_evaluate_grids_and_ers_equal_jax(dev_set, tmp_path, monkeypatch,
                                          v):
    """Windows of 64 frames every 32. v5 outputs 64 * 256 // 16000 = 1
    frame a window, so the overlap-add leaves the others at 0 / 0, the
    pools spread the NaNs, and the grid is empty: its ERs are those of no
    events, in both packages. JAX scores v5 clip by clip (its one-program
    dev set refuses the coarse grid), a compile a clip length, so v5 runs
    on the first clip alone."""
    if v == 5:
        dev_set = write_dev_set(tmp_path, seconds=(4.0,))
    cfg = dict(model_type='eff', v=v, n_mels=N_MELS, n_frame=N_FRAME)
    shape = (N_MELS, N_FRAME, 2)
    jm = JEffNetSED(v=v, n_mels=N_MELS, n_frame=N_FRAME)
    variables = vad_variables(jm, shape, seed=20 + v)
    # class 0 mostly on, class 2 mostly off, so that the grids hold both
    variables['params']['Dense_0']['bias'] = np.array([1.5, 0, -1.5],
                                                      np.float32)
    jgrids = record_grids(monkeypatch, jinfer)
    jers = jinfer.evaluate(JConfig(**cfg), JBundle(jm, shape, JConfig(**cfg)),
                           variables, overlap_hop=32, eval_dir=str(dev_set))
    pm = EffNetSED(v=v, n_mels=N_MELS, n_frame=N_FRAME)
    pm.load_state_dict(flax_to_state_dict(variables))
    grids = record_grids(monkeypatch, infer)
    ers = infer.evaluate(Config(**cfg), pm, overlap_hop=32,
                         eval_dir=str(dev_set))
    assert len(grids) == len(jgrids) == (1 if v == 5 else 3)
    for g, jg in zip(grids, jgrids):
        assert g.shape == jg.shape and g.shape[1] == 3
        np.testing.assert_array_equal(g, jg)
    if v == 5:
        assert not any(g.any() for g in grids)
    else:
        assert any(g.any() for g in grids)
        assert not all(g.all() for g in grids)
    assert ers == jers and all(np.isfinite(ers))


def test_train_loop_draws_stochastic_depth_per_epoch():
    """Banks mode, B0 v3, 2 epochs of 2 steps. Each epoch's generator is
    a function of (seed, epoch): it is drawn during the epoch (its state
    moves) and a fresh loop from the same seed draws the same masks, so it
    ends in the same weights; another seed does not. The fit moves the
    weights and BN statistics."""
    cfg = Config(model_type='eff', v=3, n_mels=N_MELS, n_frame=N_FRAME,
                 batch_size=4)
    banks = build_banks(*small_sources(0), n_frame=N_FRAME, device='cpu')

    def fit(seed):
        loop = TrainLoop(get_model(cfg, device='cpu', seed=0), seed=seed,
                         banks=banks, val_banks=banks)
        hist = loop.fit(epochs=2, steps_per_epoch=2, validation_steps=1,
                        verbose=0)
        return loop, hist
    loop, hist = fit(0)
    assert all(np.isfinite(v) for h in hist for v in h.values())
    assert 'val_er' in hist[-1]
    assert not torch.equal(loop.gen.get_state(),
                           loop.dropout_gen(1).get_state())
    assert torch.equal(loop.dropout_gen(1).get_state(),
                       loop.dropout_gen(1).get_state())
    assert not torch.equal(loop.dropout_gen(0).get_state(),
                           loop.dropout_gen(1).get_state())
    init = get_model(cfg, device='cpu', seed=0).module.state_dict()
    after = loop.get_weights()
    moved = [not torch.equal(after[k], init[k]) for k in after]
    assert sum(moved) > 0.9 * len(moved)
    again, _ = fit(0)
    other, _ = fit(1)
    w = again.get_weights()
    assert all(torch.equal(w[k], after[k]) for k in after)
    w = other.get_weights()
    assert not all(torch.equal(w[k], after[k]) for k in after)


def test_sj_train_then_eval_cli_eff(tmp_path, monkeypatch):
    """``--model_type eff --model 0 --v 3`` with int8 banks: 3 epochs of
    2 steps write the checkpoint trio and the CSV (the eval callback fires
    at epoch 2), and ``cli.eval --p`` parses B0 v3 back out of the run name
    and scores the dev clip."""
    monkeypatch.chdir(tmp_path)
    # no tensorboard writer: its import pulls in TensorFlow, if installed
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    make_datafiles(tmp_path)
    write_wav(tmp_path / 'clip01.wav', seconds=4.0, seed=1, tone_hz=440)
    with open(tmp_path / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': {'clip01': [[0, 1.0, 2.0]]}}, f)
    run = sj_train.main(
        ['--model_type', 'eff', '--model', '0', '--v', '3', '--n_layers',
         '1', '--n_dim', '64', '--n_frame', str(N_FRAME), '--n_mels',
         str(N_MELS), '--batch_size', '2', '--epochs', '3',
         '--steps_per_epoch', '2', '--bank_dtype', 'int8', '--datapath',
         str(tmp_path), '--device', 'cpu'] + DATA_FLAGS)
    assert run.startswith('B0_v3_')
    for suffix in ('.h5', '_SWA.h5', '_sample.h5', '.csv'):
        assert (tmp_path / f'{run}{suffix}').exists(), suffix
    # the run name keeps neither n_layers nor n_dim (reference grammar),
    # so the eval CLI gets them as flags
    ers = eval_cli.main(['--name', run, '--p', '--device', 'cpu',
                         '--n_layers', '1', '--n_dim', '64'])
    assert len(ers) == 1 and np.isfinite(ers[0])
