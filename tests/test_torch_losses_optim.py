"""The class losses of ``--loss`` and the Keras SGD and RMSprop of
``--optimizer`` (challenge_tpu_torch/train/losses.py, train/optim.py)
against the JAX package's, and both through the fused step and the CLI.

Losses: focal, MSE and MAE, alone and as the se v9 composite's class
loss, on numpy-made labels and predictions (some predictions equal to
their labels, where |x|'s gradient is JAX's 1): the values in float32 at
rtol 1e-6, the gradients in float64 at rtol 1e-10. Optimizers: 5 steps on
the same gradients, the rate changed between steps 2 and 3 (the
scheduler's ``fill_`` against JAX's injected hyperparameter), in float64
at rtol 1e-10 and in float32 at rtol 1e-6 / atol 1e-9.
"""

import csv
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _helpers import DATA_FLAGS, make_datafiles
from challenge_tpu.config import Config as JConfig
from challenge_tpu.train import losses as jlosses
from challenge_tpu.train import optim as joptim
from challenge_tpu_torch.cli import sj_train
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.train import checkpoint
from challenge_tpu_torch.train.losses import get_loss
from challenge_tpu_torch.train.optim import (
    KerasRMSprop, KerasSGD, make_optimizer)
from test_torch_fused import _banks_loop

LOSSES = ['focal', 'MSE', 'MAE']


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """Two threads, as in test_torch_vad_versions.py: the suite runs in
    several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _loss_inputs(se: bool, dtype):
    """(y, p) numpy tuples: sigmoid-range predictions, 0/1 labels (times
    8 for the regression losses' multiplier), every fourth prediction
    equal to its label."""
    rng = np.random.default_rng(3)
    y = (rng.random((2, 5, 3)) < 0.4).astype(dtype)
    p = rng.uniform(0.02, 0.98, (2, 5, 3)).astype(dtype)
    p.reshape(-1)[::4] = y.reshape(-1)[::4]
    if not se:
        return (y,), (p,)
    ys = rng.standard_normal((2, 6, 5, 1)).astype(dtype)
    ps = rng.standard_normal((2, 6, 5, 2)).astype(dtype)
    ps[..., :1].reshape(-1)[::3] = ys.reshape(-1)[::3]
    yn, pn = (rng.standard_normal((2, 6, 5, k)).astype(dtype)
              for k in (1, 2))
    return (y, ys, yn), (p, ps, pn)


def _configs(name, se):
    kw = dict(loss=name, model_type='se' if se else 'vad', v=9 if se else 8)
    return JConfig(**kw), Config(**kw)


def _unwrap(t):
    return t if len(t) > 1 else t[0]


@pytest.mark.parametrize('se', [False, True])
@pytest.mark.parametrize('name', LOSSES)
def test_loss_values_match_jax(name, se):
    jcfg, cfg = _configs(name, se)
    y, p = _loss_inputs(se, np.float32)
    ref, ref_parts = jlosses.get_loss(jcfg)(_unwrap(y), _unwrap(p))
    loss, parts = get_loss(cfg)(
        _unwrap(tuple(map(torch.from_numpy, y))),
        _unwrap(tuple(map(torch.from_numpy, p))))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
    assert set(parts) == set(ref_parts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(ref_parts[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize('se', [False, True])
@pytest.mark.parametrize('name', LOSSES)
def test_loss_gradients_match_jax_in_float64(name, se):
    """Including the predictions equal to their labels, where MAE's |x|
    takes JAX's gradient (ROADMAP C10)."""
    jcfg, cfg = _configs(name, se)
    y, p = _loss_inputs(se, np.float64)
    with jax.enable_x64(True):
        ref = jax.grad(lambda p: jlosses.get_loss(jcfg)(
            _unwrap(y), _unwrap(p))[0])(tuple(map(jnp.asarray, p)))
        ref = [np.asarray(r) for r in jax.device_get(ref)]
    pt = [torch.from_numpy(a).requires_grad_() for a in p]
    loss, _ = get_loss(cfg)(_unwrap(tuple(map(torch.from_numpy, y))),
                            _unwrap(tuple(pt)))
    loss.backward()
    for t, r in zip(pt, ref):
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-10,
                                   atol=1e-300)


def test_unknown_loss_and_optimizer_raise_value_errors():
    """As JAX's ``get_loss`` and ``make_optimizer`` do."""
    with pytest.raises(ValueError, match='unknown loss'):
        get_loss(Config(loss='hinge'))
    with pytest.raises(ValueError, match='unknown loss'):
        jlosses.get_loss(JConfig(loss='hinge'))
    with pytest.raises(ValueError, match='unknown optimizer'):
        make_optimizer(Config(optimizer='lamb'),
                       [torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(ValueError, match='unknown optimizer'):
        joptim.make_optimizer(JConfig(optimizer='lamb'))


# ------------------------------------------------------------- optimizers
RATES = (2.0 ** -8, 2.0 ** -10)       # exact in float32 and float64


def _opt_inputs(dtype):
    rng = np.random.default_rng(5)
    params = {'a': rng.standard_normal((4, 6)).astype(dtype),
              'b': rng.standard_normal(7).astype(dtype)}
    grads = [{k: (0.02 * rng.standard_normal(v.shape)).astype(dtype)
              for k, v in params.items()} for _ in range(5)]
    grads[0]['a'][0, 0] = 0.5                 # beyond clipvalue
    return params, grads


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('name', ['sgd', 'rmsprop'])
def test_optimizer_matches_jax(name, dtype):
    """JAX's make_optimizer stack (clip, then the Keras rule with the rate
    inside the momentum buffer) over 5 steps, the rate changed between
    steps 2 and 3; the port's rate changed in place, as the scheduler
    does."""
    f64 = dtype == np.float64
    tol = dict(rtol=1e-10, atol=0) if f64 else dict(rtol=1e-6, atol=1e-9)
    params, grads = _opt_inputs(dtype)
    with jax.enable_x64(f64):
        opt = joptim.make_optimizer(JConfig(optimizer=name, lr=RATES[0],
                                            clipvalue=0.01))
        jp, state = params, opt.init(params)
        for i, g in enumerate(grads):
            if i == 2:
                state.hyperparams['learning_rate'] = jnp.asarray(
                    RATES[1], dtype)
            upd, state = opt.update(g, state, jp)
            jp = optax.apply_updates(jp, upd)
        jp = jax.device_get(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt_t = make_optimizer(Config(optimizer=name, lr=RATES[0],
                                  clipvalue=0.01), tp.values())
    assert type(opt_t) is {'sgd': KerasSGD, 'rmsprop': KerasRMSprop}[name]
    lr = opt_t.param_groups[0]['lr']
    assert lr.dtype == torch.from_numpy(params['a']).dtype and lr.ndim == 0
    for i, g in enumerate(grads):
        if i == 2:
            lr.fill_(RATES[1])
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt_t.step()
    for k, t in tp.items():
        assert np.asarray(jp[k]).dtype == dtype
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                   err_msg=k, **tol)
        assert not np.allclose(np.asarray(jp[k]), params[k])


@pytest.mark.parametrize('name', ['sgd', 'rmsprop'])
def test_optimizer_trains_through_the_fused_step(name):
    """Banks mode, the fused step's eager form on the CPU, 2 calls of 2
    steps with a rate change between them: the weights equal the plain
    version's from the same generators, and the rate change reaches the
    second call."""
    runs = []
    for rate in (1e-3, 1e-4):
        loop = _banks_loop(optimizer=name, steps_per_call=2)
        gen = loop.phase_gen(0, True)
        step = loop.train_step
        before = {k: v.clone() for k, v in loop.get_weights().items()}
        logs = [step(loop.state, loop.banks, gen)]
        loop.state.optimizer.param_groups[0]['lr'].fill_(rate)
        logs.append(step(loop.state, loop.banks, gen))
        assert all(np.isfinite(float(m['loss'])) for m in logs)
        after = loop.get_weights()
        assert any(not torch.equal(before[k], after[k]) for k in before)
        runs.append(after)
    ref = _banks_loop(optimizer=name, steps_per_call=2)
    gen = ref.phase_gen(0, True)
    ref.train_step.plain(ref.state, ref.banks, gen)
    ref.state.optimizer.param_groups[0]['lr'].fill_(1e-4)
    ref.train_step.plain(ref.state, ref.banks, gen)
    w = ref.get_weights()
    assert all(torch.equal(w[k], runs[1][k]) for k in w)
    assert any(not torch.equal(runs[0][k], runs[1][k]) for k in w)


@pytest.mark.parametrize('flags', [
    ['--loss', 'focal', '--optimizer', 'sgd'],
    ['--loss', 'MSE', '--mse_multiplier', '8', '--optimizer', 'rmsprop']])
def test_sj_train_takes_the_loss_and_optimizer_flags(tmp_path, monkeypatch,
                                                     flags):
    """One epoch of 2 steps on the CPU (it folds no SWA, and the CLI
    catches ``NO_SWA_ERROR`` as the reference does): a finite loss, moved
    weights, the checkpoint, and the run name that carries both flags."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    make_datafiles(tmp_path)
    seen = {}
    fit = sj_train.TrainLoop.fit

    def spy(loop, *a, **kw):
        seen['before'] = {k: v.clone() for k, v in loop.get_weights().items()}
        seen['loop'] = loop
        try:              # one epoch folds no SWA: NO_SWA_ERROR, caught
            return fit(loop, *a, **kw)
        finally:
            seen['after'] = loop.get_weights()
    monkeypatch.setattr(sj_train.TrainLoop, 'fit', spy)
    run = sj_train.main(['--model_type', 'vad', '--v', '3', '--n_frame', '64',
                         '--batch_size', '2', '--epochs', '1',
                         '--steps_per_epoch', '2', '--datapath',
                         str(tmp_path), '--device', 'cpu'] + flags
                        + DATA_FLAGS)
    loss = flags[1].upper()
    assert f'opt_{flags[-1]}' in run and loss in run
    with open(tmp_path / f'{run}.csv') as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and np.isfinite(float(rows[0]['loss']))
    assert any(not torch.equal(seen['before'][k], seen['after'][k])
               for k in seen['before'])
    opt = seen['loop'].state.optimizer
    assert type(opt) is {'sgd': KerasSGD, 'rmsprop': KerasRMSprop}[flags[-1]]
    assert (tmp_path / f'{run}.h5').exists()
    w = checkpoint.load_weights(str(tmp_path / f'{run}.h5'))
    assert all(torch.isfinite(t).all() for t in w.values())
