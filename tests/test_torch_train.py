"""The slice as a whole: the port's build_banks -> draws -> synthesis ->
features make three batches, and three training steps on them (AGC,
clipvalue, Keras Adam; challenge_tpu_torch/train/) from a bridged init are
held against JAX's ``make_train_step`` on the same batches.

Model: VADModel v8 shrunk to base_fsize 8 and td_dim 32, on 32 mels x 64
frames, batch 4. Both sides run the three steps in float64 (the port's
module in double, JAX's model ``dtype`` field under a scoped
``jax.enable_x64``; the models' outputs are float32 on both sides, as the
reference casts them). Two float32 facts force that:

* Keras Adam's first steps are +-lr times the gradient's sign for every
  element whose gradient is above eps, so any element whose gradient lies
  below the float32 noise floor takes a full step of random sign, and the
  runs part by ~lr after two steps (measured here: 1.4e-3). The JAX
  package's own cross-stack training differential drops Adam for SGD for
  the same reason (tests/test_keras_h5.py, test_train_step_differential).
* On these log-mel batches (masked bins at log(1e-8), so every channel's
  mean is far from 0) the one-pass BN variance E[x^2] - E[x]^2 cancels:
  JAX's float32 CPU gradients lie up to 20% from float64 ones.

Tolerances for the float64 steps: losses rtol 1e-5, params, BN statistics
and both Adam moments atol 1e-5 (measured: losses 1.1e-8 relative, params
and statistics 2.2e-7, m 1.1e-10). The port's float32 step is held
separately: its gradients against JAX's float64 ones, within 1e-4 of each
tensor's largest element (measured 5.5e-5), and its loss at rtol 1e-5
(measured 4.5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import BATCH, N_FRAME, N_MELS, small_sources, vad_variables
from challenge_tpu.config import Config as JConfig
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu.train.state import TrainState as JState
from challenge_tpu.train.state import make_train_step as jax_train_step
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import DevicePipeline, build_banks
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.train.optim import make_optimizer
from challenge_tpu_torch.train.state import (
    TrainState, make_eval_step, make_train_step)

SHAPE = (N_MELS, N_FRAME, 2)
CFG = dict(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
           batch_size=BATCH)
STEPS = 3


@pytest.fixture(scope='module')
def batches():
    """Three training batches from the port's own pipeline on the CPU."""
    cfg = Config(**CFG)
    banks = build_banks(*small_sources(2), n_frame=N_FRAME, device='cpu')
    return [(x.numpy(), y.numpy())
            for x, y in DevicePipeline(banks, cfg, device='cpu').take(STEPS)]


@pytest.fixture(scope='module')
def init():
    jm = JVADModel(v=8, base_fsize=8, td_dim=32)
    return jm, vad_variables(jm, SHAPE, seed=3)


def _port_module(variables):
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS, n_chan=2)
    pm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return pm


@pytest.fixture(scope='module')
def port_run(batches, init):
    """The port's train step, in float64, and its final state."""
    pm = _port_module(init[1]).double()
    bundle = ModelBundle(pm, SHAPE, Config(**CFG), torch.device('cpu'))
    state = TrainState(pm, make_optimizer(bundle.config, pm.parameters()))
    step = make_train_step(bundle)
    logs = [step(state, (torch.from_numpy(x).double(),
                         torch.from_numpy(y).double()))
            for x, y in batches]
    return state, logs


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope='module')
def jax_run(batches, init):
    """JAX's train step, computed in float64, and its final state."""
    with jax.enable_x64(True):
        jm = JVADModel(v=8, base_fsize=8, td_dim=32, dtype=jnp.float64)
        variables = _f64(init[1])
        bundle = JBundle(jm, SHAPE, JConfig(**CFG))
        step, opt = jax_train_step(bundle)
        params = variables['params']
        state = JState(step=jnp.zeros([], jnp.int32), params=params,
                       batch_stats=variables['batch_stats'],
                       opt_state=opt.init(params), swa_params=params,
                       swa_batch_stats=variables['batch_stats'],
                       swa_count=jnp.zeros([], jnp.int32))
        logs = []
        for i, batch in enumerate(batches):
            state, metrics = step(state, _f64(batch), jax.random.PRNGKey(i))
            logs.append(jax.device_get(metrics))
        return jax.device_get(state), logs


def test_port_pipeline_batches(batches):
    """The port's pipeline gives what the model takes: log-mel features
    [B, n_mels, n_frame, 2] and 32x-downsampled 0/1 labels."""
    for x, y in batches:
        assert x.shape == (BATCH,) + SHAPE and x.dtype == np.float32
        assert y.shape == (BATCH, N_FRAME // 32, 3)
        assert np.isfinite(x).all() and set(np.unique(y)) <= {0.0, 1.0}
    assert any(y.any() for _, y in batches)
    assert not np.array_equal(batches[0][0], batches[1][0])


def test_port_train_steps_run(port_run):
    state, logs = port_run
    assert state.step == STEPS
    assert all(np.isfinite(float(m['loss'])) for m in logs)


def test_losses_match_jax(port_run, jax_run):
    port = [float(m['loss']) for m in port_run[1]]
    ref = [float(m['loss']) for m in jax_run[1]]
    np.testing.assert_allclose(port, ref, rtol=1e-5)
    for name in ('cos_sim', 'er'):
        np.testing.assert_allclose([float(m[name]) for m in port_run[1]],
                                   [float(m[name]) for m in jax_run[1]],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(
        [m['f1_counts'].numpy() for m in port_run[1]],
        [np.asarray(m['f1_counts']) for m in jax_run[1]])


def test_params_and_bn_stats_match_jax(port_run, jax_run):
    jstate = jax_run[0]
    ref = flax_to_state_dict({'params': jstate.params,
                              'batch_stats': jstate.batch_stats})
    sd = port_run[0].module.state_dict()
    assert set(ref) == set(sd)
    moved = 0
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
        assert sd[k].dtype == torch.float64
        moved += int(not np.allclose(v.numpy(), 0))
    assert int(jstate.step) == STEPS and moved > 0


def test_adam_moments_match_jax(port_run, jax_run):
    """Keras Adam keeps m and v per parameter and its step count per
    parameter group; JAX's sit in the chain clip -> scale_by_keras_adam ->
    scale_by_learning_rate."""
    adam = jax_run[0].opt_state.inner_state[1]
    assert int(adam.count) == STEPS
    state = port_run[0]
    assert int(state.optimizer.param_groups[0]['step']) == STEPS
    names = {id(p): n for n, p in state.module.named_parameters()}
    for which in ('m', 'v'):
        ref = flax_to_state_dict({'params': getattr(adam, which)})
        for p, s in state.optimizer.state.items():
            np.testing.assert_allclose(
                s[which].numpy(), ref[names[id(p)]].numpy(), rtol=1e-5,
                atol=1e-5, err_msg=f'{which} {names[id(p)]}')


def test_eval_step_matches_jax(port_run, jax_run, batches):
    """The inference-mode step on the trained weights and statistics."""
    from challenge_tpu.train.state import make_eval_step as jax_eval_step
    bundle = ModelBundle(port_run[0].module, SHAPE, Config(**CFG),
                         torch.device('cpu'))
    x, y = batches[0]
    out = make_eval_step(bundle)(port_run[0], (torch.from_numpy(x).double(),
                                               torch.from_numpy(y).double()))
    with jax.enable_x64(True):
        jm = JVADModel(v=8, base_fsize=8, td_dim=32, dtype=jnp.float64)
        ref = jax_eval_step(JBundle(jm, SHAPE, JConfig(**CFG)))(
            jax_run[0], _f64((x, y)))
    np.testing.assert_allclose(float(out['loss']), float(ref['loss']),
                               rtol=1e-5)


def test_float32_gradients_match_jax(batches, init):
    """One step's gradients of the port in float32 (its working type)
    against JAX's in float64, on the first batch."""
    from challenge_tpu.train.state import make_grad_update as jax_grad_update
    from challenge_tpu_torch.train.state import make_grad_update
    x, y = batches[0]
    pm = _port_module(init[1])
    bundle = ModelBundle(pm, SHAPE, Config(**CFG), torch.device('cpu'))
    grads, port_metrics = make_grad_update(bundle)[0](
        pm, (torch.from_numpy(x), torch.from_numpy(y)))
    names = [n for n, _ in pm.named_parameters()]
    with jax.enable_x64(True):
        jm = JVADModel(v=8, base_fsize=8, td_dim=32, dtype=jnp.float64)
        grad_fn = jax_grad_update(JBundle(jm, SHAPE, JConfig(**CFG)))[0]
        variables = _f64(init[1])
        ref, _, metrics = jax.jit(grad_fn)(
            variables['params'], variables['batch_stats'], _f64((x, y)),
            jax.random.PRNGKey(0))
        ref = flax_to_state_dict({'params': jax.device_get(ref)})
    np.testing.assert_allclose(float(port_metrics['loss']),
                               float(metrics['loss']), rtol=1e-5)
    for n, g in zip(names, grads):
        scale = float(ref[n].abs().max())
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


def test_agc_scheduler_and_swa_match_jax():
    """AGC per unit (OIHW dims 1-3 and Linear dim 1 for HWIO axes 0-2 and
    Dense axis 0), the warmup LR schedule and the SWA running average,
    on the same numpy values."""
    from challenge_tpu.train import optim as joptim
    from challenge_tpu_torch.train import optim
    from challenge_tpu_torch.train.state import swa_update
    rng = np.random.default_rng(9)
    shapes = {'conv': (3, 3, 4, 5), 'dense': (6, 7), 'bias': (7,)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    # gradients whose units straddle the clipping threshold
    g = {k: (v * rng.choice([1e-3, 0.1], v.shape[-1])).astype(np.float32)
         for k, v in p.items()}
    ref = jax.device_get(joptim.adaptive_clip_grad(p, g))
    to_torch = {'conv': lambda a: a.transpose(3, 2, 0, 1),
                'dense': lambda a: a.T, 'bias': lambda a: a}
    out = optim.adaptive_clip_grad(
        [torch.from_numpy(np.ascontiguousarray(to_torch[k](p[k])))
         for k in shapes],
        [torch.from_numpy(np.ascontiguousarray(to_torch[k](g[k])))
         for k in shapes])
    for k, o in zip(shapes, out):
        np.testing.assert_allclose(o.numpy(), to_torch[k](ref[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
        assert not np.allclose(ref[k], g[k]) or k == 'bias'
    for step in (0, 5, 4000, 12000):
        assert optim.custom_scheduler(256)(step) == \
            joptim.custom_scheduler(256)(step)

    module = torch.nn.Linear(3, 2)
    state = TrainState(module, make_optimizer(Config(**CFG),
                                              module.parameters()),
                       swa={k: torch.zeros_like(v)
                            for k, v in module.state_dict().items()})
    seen = []
    for _ in range(3):
        with torch.no_grad():
            for t in module.parameters():
                t.add_(1.0)
        seen.append({k: v.clone() for k, v in module.state_dict().items()})
        swa_update(state)
    assert state.swa_count == 3
    for k, v in state.swa.items():
        torch.testing.assert_close(v, sum(s[k] for s in seen) / 3)


@pytest.mark.slow
def test_trained_er_improves(tmp_path):
    """The mirror of tests/test_train.py::test_trained_er_improves: the
    same corpus (its ``_trained_er_corpus``), vad v3 on 40 mels x 128
    frames at batch 8, 14 epochs of 25 steps in banks mode on the CPU,
    and the same assertions: the training chain learns the task (final
    f1 above 0.4, the loss below 0.6 of the first epoch's) and the final
    weights improve the challenge ER of ``evaluate()`` on the dev set (the
    mean down by more than 0.05, at least 2 clips better)."""
    from test_train import _trained_er_corpus

    from challenge_tpu_torch.evaluate.infer import evaluate
    from challenge_tpu_torch.models.registry import get_model
    from challenge_tpu_torch.train.loop import TrainLoop
    n_frame = 128
    bgs, voices, onehot = _trained_er_corpus(tmp_path, n_frame=n_frame)
    banks = build_banks(bgs, voices, onehot, n_frame=n_frame, device='cpu')
    cfg = Config(model_type='vad', v=3, n_mels=40, n_frame=n_frame,
                 n_chan=2, batch_size=8, snr=-2, max_voices=3, lr=1e-3)
    bundle = get_model(cfg, device='cpu')
    loop = TrainLoop(bundle, banks=banks, val_banks=banks, seed=0)
    er0 = evaluate(cfg, bundle.module, overlap_hop=32,
                   eval_dir=str(tmp_path))
    hist = loop.fit(epochs=14, steps_per_epoch=25, validation_steps=1,
                    verbose=0)
    assert hist[-1]['f1_score'] > 0.4, hist[-1]
    assert hist[-1]['loss'] < 0.6 * hist[0]['loss'], (hist[0], hist[-1])
    er1 = evaluate(cfg, bundle.module, overlap_hop=32,
                   eval_dir=str(tmp_path))
    assert np.isfinite(er1).all() and np.isfinite(er0).all(), (er0, er1)
    assert float(np.mean(er1)) < float(np.mean(er0)) - 0.05, (er0, er1)
    assert sum(b < a for a, b in zip(er0, er1)) >= 2, (er0, er1)
