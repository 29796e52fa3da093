"""The density trainer's modules in the port against the JAX package:
``density_loss`` (challenge_tpu_torch/train/losses.py), ``AdaBelief``
(train/optim.py), the kernel penalty (train/regularizers.py), the density
labels (data/labels.py), ``FeatureFn(variant='density')``
(data/pipeline.py), the density head and ``get_density_model``
(models/effnet.py, models/registry.py), ``loss_fn=`` through the train
step (train/state.py) and ``ReduceLROnPlateau`` (train/callbacks.py).

Everything random is made with numpy, or drawn by JAX and fed to the port
(draws at its interpret-mode kernel, SpecAugment masks, keep masks of
stochastic depth). Tolerances: the loss at rtol 1e-6 and its gradient at
1e-5; AdaBelief's parameters after 5 steps and the penalty at rtol 1e-6
(float32, other summation orders); labels exact; the log-mel by its mean
abs error < 1e-5 (ROADMAP's rule, test_torch_features.py); the eval
forward within 1e-5 of the output's peak (test_torch_effnet.py); the
whole step in float64 (ROADMAP C2), as its test says.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    BATCH, N_FRAME, N_MELS, f64, inject_masks, port_draws, small_sources,
    vad_variables, x64)
from challenge_tpu.config import Config as JConfig
from challenge_tpu.data import labels as jlabels
from challenge_tpu.models import effnet as jeff
from challenge_tpu.models import registry as jregistry
from challenge_tpu.train import callbacks as jcb
from challenge_tpu.train import losses as jlosses
from challenge_tpu.train import optim as joptim
from challenge_tpu.train import regularizers as jreg
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data import labels, pipeline
from challenge_tpu_torch.data.pipeline import FeatureFn, build_banks
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models import effnet
from challenge_tpu_torch.models.layers import BatchNorm
from challenge_tpu_torch.models.registry import (
    ModelBundle, get_density_model, parse_model_id)
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.train import callbacks as cb
from challenge_tpu_torch.train import regularizers
from challenge_tpu_torch.train.losses import density_loss
from challenge_tpu_torch.train.optim import AdaBelief, make_optimizer
from challenge_tpu_torch.train.state import (
    TrainState, make_eval_step, make_train_step)

# a small EfficientNet for the float64 step, entered in both packages'
# SCALING (width 0.25) with a block table of its own: a stem of stride 2,
# then one block of stride 4 and three of 24 channels, the first of stride
# 4 (so 32 in all, as B0's), the other two residual with stochastic
# depth; JAX compiles its step in about 3 s on a CPU, B0's in minutes
SHALLOW = 8
SHALLOW_BLOCKS = ((3, 1, 32, 16, 1, 4), (3, 3, 16, 24, 6, 4))


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _density_pair(seed, b=3, t=8, c=30):
    """(y_true, y_pred) [b, t, c]: non-negative, y_true with all-zero
    rows (frames) and sample 0 all zero."""
    rng = np.random.default_rng(seed)
    y_true = rng.random((b, t, c)) * (rng.random((b, t, c)) < 0.3)
    y_true[:, 2] = 0.0
    y_true[0] = 0.0
    y_pred = rng.random((b, t, c))
    y_pred[1, 3] = 0.0
    return y_true.astype(np.float32), y_pred.astype(np.float32)


# -------------------------------------------------------------- the loss
@pytest.mark.parametrize('c', [30, 3])
def test_density_loss_and_gradient_match_jax(c):
    y_true, y_pred = _density_pair(c, c=c)
    jloss = jlosses.density_loss(alpha=0.8, l2=1.0)
    ref, gref = jax.value_and_grad(lambda p: jloss(y_true, p))(y_pred)
    p = torch.from_numpy(y_pred).requires_grad_()
    out = density_loss(alpha=0.8, l2=1.0)(torch.from_numpy(y_true), p)
    out.backward()
    assert out.dtype == torch.float32 and out.ndim == 0
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gref), rtol=1e-5,
                               atol=1e-7 * np.abs(gref).max())
    # the TV term matters: another l2 moves the loss
    other = density_loss(alpha=0.8, l2=0.0)(torch.from_numpy(y_true), p)
    assert abs(other.item() - out.item()) > 1e-3


# ------------------------------------------------------------ AdaBelief
def _grads(seed, shapes, steps=5):
    """Gradients for ``steps`` steps; some elements beyond clipvalue 0.01,
    some near zero; in 'a'[0, 0] the second step's equals the first
    moment, and so do the later ones: v falls and amsgrad's vhat stays
    above it."""
    rng = np.random.default_rng(seed)
    out = [{k: (rng.standard_normal(s) * rng.choice([1e-4, 3e-3, 0.05], s))
            .astype(np.float32) for k, s in shapes.items()}
           for _ in range(steps)]
    out[0]['a'][0, 0] = 5e-3
    for g in out[1:]:
        g['a'][0, 0] = 5e-4
    return out


@pytest.mark.parametrize('amsgrad', [False, True])
def test_adabelief_matches_jax(amsgrad):
    """5 steps on the same gradients: JAX's make_optimizer stack
    (clip, scale_by_adabelief, scale_by_learning_rate), with
    ``amsgrad`` from ``scale_by_adabelief(amsgrad=True)`` in that stack."""
    import optax
    shapes = {'a': (4, 6), 'b': (7,)}
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = _grads(2, shapes)
    assert any((np.abs(g['a']) > 0.01).any() for g in grads)
    jcfg = JConfig(optimizer='adabelief', lr=1e-3, clipvalue=0.01)
    if amsgrad:
        opt = optax.chain(optax.clip(0.01),
                          joptim.scale_by_adabelief(amsgrad=True),
                          optax.scale_by_learning_rate(1e-3))
    else:
        opt = joptim.make_optimizer(jcfg)
    jp, state = params, opt.init(params)
    for g in grads:
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    if amsgrad:
        opt_t = AdaBelief(tp.values(), lr=1e-3, clipvalue=0.01,
                          amsgrad=True)
    else:
        opt_t = make_optimizer(Config(optimizer='adabelief', lr=1e-3,
                                      clipvalue=0.01), tp.values())
        assert type(opt_t) is AdaBelief and not opt_t.amsgrad
    for g in grads:
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt_t.step()
    for k, t in tp.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        assert not np.allclose(np.asarray(jp[k]), params[k])
    if amsgrad:
        s = opt_t.state[tp['a']]
        assert (s['vhat'] >= s['v']).all() and (s['vhat'] > s['v']).any()


# ------------------------------------------------------- the regularizer
def _family(name):
    """(flax variables, the port's module with them bridged)."""
    if name == 'vad_v8':
        from challenge_tpu.models.vad import VADModel as JVADModel
        jm = JVADModel(v=8, base_fsize=8, td_dim=32)
        pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
        shape = (N_MELS, N_FRAME, 2)
    elif name == 'eff_B0_v5':
        jm = jeff.EffNetSED(v=5, n_mels=N_MELS, n_frame=128)
        pm = effnet.EffNetSED(v=5, n_mels=N_MELS, n_frame=128)
        shape = (N_MELS, 128, 2)
    else:
        jm = jeff.EffNetSED(v=0, n_layers=2, n_mels=N_MELS, n_frame=N_FRAME,
                            n_classes=30, head='density')
        pm = effnet.EffNetSED(n_layers=2, n_mels=N_MELS, n_frame=N_FRAME,
                              n_classes=30, head='density')
        shape = (N_MELS, N_FRAME, 2)
    variables = vad_variables(jm, shape, seed=4)
    pm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return variables, pm


@pytest.mark.parametrize('family', ['vad_v8', 'eff_B0_v5', 'density'])
def test_penalty_matches_jax_l1_l2(family):
    """The penalty's tensors are exactly those flax calls ``kernel``
    (the resample and GRU kernels of v5, the SE convs, the density
    Dense); each term within rtol 1e-6 of JAX's; its gradient is zero on
    every BN weight and bias and on every bias."""
    variables, pm = _family(family)
    want = set(flax_to_state_dict({'params': _only_kernels(
        variables['params'])}))
    assert {n for n, _ in regularizers.kernels(pm)} == want
    if family == 'eff_B0_v5':
        assert {'resample.weight', 'backbone.blocks.3.convs.2.weight',
                'gru.cells.0.gates.hz.weight'} <= want
    for l1, l2 in ((1.0, 0.0), (0.0, 1.0), (3e-5, 1e-6)):
        ref = float(jax.jit(jreg.l1_l2(l1, l2))(variables['params']))
        pm.zero_grad()
        out = regularizers.l1_l2(l1, l2)(pm)
        np.testing.assert_allclose(out.item(), ref, rtol=1e-6)
    out.backward()
    bn = {f'{m}.{leaf}' for m, mod in pm.named_modules()
          if isinstance(mod, BatchNorm) for leaf in ('weight', 'bias')}
    assert bn and not bn & want
    for name, p in pm.named_parameters():
        if name in want:
            np.testing.assert_allclose(
                p.grad.numpy(), (3e-5 * p.sign() + 2e-6 * p).detach().numpy(),
                rtol=1e-5, atol=1e-12, err_msg=name)
        else:
            assert p.grad is None or not p.grad.any(), name
    assert regularizers.l1_l2()(pm).item() == 0.0


def _only_kernels(tree):
    """``tree`` with only its ``kernel`` leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            sub = _only_kernels(v)
            if sub:
                out[k] = sub
        elif k == 'kernel':
            out[k] = v
    return out


def test_regularized_loss_reaches_the_train_and_eval_steps():
    """A ``needs_params`` loss gets the module in the train step and the
    eval step, so val_loss carries the penalty, as JAX's eval step's
    does."""
    pm = effnet.EffNetSED(n_mels=N_MELS, n_frame=N_FRAME, head='density')
    pm.reset_parameters(torch.Generator().manual_seed(0))
    cfg = Config(model_type='eff', v=0, optimizer='adabelief')
    bundle = ModelBundle(pm, (N_MELS, N_FRAME, 2), cfg, torch.device('cpu'),
                         needs_dropout_gen=True)
    base = density_loss()
    pen = regularizers.l1_l2(0.0, 1e-3)
    loss_fn = regularizers.apply_kernel_regularizer(
        lambda t, p: (base(t, p), {}), pen)
    assert loss_fn.needs_params
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.standard_normal(
        (2, N_MELS, N_FRAME, 2), dtype=np.float32)),
        torch.from_numpy(rng.random((2, 2, 3), dtype=np.float32)))
    state = TrainState(pm, make_optimizer(cfg, pm.parameters()))
    logs = make_eval_step(bundle, loss_fn)(state, batch)
    plain = make_eval_step(bundle, lambda t, p: (base(t, p), {}))(state,
                                                                 batch)
    np.testing.assert_allclose(float(logs['loss'] - plain['loss']),
                               pen(pm).item(), rtol=1e-5)
    assert set(logs) == {'loss', 'cos_sim'}
    logs = make_train_step(bundle, loss_fn)(state, batch, torch.Generator())
    assert np.isfinite(float(logs['loss'])) and state.step == 1


# ------------------------------------------------------------ the labels
def test_density_labels_equal_jax():
    """Each voice's 0/1 frame labels (an energy mask times a one-hot
    class, so every mass is an exact integer) normalised to 1, a silent
    slot left at 0 (no NaN), summed over the voices; then 5 x (2-frame
    'SAME' pool x 2) and the multiplier."""
    rng = np.random.default_rng(5)
    y = (rng.random((3, 7, 64, 30)) < 0.2).astype(np.float32)
    y[:, 4] = 0.0                                   # a silent voice slot
    y[2] = 0.0                                      # a silent sample
    _, ref = jlabels.to_density_labels(None, y)
    out = labels.to_density_labels(torch.from_numpy(y))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert np.isfinite(out.numpy()).all() and not out[2].any()
    np.testing.assert_allclose(out.sum(dim=(1, 2)).numpy(), [6.0, 6.0, 0.0],
                               rtol=1e-6)
    for frames in (64, 2048, 70):
        d = np.asarray(ref)[:, :1].repeat(frames, axis=1) * 0.3 \
            + rng.random((3, frames, 30)).astype(np.float32)
        _, jref = jlabels.preprocess_labels(10.0)(None, d)
        out = labels.preprocess_labels(torch.from_numpy(d), 10.0)
        assert out.shape == (3, -(-frames // 32), 30)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jref))


# -------------------------------------------------------- the features
# up to 2 voices and 1 noise a sample: JAX's interpret-mode kernel
# compiles per slot, 5 s a batch at the defaults' 6 voices and 1 noise
CFG = dict(model_type='eff', v=0, n_mels=N_MELS, n_frame=N_FRAME,
           batch_size=BATCH, mse_multiplier=10.0, max_voices=3,
           max_noises=2)
# (n_chan, training, fused_mel, run name)
FEATURE_CASES = [(2, True, False, ''), (2, False, False, ''),
                 (2, True, True, ''), (2, False, True, ''),
                 (2, True, False, 'filter_nominmax'),
                 (2, True, True, 'filter_nominmax'), (3, True, False, '')]


@functools.lru_cache(maxsize=None)
def _sources():
    bgs, voices, labels_, noises = small_sources(6)
    return bgs, voices, labels_, [np.abs(n) for n in noises]


@pytest.fixture(scope='module')
def jbanks():
    """JAX's banks, after one small call of its interpret-mode kernel
    (its start-up, about 2 s, is paid here once)."""
    from _torch_parity import synth_case
    from challenge_tpu.data.pipeline import build_banks as jax_build_banks
    from challenge_tpu.ops.pallas_synth import synthesize_windows
    nf, a = synth_case('edges')
    jax.block_until_ready(synthesize_windows(nf, **a, magnitude=True,
                                             interpret=True))
    return jax_build_banks(*_sources(), n_frame=N_FRAME)


def _jax_density(jbanks, n_chan, training, fused, name, key):
    """JAX's make_feature_fn(variant='density') on one batch, its kernel
    in interpret mode: the features, the draws at the kernel and the
    masks its key gives."""
    import challenge_tpu.data.mixture as jmix
    import challenge_tpu.data.pipeline as jpipe
    import challenge_tpu.ops.pallas_synth as ps
    from challenge_tpu.ops.augment import batch_mask_keep
    rec = {}
    orig = ps.synthesize_windows

    def synth(n_frame, bgflat, bidx, boff, vflat, vidx, vshift, vw, nflat,
              nidx, nshift, nw, vlens, nlens, **kw):
        rec.update(bidx=bidx, boff=boff, vidx=vidx, vshift=vshift, vw=vw,
                   nidx=nidx, nshift=nshift, nw=nw, vlens=vlens, nlens=nlens)
        return orig(n_frame, bgflat, bidx, boff, vflat, vidx, vshift, vw,
                    nflat, nidx, nshift, nw, vlens, nlens, interpret=True,
                    **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, 'synthesize_windows', synth)
        # unjitted, so the recorded values are run()'s
        mp.setattr(jpipe, 'sample_batch', jmix.sample_batch.__wrapped__)
        fn = jpipe.make_feature_fn(
            JConfig(n_chan=n_chan, name=name, **CFG), training=training,
            variant='density', jit=False, use_pallas=True, fused_mel=fused)

        @jax.jit
        def run(key, banks):
            return dict(rec, features=fn(key, banks))
        out = jax.device_get(run(key, jbanks))
    _, k_aug, _ = jax.random.split(key, 3)
    k_t, k_f = jax.random.split(k_aug)
    out['tmask'] = batch_mask_keep(k_t, BATCH, N_FRAME, 24, 6)
    out['fmask'] = batch_mask_keep(k_f, BATCH, 257, 16, 1)
    return {k: (v if k == 'features' else np.array(v))
            for k, v in out.items()}


@pytest.mark.parametrize('n_chan,training,fused,name', FEATURE_CASES)
def test_density_features_match_jax(n_chan, training, fused, name, jbanks,
                                    monkeypatch):
    """``FeatureFn(variant='density')`` given JAX's draws and masks, end
    to end through ``__call__``: B1, B4 or B2 (their plain versions),
    SpecAugment, mel, minmax (always), log, density labels; no stft
    filter, whatever the name; the features keep 2 channels at n_chan 3
    (ROADMAP C9)."""
    key = jax.random.PRNGKey(20 + len(name) + 2 * training + fused)
    out = _jax_density(jbanks, n_chan, training, fused, name, key)
    jx, jy = (np.array(a) for a in out['features'])
    pb = build_banks(*_sources(), n_frame=N_FRAME, device='cpu')
    draws = port_draws(out)
    monkeypatch.setattr(pipeline, 'draw', lambda *a, **kw: draws)
    fn = FeatureFn(Config(n_chan=n_chan, name=name, **CFG), training,
                   device='cpu', fused_mel=fused, variant='density',
                   n_classes=3)
    fn.masks = lambda gen: (torch.from_numpy(out['tmask']),
                            torch.from_numpy(out['fmask']))
    assert not fn.use_filter and fn.use_minmax
    x, y = fn(torch.Generator(), pb)
    assert x.shape == jx.shape == (BATCH, N_MELS, N_FRAME, 2)
    assert y.shape == jy.shape == (BATCH, N_FRAME // 32, 3)
    assert float((x - torch.from_numpy(jx)).abs().mean()) < 1e-5
    np.testing.assert_array_equal(y.numpy(), jy)
    assert jy.any() and (np.asarray(jx).min(axis=(1, 2, 3)) < -10).all()


def test_density_pipeline_checks_the_label_width():
    pb = build_banks(*_sources(), n_frame=N_FRAME, device='cpu')
    it = iter(pipeline.DevicePipeline(pb, Config(**CFG), device='cpu',
                                      variant='density', n_classes=3))
    x, y = next(it)
    assert x.shape == (BATCH, N_MELS, N_FRAME, 2) and y.shape[-1] == 3
    fn = FeatureFn(Config(**CFG), device='cpu', variant='density',
                   n_classes=30)
    with pytest.raises(ValueError, match='3 label classes'):
        fn(torch.Generator(), pb)
    with pytest.raises(ValueError, match='variant'):
        FeatureFn(Config(**CFG), device='cpu', variant='se')


# ------------------------------------------------------------ the model
@pytest.mark.parametrize('n_layers', [0, 2])
def test_density_model_forward_matches_jax(n_layers):
    """``get_density_model`` with a string model id, against JAX's, on
    the same numpy-made variables: eval forward within 1e-5 of the peak;
    flax's head Dense is ``Dense_{n_layers}``, the port's last of
    ``denses``."""
    jcfg = JConfig(model_type='eff', v=0, model='EfficientNetB0',
                   n_layers=n_layers, n_mels=N_MELS, n_frame=N_FRAME,
                   n_classes=30)
    jb = jregistry.get_density_model(jcfg)
    variables = vad_variables(jb.module, jb.input_shape, seed=n_layers)
    bundle = get_density_model(Config(**dataclasses.asdict(jcfg)),
                               device='cpu')
    pm = bundle.module
    assert bundle.needs_dropout_gen and bundle.input_shape == jb.input_shape
    assert pm.density and len(pm.denses) == n_layers + 1
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(pm.state_dict())
    head = variables['params'][f'Dense_{n_layers}']['kernel']
    assert head.shape[-1] == 30
    np.testing.assert_array_equal(sd[f'denses.{n_layers}.weight'].numpy(),
                                  np.asarray(head).T)
    pm.load_state_dict(sd, strict=True)
    x = np.random.default_rng(3).standard_normal(
        (3,) + jb.input_shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda w, x: jb.apply(w, x, training=False))(
        variables, x))
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x))
    assert out.shape == ref.shape == (3, N_FRAME // 32, 30)
    assert out.dtype == torch.float32 and (ref == 0).any() and ref.max() > 0
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_density_model_ids_heads_and_refusals():
    assert parse_model_id('EfficientNetB4') == 4 == parse_model_id(4)
    assert jregistry.parse_model_id('EfficientNetB7') == \
        parse_model_id('EfficientNetB7')
    # the density head ignores v; the sed head still checks it
    m = effnet.EffNetSED(v=2, n_mels=N_MELS, n_frame=N_FRAME,
                         head='density')
    assert m.ups is m.gru is m.resample is None
    with pytest.raises(ValueError, match='deprecated'):
        effnet.EffNetSED(v=2, head='sed')
    with pytest.raises(ValueError, match='unknown head'):
        effnet.EffNetSED(head='se')


def test_b4_density_parameter_count_equals_jax():
    """The trainer's configuration (EfficientNetB4, 80 mels, 2048 frames,
    n_layers 0, 3 classes), the port on the meta device."""
    jm = jeff.EffNetSED(model=4, v=0, n_frame=2048, head='density')
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k, 'dropout': k},
                          jnp.zeros((1, 80, 2048, 2))),
        jax.random.PRNGKey(0))['params']
    with torch.device('meta'):
        pm = effnet.EffNetSED(model=4, n_frame=2048, head='density')
    leaves = jax.tree.leaves(shapes)
    assert sum(p.numel() for p in pm.parameters()) == \
        sum(int(np.prod(a.shape)) for a in leaves) == 17_564_315
    assert len(list(pm.parameters())) == len(leaves) == 418


# ------------------------------------------------- the whole step, float64
@functools.lru_cache(maxsize=None)
def _jax_density_steps():
    """JAX's density training step, twice, in float64 on the shallow
    model: density loss + l1_l2 penalty, AdaBelief with clipvalue,
    stochastic depth. flax's ``Dropout`` hands each keep mask to the host
    as the step runs (one compile, no second forward)."""
    from flax import linen as nn

    from challenge_tpu.models.registry import ModelBundle as JBundle
    from challenge_tpu.train.state import TrainState as JState
    from challenge_tpu.train.state import make_train_step as jax_train_step
    shape = (N_MELS, N_FRAME, 2)
    jcfg = JConfig(model_type='eff', v=0, model=f'EfficientNetB{SHALLOW}',
                   n_mels=N_MELS, n_frame=N_FRAME, batch_size=3,
                   n_classes=30, optimizer='adabelief', lr=1e-3,
                   clipvalue=0.01)
    variables = vad_variables(jregistry.get_density_model(jcfg).module,
                              shape, seed=8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3,) + shape)
    y = rng.random((3, N_FRAME // 32, 30)) * 3
    base = jlosses.density_loss(0.8, 1.0)
    loss_fn = jreg.apply_kernel_regularizer(
        lambda t, p: (base(t, p), {}), jreg.l1_l2(1e-5, 1e-4))
    masks = []

    class Dropout(nn.Dropout):
        def __call__(self, inputs, deterministic=None, rng=None):
            out = super().__call__(inputs, deterministic, rng)
            jax.debug.callback(lambda k: masks.append(np.asarray(k)),
                               jnp.any(out != 0, axis=(1, 2, 3)))
            return out

    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, 'Dropout', Dropout)
        jm = jeff.EffNetSED(SHALLOW, v=0, n_mels=N_MELS, n_frame=N_FRAME,
                            n_classes=30, head='density', dtype=jnp.float64)
        bundle = JBundle(jm, shape, jcfg, needs_dropout_rng=True)
        step, opt = jax_train_step(bundle, loss_fn=loss_fn)

        @jax.jit                    # one compile, not one an eager op
        def init(variables):
            w = f64(variables)
            return JState(step=jnp.zeros([], jnp.int32), params=w['params'],
                          batch_stats=w['batch_stats'],
                          opt_state=opt.init(w['params']),
                          swa_params=w['params'],
                          swa_batch_stats=w['batch_stats'],
                          swa_count=jnp.zeros([], jnp.int32))
        state = init(variables)
        logs, all_masks = [], []
        for i in range(2):
            state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)),
                                  jax.random.PRNGKey(i))
            logs.append(jax.device_get(metrics))
            jax.effects_barrier()
            all_masks.append(masks[:])
            masks.clear()
        state = jax.device_get(state)
    return variables, x, y, all_masks, logs, state


def test_density_train_steps_match_jax_float64(monkeypatch):
    """Two steps of the port's ``make_train_step(bundle, loss_fn)`` with
    the CLI's loss (density + penalty) and AdaBelief, given JAX's keep
    masks, against JAX's: losses and cos_sim at rtol 1e-6, every
    parameter and BN statistic within 1e-6 (the bridge rounds JAX's to
    float32; measured 2.6e-7), AdaBelief's moments within 1e-4 of their
    largest (measured 1.9e-5). Both models cast their output to float32,
    so the loss and its gradient at the output are float32 on both sides
    (ROADMAP C2)."""
    for mod in (jeff, effnet):
        monkeypatch.setitem(mod.SCALING, SHALLOW, (0.25, 1.0))
        monkeypatch.setattr(mod, 'BLOCK_ARGS', SHALLOW_BLOCKS)
    variables, x, y, all_masks, jlogs, jstate = _jax_density_steps()
    assert not np.array([m for ms in all_masks for m in ms]).all()
    cfg = Config(model_type='eff', v=0, model=f'EfficientNetB{SHALLOW}',
                 n_mels=N_MELS, n_frame=N_FRAME, batch_size=3, n_classes=30,
                 optimizer='adabelief', lr=1e-3, clipvalue=0.01)
    pm = effnet.EffNetSED(SHALLOW, n_mels=N_MELS, n_frame=N_FRAME,
                          n_classes=30, head='density').double()
    pm.load_state_dict({k: t.double() for k, t in
                        flax_to_state_dict(variables).items()})
    bundle = ModelBundle(pm, (N_MELS, N_FRAME, 2), cfg, torch.device('cpu'),
                         needs_dropout_gen=True)
    base = density_loss(0.8, 1.0)
    loss_fn = regularizers.apply_kernel_regularizer(
        lambda t, p: (base(t, p), {}), regularizers.l1_l2(1e-5, 1e-4))
    state = TrainState(pm, make_optimizer(cfg, pm.parameters()))
    step = make_train_step(bundle, loss_fn)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for masks, jl in zip(all_masks, jlogs):
        inject_masks(pm, masks)
        logs = step(state, batch, torch.Generator())
        assert set(logs) == {'loss', 'cos_sim'}
        for k in logs:
            np.testing.assert_allclose(float(logs[k]), float(jl[k]),
                                       rtol=1e-6, err_msg=k)
    ref = flax_to_state_dict({'params': jstate.params,
                              'batch_stats': jstate.batch_stats})
    init = flax_to_state_dict(variables)
    moved = 0
    for k, t in pm.state_dict().items():
        np.testing.assert_allclose(t.float().numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        moved += not torch.equal(t.float(), init[k])
    assert moved > 0.9 * len(ref)
    # AdaBelief's moments, each within 1e-4 of its largest element
    adab = jstate.opt_state.inner_state[1]
    for tree, key in ((adab.m, 'm'), (adab.v, 'v')):
        mom = flax_to_state_dict({'params': tree})
        peak = max(float(t.abs().max()) for t in mom.values())
        for n, p in pm.named_parameters():
            np.testing.assert_allclose(
                state.optimizer.state[p][key].numpy(), mom[n].numpy(),
                rtol=0, atol=1e-4 * peak, err_msg=f'{key} {n}')


# ----------------------------------------------------- ReduceLROnPlateau
@dataclasses.dataclass
class _JaxState:
    opt_state: object

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def test_reduce_lr_on_plateau_matches_jax():
    """The same losses (with an epoch that lacks the monitor) cut the
    learning rate at the same epochs by the same factor."""
    losses = [5.0, 4.0, 4.5, 4.2, 4.1, 4.3, 4.0, 3.9, 4.0, 4.0, 4.0, 4.0,
              4.0, 4.0, None, 3.8, 3.9, 3.9, 3.9, 3.9, 3.9, 3.9]
    jopt = joptim.make_optimizer(JConfig(optimizer='adabelief', lr=1e-3))
    jloop = types.SimpleNamespace(state=_JaxState(jopt.init({'w': 0.0})))
    ploop = types.SimpleNamespace(state=types.SimpleNamespace(
        optimizer=AdaBelief([torch.nn.Parameter(torch.zeros(1))], lr=1e-3)))
    jcall = jcb.ReduceLROnPlateau(monitor='loss', factor=0.9, patience=5)
    pcall = cb.ReduceLROnPlateau(monitor='loss', factor=0.9, patience=5)
    jcall.set_loop(jloop)
    pcall.set_loop(ploop)
    jlr, plr = [], []
    for epoch, loss in enumerate(losses):
        logs = {} if loss is None else {'loss': loss}
        jcall.on_epoch_end(epoch, dict(logs))
        pcall.on_epoch_end(epoch, dict(logs))
        jlr.append(float(jloop.state.opt_state.hyperparams['learning_rate']))
        plr.append(float(ploop.state.optimizer.param_groups[0]['lr']))
    np.testing.assert_allclose(plr, jlr, rtol=1e-6)
    assert len(set(np.round(plr, 12))) == 4          # three cuts
