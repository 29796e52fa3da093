"""bfloat16 compute in the port (``compute_dtype='bfloat16'``:
challenge_tpu_torch/models/layers.py and every family, the registry, the
bridge, the CLIs) against the JAX package's flax models built with
``dtype=jnp.bfloat16``, on the CPU.

The same numpy-made float32 variables go to both packages through the
bridge (interop/jax_weights.py). Tolerances:

* one layer (BatchNorm in both modes, a conv, a Dense layer): within one
  bfloat16 ulp of flax's output, the ulp taken of max(|flax|, peak / 100)
  (measured: bit-equal), and flax's output dtypes;
* whole models and one training step, the 2x rule: with ``gap(a)`` the
  largest |a - jax_f32| over the peak of jax_f32, gap(port_bf16) <=
  2 gap(jax_bf16) + 1e-6. Both bfloat16 runs round every layer's output;
  the rule holds the port to JAX's own distance from float32, where an
  elementwise bound cannot hold (the two packages sum their convolutions
  in other orders, so their roundings part). The training-mode outputs
  of these small batches lie ~10% from float32 in both packages (a BN
  over 6 samples cancels), their inference-mode outputs ~0.3%.

The remat step equals the step without it bit for bit in bfloat16 too
(ROADMAP C11, C12), with the se cascade's freeze mask.

The eff family runs B0 for the forwards and, for the training step, the
shallow backbone of test_torch_effnet.py (``SHALLOW``): JAX compiles B0's
gradient in some 10 s per dtype. The eff family's keep masks of stochastic
depth are JAX's, read from its ``Dropout`` and given to the port.
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _helpers import DATA_FLAGS, make_datafiles, write_wav
from _torch_parity import inject_masks, vad_variables
from challenge_tpu.config import Config as JConfig
from challenge_tpu.models import effnet as jeff
from challenge_tpu.models.layers import BatchNorm as JBatchNorm
from challenge_tpu.models.layers import BiGRU as JBiGRU
from challenge_tpu.models.layers import BiLSTM as JBiLSTM
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu.models.senet import SECascade as JSECascade
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu.train.state import TrainState as JState
from challenge_tpu.train.state import make_grad_update as jax_grad_update
from challenge_tpu_torch.cli import eval as eval_cli
from challenge_tpu_torch.cli import sj_train
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models import effnet, layers
from challenge_tpu_torch.models.registry import (
    ModelBundle, get_density_model, get_model)
from challenge_tpu_torch.models.senet import SECascade
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.train import checkpoint
from challenge_tpu_torch.train.optim import make_optimizer
from challenge_tpu_torch.train.state import TrainState, make_grad_update
from test_torch_effnet import SHALLOW, record_dropout

BF16 = torch.bfloat16
VAD = dict(base_fsize=8, td_dim=32)


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bf16_ulps(a, b) -> float:
    """The largest |a - b| in bfloat16 ulps of max(|b|, peak / 100)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ref = np.maximum(np.abs(b), np.abs(b).max() / 100)
    return float((np.abs(a - b) / 2.0 ** (np.floor(np.log2(ref)) - 7)).max())


def gap(a, ref) -> float:
    """max |a - ref| over the peak of ``ref``, over arrays or lists of
    them."""
    if isinstance(ref, (list, tuple)):
        peak = max(float(np.abs(r).max()) for r in ref)
        return max(float(np.abs(np.asarray(x, np.float64) - r).max())
                   for x, r in zip(a, ref)) / peak
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - ref).max()
                 / np.abs(ref).max())


def hold_2x(port, jax_bf16, jax_f32, what=''):
    g_port, g_jax = gap(port, jax_f32), gap(jax_bf16, jax_f32)
    assert g_jax > 0, what                    # JAX's bf16 ran in bf16
    assert g_port <= 2 * g_jax + 1e-6, (what, g_port, g_jax)


def _f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# ------------------------------------------------------------------ layers
def _bn_variables(rng, c):
    return {'params': {'BatchNorm_0': {
        'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
        'bias': rng.standard_normal(c).astype(np.float32)}},
        'batch_stats': {'BatchNorm_0': {
            'mean': rng.standard_normal(c).astype(np.float32),
            'var': rng.uniform(0.5, 2.0, c).astype(np.float32)}}}


@pytest.mark.parametrize('training', [False, True])
def test_batchnorm_matches_flax_within_one_ulp(training):
    """A bfloat16 input; the output bfloat16, the statistics and the
    running statistics float32."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, 6, 5, 8)) * 3 + 1, jnp.bfloat16)
    var = _bn_variables(rng, 8)
    if training:
        ref, mut = JBatchNorm(jnp.bfloat16).apply(
            var, x, training=True, mutable=['batch_stats'])
    else:
        ref = JBatchNorm(jnp.bfloat16).apply(var, x, training=False)
    bn = layers.BatchNorm(8, feature_dim=-1)
    sd = flax_to_state_dict({c: {'FullyConnectedLayer_0': {'BatchNorm_0': v}}
                             for c, v in var.items()})
    bn.load_state_dict({k[len('fcs.0.bn.'):]: v for k, v in sd.items()})
    layers.set_compute_dtype(bn, BF16)
    with torch.no_grad():
        out = bn.train(training)(torch.from_numpy(_f32(x)).to(BF16))
    assert ref.dtype == jnp.bfloat16 and out.dtype == BF16
    assert bf16_ulps(out.float().numpy(), _f32(ref)) <= 1.0
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    if training:
        stats = mut['batch_stats']['BatchNorm_0']
        np.testing.assert_allclose(bn.running_mean.numpy(), stats['mean'],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(), stats['var'],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('kind', ['conv', 'dense', 'conv_transpose'])
def test_conv_and_dense_match_flax_within_one_ulp(kind):
    """float32 input and parameters, a bias: input, kernel and bias cast,
    the bias added after the product; the output bfloat16."""
    rng = np.random.default_rng(1)
    if kind == 'conv':
        x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
        k = (rng.standard_normal((3, 3, 6, 7)) / np.sqrt(54)).astype(
            np.float32)
        flax_layer = fnn.Conv(7, (3, 3), padding='SAME', dtype=jnp.bfloat16)
        port = layers.Conv2d(6, 7, 3, padding=1)
        weight, to_port = k.transpose(3, 2, 0, 1), (0, 3, 1, 2)
    elif kind == 'dense':
        x = rng.standard_normal((3, 4, 12)).astype(np.float32)
        k = (rng.standard_normal((12, 7)) / np.sqrt(12)).astype(np.float32)
        flax_layer = fnn.Dense(7, dtype=jnp.bfloat16)
        port = layers.Linear(12, 7)
        weight, to_port = k.T, (0, 1, 2)
    else:                  # the U-Net's 2x2/2 upsampling, flipped kernel
        x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
        k = (rng.standard_normal((2, 2, 4, 7)) / 4).astype(np.float32)
        flax_layer = fnn.ConvTranspose(7, (2, 2), strides=(2, 2),
                                       padding='SAME', dtype=jnp.bfloat16)
        port = layers.ConvTranspose2d(7, 7, 2, stride=2)
        port.weight = torch.nn.Parameter(torch.empty(4, 7, 2, 2))
        weight = np.flip(k, (0, 1)).transpose(2, 3, 0, 1)
        to_port = (0, 3, 1, 2)
    b = (0.3 * rng.standard_normal(7)).astype(np.float32)
    ref = flax_layer.apply({'params': {'kernel': k, 'bias': b}}, x)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(weight)))
        port.bias.copy_(torch.from_numpy(b))
    layers.set_compute_dtype(port, BF16)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(*to_port))
    back = tuple(np.argsort(to_port))
    assert ref.dtype == jnp.bfloat16 and out.dtype == BF16
    assert bf16_ulps(out.float().permute(*back).numpy(), _f32(ref)) <= 1.0


@pytest.mark.parametrize('cell', ['lstm', 'gru'])
def test_recurrent_carry_stays_float32(cell):
    """flax's carry is made in ``param_dtype`` (float32), so f c + i g and
    (1 - z) n + z h promote to it and the output is float32; the port's
    too, and within the 2x rule of flax's on a bfloat16 input."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 10)).astype(np.float32)
    jcls = JBiLSTM if cell == 'lstm' else JBiGRU
    variables = vad_variables(jcls(6), (7, 10), seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref32 = np.asarray(jcls(6).apply(variables, xb.astype(jnp.float32)))
    ref16 = jcls(6, dtype=jnp.bfloat16).apply(variables, xb)
    port = (layers.BiLSTM if cell == 'lstm' else layers.BiGRU)(10, 6)
    name = 'BiLSTM_0' if cell == 'lstm' else 'BiGRU_0'
    prefix = 'lstm.' if cell == 'lstm' else 'gru.'
    sd = flax_to_state_dict({'params': {name: variables['params']}})
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    layers.set_compute_dtype(port, BF16)
    with torch.no_grad():
        out = port(torch.from_numpy(_f32(xb)).to(BF16))
    assert ref16.dtype == jnp.float32 and out.dtype == torch.float32
    hold_2x(out.numpy(), np.asarray(ref16), ref32, cell)


# --------------------------------------------------------------- forwards
def _eff(v, n_mels, n_frame, head='sed', n_layers=0, model=0):
    def make(dtype):
        return jeff.EffNetSED(model, v=v, n_mels=n_mels, n_frame=n_frame,
                              head=head, n_layers=n_layers, dtype=dtype)

    def port():
        return effnet.EffNetSED(model, v=v, n_mels=n_mels, n_frame=n_frame,
                                head=head, n_layers=n_layers,
                                dtype=BF16)
    return make, port, (n_mels, n_frame, 2)


FAMILIES = {
    'vad_v8': (lambda dt: JVADModel(v=8, dtype=dt, **VAD),
               lambda: VADModel(v=8, n_mels=32, dtype=BF16, **VAD),
               (32, 64, 2)),
    'vad_v9': (lambda dt: JVADModel(v=9, dtype=dt, **VAD),
               lambda: VADModel(v=9, n_mels=32, dtype=BF16, **VAD),
               (32, 64, 2)),
    'eff_b0_v1': _eff(1, 32, 64),
    'eff_b0_v5': _eff(5, 32, 128),
    'eff_b0_v6': _eff(6, 32, 64),
    'eff_b0_v7': _eff(7, 10, 64),
    'density': _eff(0, 32, 64, head='density', n_layers=2),
    'se_v9': (lambda dt: JSECascade(pretrain=True, dtype=dt),
              lambda: SECascade(pretrain=True, dtype=BF16), (256, 32, 2)),
}


@functools.lru_cache(maxsize=None)
def _variables(name):
    make, _, shape = FAMILIES[name]
    return vad_variables(make(jnp.float32), shape, seed=len(name))


def _jax_forward(name, training, dtype, variables, x):
    """JAX's outputs (a list) and, in training mode, the keep masks."""
    module = FAMILIES[name][0](dtype)

    def run(w, x):
        rec = []
        kw = {}
        if training:
            kw = dict(training=True, mutable=['batch_stats'])
            if isinstance(module, jeff.EffNetSED):
                kw['rngs'] = {'dropout': jax.random.PRNGKey(1)}
        with record_dropout(rec):
            out = module.apply(w, x, **kw)
        out = out[0] if training else out
        return out, [m for m, _ in rec]
    out, masks = jax.device_get(jax.jit(run)(variables, x))
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))], masks


@pytest.mark.parametrize('training', [False, True])
@pytest.mark.parametrize('name', list(FAMILIES))
def test_forward_holds_the_2x_rule(name, training):
    """Every family's bfloat16 outputs, float32 as JAX's, in inference and
    training mode (the se cascade: the pretrain phase, its head frozen)."""
    make, port_cls, shape = FAMILIES[name]
    rng = np.random.default_rng(len(name))
    variables = _variables(name)
    x = rng.standard_normal((2 if name == 'se_v9' else 3,) + shape)
    x = x.astype(np.float32)
    ref32, masks = _jax_forward(name, training, jnp.float32, variables, x)
    ref16, masks16 = _jax_forward(name, training, jnp.bfloat16, variables, x)
    for a, b in zip(masks, masks16):
        np.testing.assert_array_equal(a, b)
    pm = port_cls()
    pm.load_state_dict(flax_to_state_dict(variables), strict=True)
    if masks:
        inject_masks(pm, masks)
    pm.train(training)
    with torch.no_grad():
        out = (pm(torch.from_numpy(x), torch.Generator())
               if isinstance(pm, effnet.EffNetSED) else pm(torch.from_numpy(x)))
    out = list(out) if isinstance(out, tuple) else [out]
    assert [o.dtype for o in out] == [torch.float32] * len(ref32)
    assert [r.dtype for r in ref16] == [np.float32] * len(ref32)
    assert {t.dtype for t in pm.state_dict().values()} == {torch.float32}
    hold_2x([o.numpy() for o in out], ref16, ref32, name)


# -------------------------------------------------------- a training step
STEP_FAMILIES = ('vad_v8', 'eff_shallow_v1')


@functools.lru_cache(maxsize=None)
def _step_case(name):
    """(flax module maker, port module maker, config, shape, variables,
    batch)."""
    if name == 'vad_v8':
        make, port, shape = FAMILIES['vad_v8']
        cfg = dict(model_type='vad', v=8, n_mels=32, n_frame=64)
        frames = 2
    else:
        make, port, shape = _eff(1, 32, 64, model=SHALLOW)
        cfg = dict(model_type='eff', model=SHALLOW, v=1, n_mels=32,
                   n_frame=64)
        frames = 64
    rng = np.random.default_rng(7)
    variables = vad_variables(make(jnp.float32), shape, seed=4)
    x = rng.standard_normal((3,) + shape).astype(np.float32)
    y = (rng.random((3, frames, 3)) < 0.5).astype(np.float32)
    return make, port, cfg, shape, variables, (x, y)


def _jax_bundle(name, dtype):
    make, _, cfg, shape, _, _ = _step_case(name)
    module = make(dtype)
    return JBundle(module, shape, JConfig(**cfg),
                   needs_dropout_rng=isinstance(module, jeff.EffNetSED))


@functools.lru_cache(maxsize=None)
def _jax_grads(name, dtype):
    """JAX's float32 gradients, new BN statistics and keep masks of one
    training step's forward and backward."""
    _, _, _, _, variables, batch = _step_case(name)
    grad_fn = jax_grad_update(_jax_bundle(name, dtype))[0]

    def run(params, stats, batch):
        rec = []
        with record_dropout(rec):
            grads, new_stats, _ = grad_fn(params, stats, batch,
                                          jax.random.PRNGKey(2))
        return grads, new_stats, [m for m, _ in rec]
    return jax.device_get(jax.jit(run)(variables['params'],
                                       variables['batch_stats'], batch))


@functools.lru_cache(maxsize=None)
def _jax_update(name):
    """JAX's update (AGC for vad, the clip and Keras Adam) from the first
    step's state, jitted once: the float32 gradients of either dtype go
    through the same program."""
    _, update_fn, opt = jax_grad_update(_jax_bundle(name, jnp.float32))

    def run(params, stats, grads):
        state = JState(step=jnp.zeros([], jnp.int32), params=params,
                       batch_stats=stats, opt_state=opt.init(params),
                       swa_params=params, swa_batch_stats=stats,
                       swa_count=jnp.zeros([], jnp.int32))
        return update_fn(state, grads, stats).params
    return jax.jit(run)


def _jax_step(name, dtype, held):
    """JAX's gradients or updated weights as a state_dict, and the keep
    masks."""
    variables = _step_case(name)[4]
    grads, _, masks = _jax_grads(name, dtype)
    if held == 'weights':
        grads = jax.device_get(_jax_update(name)(
            variables['params'], variables['batch_stats'], grads))
    return flax_to_state_dict({'params': grads}), masks


@pytest.mark.parametrize('held', ['gradients', 'weights'])
@pytest.mark.parametrize('name', STEP_FAMILIES)
def test_training_step_holds_the_2x_rule(name, held, monkeypatch):
    """One step (training forward, BCE, backward, AGC for vad, clipvalue
    and Keras Adam): the float32 gradients, and the updated weights."""
    for scaling in (jeff.SCALING, effnet.SCALING):
        monkeypatch.setitem(scaling, SHALLOW, (0.25, 0.5))
    _, port, cfg, shape, variables, (x, y) = _step_case(name)
    ref32, masks = _jax_step(name, jnp.float32, held)
    ref16, _ = _jax_step(name, jnp.bfloat16, held)
    pm = port()
    pm.load_state_dict(flax_to_state_dict(variables), strict=True)
    if masks:
        inject_masks(pm, masks)
    config = Config(**cfg, compute_dtype='bfloat16')
    bundle = ModelBundle(pm, shape, config, torch.device('cpu'),
                         needs_dropout_gen=bool(masks))
    grad_fn, update_fn = make_grad_update(bundle)
    state = TrainState(pm, make_optimizer(config, pm.parameters()))
    grads, metrics = grad_fn(pm, (torch.from_numpy(x), torch.from_numpy(y)),
                             torch.Generator() if masks else None)
    assert np.isfinite(float(metrics['loss']))
    names = [n for n, _ in pm.named_parameters()]
    assert all(g.dtype == torch.float32 for g in grads)
    if held == 'weights':
        update_fn(state, grads)
        grads = [p.detach() for p in pm.parameters()]
    hold_2x([g.numpy() for g in grads], [ref16[n].numpy() for n in names],
            [ref32[n].numpy() for n in names], held)


@pytest.mark.parametrize('family', ['vad_v8', 'eff_b0', 'se'])
def test_remat_step_equals_the_step_without_remat_in_bfloat16(family):
    """The families of ``test_torch_fused.py``'s remat test computing in
    bfloat16: the remat step (C11: no second BN update; C12: the first
    pass's keep masks) equals the step without it bit for bit, the se
    cascade's freeze mask included; the gradients float32."""
    from test_torch_fused import _eff_bundle, _se_bundle, _step, _vad_bundle
    make = {'vad_v8': _vad_bundle, 'eff_b0': _eff_bundle,
            'se': _se_bundle}[family]
    runs = []
    for remat in (False, True):
        bundle, batch = make(remat)
        layers.set_compute_dtype(bundle.module, BF16)
        before = {n: p.detach().clone()
                  for n, p in bundle.module.named_parameters()}
        gen = torch.Generator().manual_seed(9)
        grads, metrics, sd, _ = _step(bundle, batch,
                                      gen if bundle.needs_dropout_gen
                                      else None)
        runs.append((grads, metrics, sd, gen.get_state()))
    (g0, m0, sd0, r0), (g1, m1, sd1, r1) = runs
    assert all(g.dtype == torch.float32 for g in g0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert torch.equal(r0, r1)
    moved = {n for n, p in before.items() if not torch.equal(p, sd0[n])}
    assert moved
    if family == 'se':                  # pretrain: the head is frozen
        assert all(n.startswith('se.') for n in moved)


# ----------------------------------------------- registry, bridge, CLIs
@pytest.mark.parametrize('name', ['bfloat16', 'bf16'])
def test_registry_builds_bfloat16_models_on_the_cpu_only_when_asked(
        name, monkeypatch):
    """Both names, as JAX's ``_dtype`` reads them; float32 weights; on the
    card by default, so without one and without ``device='cpu'`` the
    entry points raise."""
    for cfg, get in (
            (Config(model_type='vad', v=8, n_mels=32, n_frame=64,
                    compute_dtype=name), get_model),
            (Config(model_type='se', v=9, n_frame=32, compute_dtype=name),
             get_model),
            (Config(model='EfficientNetB0', n_mels=32, n_frame=64, v=0,
                    compute_dtype=name), get_density_model)):
        module = get(cfg, device='cpu').module
        assert module.compute_dtype == BF16
        assert {p.dtype for p in module.parameters()} == {torch.float32}
        assert {m.compute_dtype for m in module.modules()
                if hasattr(type(m), 'compute_dtype')} == {BF16}
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        get_model(Config(model_type='vad', compute_dtype=name))


def test_bridge_carries_the_bfloat16_models_float32_variables():
    """A flax model built with ``dtype=bfloat16`` has the float32
    variables of its float32 twin; the bridge maps them unchanged."""
    for make, port, shape in (FAMILIES['vad_v9'], FAMILIES['eff_b0_v7']):
        shapes = [jax.eval_shape(
            lambda k, m=make(dt): m.init({'params': k, 'dropout': k},
                                         jnp.zeros((1,) + shape)),
            jax.random.PRNGKey(0)) for dt in (jnp.float32, jnp.bfloat16)]
        assert jax.tree.structure(shapes[0]) == jax.tree.structure(shapes[1])
        assert all(a.shape == b.shape and a.dtype == b.dtype == jnp.float32
                   for a, b in zip(jax.tree.leaves(shapes[0]),
                                   jax.tree.leaves(shapes[1])))
        variables = vad_variables(make(jnp.bfloat16), shape, seed=5)
        sd = flax_to_state_dict(variables)
        pm = port()
        pm.load_state_dict(sd, strict=True)
        assert all(torch.equal(pm.state_dict()[k], v) for k, v in sd.items())


def test_sj_train_and_eval_cli_in_bfloat16(tmp_path, monkeypatch):
    """``--compute_dtype bfloat16`` trains vad and scores the dev set; the
    checkpoints are float32 and load into a float32 model."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    make_datafiles(tmp_path)
    write_wav(tmp_path / 'clip01.wav', seconds=4.0, seed=1, tone_hz=440)
    with open(tmp_path / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': {'clip01': [[0, 1.0, 2.0]]}}, f)
    argv = ['--model_type', 'vad', '--v', '3', '--n_frame', '64',
            '--batch_size', '2', '--epochs', '3', '--steps_per_epoch', '2',
            '--datapath', str(tmp_path), '--compute_dtype', 'bfloat16',
            '--device', 'cpu'] + DATA_FLAGS
    run = sj_train.main(argv)
    for suffix in ('.h5', '_SWA.h5', '_sample.h5'):
        w = checkpoint.load_weights(str(tmp_path / f'{run}{suffix}'))
        assert {t.dtype for t in w.values()} == {torch.float32}
    f32 = get_model(Config(model_type='vad', v=3, n_frame=64), device='cpu')
    f32.module.load_state_dict(w, strict=True)
    assert f32.module.compute_dtype is None
    ers = eval_cli.main(['--name', run, '--p', '--compute_dtype',
                         'bfloat16', '--device', 'cpu'])
    assert len(ers) == 1 and np.isfinite(ers[0])


def test_trainer_cli_in_bfloat16(tmp_path, monkeypatch):
    """``cli.trainer --compute_dtype bfloat16``: 2 epochs of 1 step on
    the density head, float32 checkpoints."""
    from challenge_tpu_torch.cli import trainer
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    trainer.main(['--name', 'dens', '--model', 'EfficientNetB0', '--n_chan',
                  '2', '--n_mels', '32', '--n_frame', '64', '--batch_size',
                  '2', '--epochs', '2', '--steps_per_epoch', '1',
                  '--compute_dtype', 'bfloat16', '--datapath', str(tmp_path),
                  '--device', 'cpu'] + DATA_FLAGS)
    w = checkpoint.load_weights(str(tmp_path / 'dens_SWA.h5'))
    assert {t.dtype for t in w.values()} == {torch.float32}
    f32 = get_density_model(Config(model='EfficientNetB0', v=0, n_mels=32,
                                   n_frame=64), device='cpu')
    f32.module.load_state_dict(w, strict=True)
    with open(tmp_path / 'dens.log') as f:
        rows = f.read().strip().splitlines()
    assert len(rows) == 3 and 'nan' not in rows[-1]
