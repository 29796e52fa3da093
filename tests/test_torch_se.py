"""The port's se v9 family (challenge_tpu_torch/models/senet.py, the se rules
of interop/jax_weights.py, train/losses.py ``se_loss``, the transposed
layout of train/optim.py's AGC, the freeze mask of train/state.py, the
se branches of cli/sj_train.py and evaluate/infer.py) against the JAX
package.

The U-Net's widths are fixed (64 to 512 channels, 21,564,847 parameters
with the head), so the models run at full width on a small input: batch 2
and 32 frames of 256 rows. The same numpy-made variables go to both sides,
with BN statistics away from their initial values. Tolerances:

* eval-mode outputs: 1e-5 (abs and relative), float32 on both sides, only
  the order of the convolution and matmul sums differs;
* train-mode outputs and the new BN statistics: 1e-5, in float64 on both
  sides. In float32 the head's BatchNorms see 2 samples (batch 2 x 1 label
  frame) in finetune mode, which amplifies rounding: the port's float32
  class output lies 7.4e-5 from JAX's (ROADMAP C4);
* the update (AGC with the transposed layout, the freeze mask, Keras Adam)
  on the same gradients: rtol 1e-5 / atol 1e-7 in float32;
* one whole training step (slow): 1e-5 in float64 on both sides, as
  test_torch_train.py does (ROADMAP C2);
* the loss, the small parts and the layer traps: 1e-6 to 1e-5 in float32;
* ``evaluate()`` grids and ERs: identical.
"""

import copy
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _helpers import DATA_FLAGS, make_datafiles, write_wav
from _torch_parity import small_sources, vad_variables
from challenge_tpu.config import Config as JConfig
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu.models.senet import SECascade as JSECascade
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.senet import SECascade
from challenge_tpu_torch.train.optim import make_optimizer
from challenge_tpu_torch.train.state import TrainState, make_grad_update

N_FRAME, BATCH = 32, 2
SHAPE = (256, N_FRAME, 2)
TOL = dict(rtol=1e-5, atol=1e-5)
N_PARAMS = 21_564_847


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """The full-width U-Net's convolutions on torch's default thread count
    (every core) oversubscribe the CPU when the suite runs in several
    workers, and slow every other test file by tens of times; on two
    threads this module takes as long as on all cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(pretrain, **kw):
    return dict(model_type='se', v=9, n_frame=N_FRAME, batch_size=BATCH,
                pretrain=pretrain, **kw)


@pytest.fixture(scope='module')
def variables():
    return vad_variables(JSECascade(v=9), SHAPE, seed=0)


@pytest.fixture(scope='module')
def x():
    return np.random.default_rng(1).standard_normal(
        (BATCH,) + SHAPE).astype(np.float32)


def _port(variables, pretrain, dtype=torch.float32):
    pm = SECascade(pretrain=pretrain)
    pm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return pm.to(dtype)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def test_bridge_covers_every_tensor(variables):
    sd = flax_to_state_dict(variables)
    pm = SECascade()
    assert set(sd) == set(pm.state_dict())
    n_flax = sum(np.asarray(a).size
                 for a in jax.tree.leaves(variables['params']))
    assert n_flax == sum(p.numel() for p in pm.parameters()) == N_PARAMS
    assert sum(np.asarray(a).size for a in jax.tree.leaves(variables)) == \
        sum(t.numel() for t in pm.state_dict().values())
    # ConvTranspose [kh, kw, in, out] -> [in, out, kh, kw], both spatial
    # dims flipped; the head under vad/
    k = np.asarray(variables['params']['se']['Upsampling_5']
                   ['ConvTranspose_0']['kernel'])
    np.testing.assert_array_equal(sd['se.ups.5.up.weight'].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    d = np.asarray(variables['params']['vad']['Dense_0']['kernel'])
    assert d.shape == (8 * 512, 1024)
    np.testing.assert_array_equal(sd['vad.td.weight'].numpy(), d.T)
    with pytest.raises(KeyError, match='se/Extra_0'):
        flax_to_state_dict({'params': {'se': {'Extra_0': {'kernel': k}}}})


def test_eval_forward_matches_jax(variables, x):
    jm = JSECascade(v=9)
    ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, x)
    pm = _port(variables, pretrain=False).eval()
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    shapes = [(BATCH, N_FRAME // 32, 3), (BATCH,) + SHAPE, (BATCH,) + SHAPE]
    for o, r, shape in zip(out, ref, shapes):
        assert o.shape == r.shape == shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize('pretrain', [True, False])
def test_train_forward_and_bn_stats_match_jax(variables, x, pretrain):
    """Training mode, float64 on both sides: the outputs and the new
    running statistics, and the frozen half's statistics unchanged on
    both (its BatchNorms run in inference mode)."""
    with jax.enable_x64(True):
        jm = JSECascade(v=9, pretrain=pretrain, dtype=jnp.float64)
        ref, mut = jax.jit(lambda v, x: jm.apply(
            v, x, training=True, mutable=['batch_stats']))(
                _f64(variables), jnp.asarray(x, jnp.float64))
        ref, mut = jax.device_get((ref, mut))
    pm = _port(variables, pretrain, torch.float64)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    pm.train()
    assert pm.se.training == pretrain and pm.vad.training != pretrain
    with torch.no_grad():
        out = pm(torch.from_numpy(x).double())
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, **TOL)
    new = flax_to_state_dict({'batch_stats': mut['batch_stats']})
    after = pm.state_dict()
    frozen = 'vad.' if pretrain else 'se.'
    for k, v in new.items():
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
        assert torch.equal(after[k], before[k]) == k.startswith(frozen), k


def _small_part(jmodule, pmodule, shape, path):
    """A small flax part and its port, bridged through the se rules under
    ``se/<path>``: eval and train outputs (and new statistics)."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    v = vad_variables(jmodule, shape[1:], seed=4)
    sd = flax_to_state_dict({c: {'se': {path: v[c]}} for c in v})
    prefix = sd and next(iter(sd)).split('.')[:3]
    pmodule.load_state_dict({k[len('.'.join(prefix)) + 1:]: t
                             for k, t in sd.items()})
    for training in (False, True):
        ref = jax.jit(lambda v, x: jmodule.apply(
            v, x, training=training,
            mutable=['batch_stats'] if training else False))(v, x)
        if training:
            ref, mut = ref
        pmodule.train(training)
        with torch.no_grad():
            out = pmodule(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), **TOL)
    new = flax_to_state_dict({'batch_stats': {'se': {path: jax.device_get(
        mut)['batch_stats']}}})
    for k, t in new.items():
        np.testing.assert_allclose(
            pmodule.state_dict()[k[len('.'.join(prefix)) + 1:]].numpy(),
            t.numpy(), **TOL)


def test_convset_and_upsampling_match_jax():
    """The U-Net's two blocks alone, at small widths: ConvSet (the port's
    two-conv ConvMPBlock) and Upsampling, NHWC against NCHW."""
    from challenge_tpu.models.senet import ConvSet as JConvSet
    from challenge_tpu.models.senet import Upsampling as JUpsampling
    from challenge_tpu_torch.models.layers import ConvMPBlock
    from challenge_tpu_torch.models.senet import Upsampling
    _small_part(JConvSet(chan=8), ConvMPBlock(3, 8, num_convs=2),
                (2, 16, 12, 3), 'ConvSet_0')
    _small_part(JUpsampling(chan=6), Upsampling(10, 6), (2, 8, 6, 10),
                'Upsampling_0')


def test_conv_transpose_is_torch_transposed_conv_with_flipped_kernel():
    """flax's ConvTranspose((2, 2), strides=(2, 2), padding='SAME') equals
    nn.ConvTranspose2d(k=2, s=2) with the kernel flipped in both spatial
    dims; unflipped, they differ."""
    from flax import linen as fnn
    from challenge_tpu_torch.models.layers import kernel_fan_in
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (2, 2), strides=(2, 2), padding='SAME')
    v = layer.init(jax.random.PRNGKey(0), x)
    k = rng.standard_normal((2, 2, 3, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(layer.apply({'params': {'kernel': k, 'bias': bias}}, x))
    assert jax.tree.leaves(v)[1].shape == (2, 2, 3, 4)
    conv = torch.nn.ConvTranspose2d(3, 4, 2, stride=2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = {}
    for flip in (True, False):
        kk = k[::-1, ::-1] if flip else k
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(
                np.ascontiguousarray(kk.transpose(2, 3, 0, 1))))
            conv.bias.copy_(torch.from_numpy(bias))
            out[flip] = conv(xt).permute(0, 2, 3, 1).numpy()
    assert out[True].shape == ref.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(out[True], ref, rtol=1e-6, atol=1e-6)
    assert np.abs(out[False] - ref).max() > 0.1
    # flax's LeCun fan-in of the [kh, kw, in, out] kernel is kh * kw * in
    from jax._src.nn.initializers import _compute_fans
    fan_in, _ = _compute_fans(k.shape)
    assert kernel_fan_in(conv) == int(fan_in) == 2 * 2 * 3


def test_agc_on_transposed_weights_matches_jax():
    """JAX reduces a ConvTranspose kernel over (kh, kw, in): one norm per
    output channel, torch's dims (0, 2, 3); the rank-4 conv rule (dims 1-3)
    would clip per input channel instead."""
    from challenge_tpu.train import optim as joptim
    from challenge_tpu_torch.train import optim
    rng = np.random.default_rng(9)
    p = rng.standard_normal((2, 2, 4, 5)).astype(np.float32)
    g = (p * rng.choice([1e-3, 0.1], (4, 5))).astype(np.float32)
    ref = np.asarray(jax.device_get(joptim.adaptive_clip_grad(
        {'k': p}, {'k': g}))['k'])

    def to_torch(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 3, 0, 1)))
    out = optim.adaptive_clip_grad([to_torch(p)], [to_torch(g)],
                                   transposed=[True])[0]
    np.testing.assert_allclose(out.numpy(), ref.transpose(2, 3, 0, 1),
                               rtol=1e-6, atol=0)
    assert not np.allclose(ref, g)
    wrong = optim.adaptive_clip_grad([to_torch(p)], [to_torch(g)])[0]
    assert not np.allclose(wrong.numpy(), ref.transpose(2, 3, 0, 1))
    module = SECascade()
    flags = optim.transposed_weights(module)
    names = [n for n, _ in module.named_parameters()]
    assert [n for n, f in zip(names, flags) if f] == [
        f'se.ups.{i}.up.weight' for i in range(8)]


def test_se_loss_matches_jax():
    """[BCE(class), MAE(speech), MAE(noise)] with weights [1, 10, 10]; the
    one-channel targets broadcast against the two-channel outputs."""
    from challenge_tpu.train.losses import get_loss as jax_get_loss
    from challenge_tpu_torch.train.losses import get_loss, mae
    rng = np.random.default_rng(6)
    y = (rng.integers(0, 2, (BATCH, 1, 3)).astype(np.float32),
         rng.standard_normal((BATCH, 256, N_FRAME, 1)).astype(np.float32),
         rng.standard_normal((BATCH, 256, N_FRAME, 1)).astype(np.float32))
    p = (np.maximum(rng.standard_normal((BATCH, 1, 3)), 0).astype(np.float32),
         rng.standard_normal((BATCH,) + SHAPE).astype(np.float32),
         rng.standard_normal((BATCH,) + SHAPE).astype(np.float32))
    ref, ref_parts = jax_get_loss(JConfig(**_cfg(True)))(y, p)
    t = [tuple(torch.from_numpy(a) for a in z) for z in (y, p)]
    loss, parts = get_loss(Config(**_cfg(True)))(*t)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
    assert set(parts) == set(ref_parts) == {'class_loss', 'speech_loss',
                                            'noise_loss'}
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(ref_parts[k]),
                                   rtol=1e-6, err_msg=k)
    assert float(mae(t[0][1], t[1][1])) != float(mae(t[0][1],
                                                     t[1][1][..., :1]))


@pytest.mark.parametrize('pretrain', [True, False])
def test_update_matches_jax_on_the_same_gradients(variables, pretrain):
    """The update half of the step: AGC (with the transposed layout), the
    freeze mask after it, clipvalue and Keras Adam, on the same numpy-made
    gradients. The port updates the whole cascade: the frozen half stays
    bit-identical, with Adam moments of 0. JAX's update runs on a subtree
    that holds every kind of parameter of both halves (its mask marks the
    top-level 'se' and 'vad' keys, and AGC and Adam act per tensor), which
    keeps its compile short."""
    from challenge_tpu.train.state import TrainState as JState
    from challenge_tpu.train.state import make_grad_update as jax_grad_update
    rng = np.random.default_rng(12)

    def grad(leaf):
        leaf = np.asarray(leaf)
        unit = rng.choice([1e-3, 0.1], leaf.shape[-1:])
        return (leaf * unit + 1e-4 * rng.standard_normal(leaf.shape)
                ).astype(np.float32)
    grads = jax.tree.map(grad, variables['params'])
    sub = {'se': ('ConvSet_0', 'Upsampling_3'),
           'vad': ('ConvMPBlock_0', 'Dense_0', 'FullyConnectedLayer_0',
                   'FullyConnectedLayer_3')}

    def subtree(tree):
        return {top: {k: tree[top][k] for k in keys}
                for top, keys in sub.items()}
    params = subtree(variables['params'])
    jbundle = JBundle(JSECascade(pretrain=pretrain), SHAPE,
                      JConfig(**_cfg(pretrain)), multi_output=True)
    _, update_fn, opt = jax_grad_update(jbundle)
    jstate = JState(step=jnp.zeros([], jnp.int32), params=params,
                    batch_stats={}, opt_state=opt.init(params),
                    swa_params=params, swa_batch_stats={},
                    swa_count=jnp.zeros([], jnp.int32))
    jstate = jax.device_get(jax.jit(update_fn)(jstate, subtree(grads), {}))
    ref = flax_to_state_dict({'params': jstate.params})

    pm = _port(variables, pretrain)
    bundle = ModelBundle(pm, SHAPE, Config(**_cfg(pretrain)),
                         torch.device('cpu'), multi_output=True)
    state = TrainState(pm, make_optimizer(bundle.config, pm.parameters()))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    by_name = flax_to_state_dict({'params': grads})
    make_grad_update(bundle)[1](
        state, [by_name[n] for n, _ in pm.named_parameters()])
    frozen = 'vad.' if pretrain else 'se.'
    assert len(ref) == 24 and 'se.ups.3.up.weight' in ref
    for n, p in pm.named_parameters():
        if n in ref:
            np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=n)
        assert torch.equal(p, before[n]) == n.startswith(frozen), n
    names = {id(p): n for n, p in pm.named_parameters()}
    for p, s in state.optimizer.state.items():
        if names[id(p)].startswith(frozen):
            assert not s['m'].any() and not s['v'].any()


@pytest.mark.slow
def test_one_train_step_matches_jax_in_float64(variables):
    """One whole step (forward, se_loss, backward, AGC, mask, Adam) from a
    bridged init on a batch of the port's pipeline, float64 on both sides
    (ROADMAP C2): the losses, the parameters and the BN statistics."""
    from challenge_tpu.train.state import TrainState as JState
    from challenge_tpu.train.state import make_train_step as jax_train_step
    from challenge_tpu_torch.data.pipeline import DevicePipeline, build_banks
    from challenge_tpu_torch.train.state import make_train_step
    cfg = _cfg(True)
    banks = build_banks(*small_sources(2), n_frame=N_FRAME, device='cpu')
    xb, yb = next(iter(DevicePipeline(banks, Config(**cfg), device='cpu')))
    pm = _port(variables, True, torch.float64)
    bundle = ModelBundle(pm, SHAPE, Config(**cfg), torch.device('cpu'),
                         multi_output=True)
    state = TrainState(pm, make_optimizer(bundle.config, pm.parameters()))
    logs = make_train_step(bundle)(
        state, (xb.double(), tuple(t.double() for t in yb)))
    with jax.enable_x64(True):
        jm = JSECascade(v=9, pretrain=True, dtype=jnp.float64)
        step, opt = jax_train_step(JBundle(jm, SHAPE, JConfig(**cfg),
                                           multi_output=True))
        v = _f64(variables)
        jstate = JState(step=jnp.zeros([], jnp.int32), params=v['params'],
                        batch_stats=v['batch_stats'],
                        opt_state=opt.init(v['params']),
                        swa_params=v['params'],
                        swa_batch_stats=v['batch_stats'],
                        swa_count=jnp.zeros([], jnp.int32))
        batch = _f64((xb.numpy(), tuple(t.numpy() for t in yb)))
        jstate, metrics = jax.device_get(step(jstate, batch,
                                              jax.random.PRNGKey(0)))
    for k in ('loss', 'class_loss', 'speech_loss', 'noise_loss'):
        np.testing.assert_allclose(float(logs[k]), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    ref = flax_to_state_dict({'params': jstate.params,
                              'batch_stats': jstate.batch_stats})
    sd = pm.state_dict()
    for k, t in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def _two_phase_loop(pretrain, banks, weights=None):
    from challenge_tpu_torch.data.pipeline import DevicePipeline
    from challenge_tpu_torch.train.loop import TrainLoop
    cfg = Config(**_cfg(pretrain))
    loop = TrainLoop(get_model(cfg, device='cpu'), seed=0)
    if weights is not None:
        loop.set_weights(weights)
    before = loop.get_weights()
    hist = loop.fit(iter(DevicePipeline(banks, cfg, device='cpu')),
                    epochs=1, steps_per_epoch=2, verbose=0)
    return loop, before, hist


def test_two_phase_training_freezes_one_half():
    """Pretrain moves the U-Net's weights and BN statistics and leaves the
    head's bit-identical; finetune, from the pretrain weights, the reverse
    (mirrors tests/test_train.py::test_se_v9_two_phase_training and
    test_se_frozen_half_batchnorm_runs_in_inference_mode)."""
    from challenge_tpu_torch.data.pipeline import build_banks
    banks = build_banks(*small_sources(3), n_frame=N_FRAME, device='cpu')
    weights = None
    for pretrain, frozen in ((True, 'vad.'), (False, 'se.')):
        loop, before, hist = _two_phase_loop(pretrain, banks, weights)
        assert {'loss', 'class_loss', 'speech_loss', 'noise_loss',
                'class_er', 'class_cos_sim', 'class_f1_score'} <= set(hist[0])
        assert all(np.isfinite(v) for v in hist[0].values())
        after = loop.get_weights()
        for k, v in after.items():
            assert torch.equal(v, before[k]) == k.startswith(frozen), k
        weights = after


def test_se_cli_pretrain_finetune_eval_on_the_cpu(tmp_path, monkeypatch,
                                                  capsys):
    """``sj_train --pretrain True`` writes ``{run}_weight.h5``; put under
    the finetune run's name, the finetune run (no --pretrain: the
    reference's bool flag reads 'False' as True) loads it, trains the head
    only and saves a checkpoint whose U-Net is the pretrain one, bit for
    bit; then the eval CLI scores it."""
    from challenge_tpu_torch.cli import eval as eval_cli
    from challenge_tpu_torch.cli import sj_train
    from challenge_tpu_torch.train.checkpoint import load_weights
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    make_datafiles(tmp_path, n_frame=N_FRAME)
    write_wav(tmp_path / 'clip01.wav', seconds=2.0, seed=1, tone_hz=440)
    with open(tmp_path / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': {'clip01': [[0, 0.5, 1.5]]}}, f)
    argv = ['--model_type', 'se', '--v', '9', '--n_frame', str(N_FRAME),
            '--batch_size', str(BATCH), '--epochs', '1',
            '--steps_per_epoch', '1', '--datapath', str(tmp_path),
            '--device', 'cpu'] + DATA_FLAGS
    pre = sj_train.main(argv + ['--pretrain', 'True'])
    assert pre.endswith('_weight')
    run = pre[:-len('_weight')]
    shutil.copy(f'{pre}.h5', f'{run}.h5')
    assert sj_train.main(argv) == run
    assert 'loaded pretrained model' in capsys.readouterr().out
    a, b = load_weights(f'{pre}.h5'), load_weights(f'{run}.h5')
    assert all(torch.equal(a[k], b[k]) == k.startswith('se.') for k in a)
    with open(f'{run}.csv') as f:
        header = f.readline().strip().split(',')
    assert {'val_class_er', 'val_class_loss', 'val_speech_loss'} <= \
        set(header)
    ers = eval_cli.main(['--name', run, '--p', '--device', 'cpu'])
    assert len(ers) == 1 and np.isfinite(ers[0])


def test_evaluate_se_grids_and_ers_equal_jax(variables, tmp_path,
                                             monkeypatch):
    """The se eval branch (the real half without the DC row, no filter,
    mel or log; the class head) with bridged weights, windows of 32
    frames every 32: the model's input windows (within 1e-5 of their peak,
    the ingest's bound in test_torch_eval.py) and class outputs (1e-5) on
    both sides, and the same grids and ERs as JAX's evaluate(). The
    random head's outputs hardly vary with its input, so class 0's bias
    is raised by 0.5: its grid is all events, the others' all silence,
    each far from the threshold."""
    from challenge_tpu.evaluate import infer as jinfer
    from challenge_tpu_torch.evaluate import infer
    answers = {}
    for i, secs in enumerate((2.0, 3.5)):
        write_wav(tmp_path / f'clip{i}.wav', seconds=secs, seed=20 + i,
                  tone_hz=500)
        answers[f'clip{i}'] = [[i, 0.5, 1.5]]
    with open(tmp_path / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': answers}, f)
    v = jax.tree.map(np.array, variables)
    v['params']['vad']['FullyConnectedLayer_3']['Dense_0']['bias'][0] += 0.5

    def record(module):
        grids = []
        orig = module.get_start_end_frame
        monkeypatch.setattr(module, 'get_start_end_frame',
                            lambda g: grids.append(np.asarray(g))
                            or orig(g))
        return grids
    jcalls = []

    class Recording(JBundle):
        def apply(self, variables, x, training=False, rngs=None):
            out = super().apply(variables, x, training, rngs)
            jax.debug.callback(lambda a, b: jcalls.append(
                (np.asarray(a), np.asarray(b))), x, out[0])
            return out
    cfg = dict(model_type='se', v=9, n_frame=N_FRAME, n_chan=2)
    jgrids = record(jinfer)
    jers = jinfer.evaluate(JConfig(**cfg),
                           Recording(JSECascade(), SHAPE, JConfig(**cfg),
                                     multi_output=True),
                           v, overlap_hop=32, eval_dir=str(tmp_path))
    pm = _port(v, False)
    calls = []
    hook = pm.register_forward_hook(
        lambda m, a, out: calls.append((a[0].numpy(), out[0].numpy())))
    grids = record(infer)
    ers = infer.evaluate(Config(**cfg), pm, overlap_hop=32,
                         eval_dir=str(tmp_path))
    hook.remove()
    assert len(calls) == len(jcalls) == len(grids) == len(jgrids) == 2
    # JAX scores the dev set as one batch of clips zero-padded to the
    # longest, so each clip's windows lead its padded ones
    for (x, out), (jx, jout) in zip(calls, jcalls):
        n = len(x)
        assert x.shape[1:] == jx.shape[1:] == SHAPE and n <= len(jx)
        assert np.abs(x - jx[:n]).max() <= 1e-5 * np.abs(jx[:n]).max()
        np.testing.assert_allclose(out, jout[:n], **TOL)
    for g, jg in zip(grids, jgrids):
        assert g.shape == jg.shape and g.shape[1] == 3
        np.testing.assert_array_equal(g, jg)
        assert g[:, 0].all() and not g[:, 1:].any()
    assert ers == jers and all(np.isfinite(ers))


def test_only_se_v9_builds_and_eff_eval_is_refused():
    from challenge_tpu_torch.evaluate.infer import spec_to_scores
    with pytest.raises(ValueError, match='only se v9'):
        get_model(Config(model_type='se', v=3), device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP A12'):
        spec_to_scores(Config(model_type='eff'), None, torch.zeros(257, 8, 4))
    bundle = get_model(Config(**_cfg(True)), device='cpu')
    assert bundle.multi_output and bundle.input_shape == SHAPE
    mask = bundle.trainable_mask()
    names = [n for n, _ in bundle.module.named_parameters()]
    assert mask == [n.startswith('se.') for n in names] and any(mask)
    assert copy.deepcopy(bundle.module).pretrain
