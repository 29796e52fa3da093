"""vad v6, v7 and v9 of the port (challenge_tpu_torch/models/vad.py, the
layers of models/layers.py: ``smoothing_pool``, ``Bottleneck``, ``LSTM``,
``BiLSTM``) and their weight bridge (interop/jax_weights.py) against the
JAX ``VADModel``, shrunk to base_fsize 8 and td_dim 32 on a 32 x 64 input.
The head's widths (FC 512, BiLSTM 128) are fixed in both packages.

The same numpy-made variables go to both sides. Tolerances, as for v8
(test_torch_vad.py): eval-mode outputs 1e-5 in float32; training-mode
outputs and the new BN statistics 1e-5 with both sides in float64, since
JAX's own float32 training-mode output is ill-conditioned at this size
(ROADMAP C2). Each trap of the new layers is held alone against JAX's own
function: the uneven 'SAME' pools of v6 exactly (the same sums, in float64),
the BiLSTM's outputs in float64 at 1e-12 and its gradients at JAX's values
rounded to float32 by the bridge, AGC per gate of the LSTM at 1e-6 relative
(float32, as test_torch_train.py holds AGC). One v9 training step runs in
float64 on both sides, as test_torch_train.py runs v8's; JAX takes about
14 s to compile it on a CPU, so it is marked slow, and its two halves are held fast:
the BiLSTM's gradients and the update on the same gradients.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import N_FRAME, N_MELS, vad_variables
from challenge_tpu.config import Config as JConfig
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models import layers
from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.train.optim import adaptive_clip_grad, make_optimizer
from challenge_tpu_torch.train.state import TrainState, make_train_step

SHAPE = (N_MELS, N_FRAME, 2)
TOL = dict(rtol=1e-5, atol=1e-5)
VERSIONS = (6, 7, 9)


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """Full-width models on torch's default thread count (every core)
    oversubscribe the CPU when the suite runs in several workers and slow
    the other test files (as in test_torch_se.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@contextlib.contextmanager
def _x64():
    """``jax.enable_x64`` with flax's LSTM cell keeping its state in
    float64: its ``param_dtype`` (the dtype of its zero initial carry)
    stays float32 under the model's ``dtype=float64``, and ``lax.scan``
    then refuses the float64 carry the cell returns. A subclass of the
    same name keeps the flax variable paths."""
    from flax import linen as nn

    class OptimizedLSTMCell(nn.OptimizedLSTMCell):
        param_dtype: object = jnp.float64

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, 'OptimizedLSTMCell', OptimizedLSTMCell)
        yield


@functools.lru_cache(maxsize=None)
def _models(v):
    """(v, numpy-made flax variables, the port's module with them bridged,
    a 3-sample input)."""
    jm = JVADModel(v=v, base_fsize=8, td_dim=32)
    variables = vad_variables(jm, SHAPE, seed=v)
    pm = VADModel(v=v, base_fsize=8, td_dim=32, n_mels=N_MELS, n_chan=2)
    pm.load_state_dict(flax_to_state_dict(variables), strict=True)
    x = np.random.default_rng(v).standard_normal((3,) + SHAPE)
    return v, variables, pm, x.astype(np.float32)


@pytest.fixture(scope='module', params=VERSIONS)
def models(request):
    return _models(request.param)


def test_bridge_covers_every_tensor(models):
    v, variables, pm, _ = models
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(pm.state_dict())
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(variables))
    assert n_flax == sum(t.numel() for t in pm.state_dict().values())
    if v == 7:
        # top-level Conv_k / BatchNorm_k: bottleneck k // 3, layer k % 3
        k = np.asarray(variables['params']['Conv_4']['kernel'])
        np.testing.assert_array_equal(
            sd['bottlenecks.1.convs.1.weight'].numpy(),
            k.transpose(3, 2, 0, 1))
        assert sd['bottlenecks.3.bns.2.running_var'].shape == (64,)
    if v == 9:
        cell = variables['params']['BiLSTM_0']['OptimizedLSTMCell_1']
        np.testing.assert_array_equal(
            sd['lstm.cells.1.gates.if.weight'].numpy(),
            np.asarray(cell['if']['kernel']).T)
        np.testing.assert_array_equal(sd['lstm.cells.1.gates.ho.bias'].numpy(),
                                      np.asarray(cell['ho']['bias']))
        assert 'lstm.cells.0.gates.ii.bias' not in sd


def test_eval_forward_matches_jax(models):
    v, variables, pm, x = models
    jm = JVADModel(v=v, base_fsize=8, td_dim=32)
    ref = jax.jit(lambda w, x: jm.apply(w, x, training=False))(variables, x)
    pm.eval()
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert out.shape == (3, N_FRAME // 32, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_train_forward_and_bn_stats_match_jax(models):
    """Both sides in float64: the output and the new running statistics."""
    v, variables, pm, x = models
    with _x64():
        jm = JVADModel(v=v, base_fsize=8, td_dim=32, dtype=jnp.float64)
        ref, mut = jax.jit(lambda w, x: jm.apply(
            w, x, training=True, mutable=['batch_stats']))(
                _f64(variables), jnp.asarray(x, jnp.float64))
        ref, mut = np.asarray(ref), jax.device_get(mut)
    pm = copy.deepcopy(pm).double().train()
    with torch.no_grad():
        out = pm(torch.from_numpy(x).double())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    new = flax_to_state_dict({'batch_stats': mut['batch_stats']})
    sd = pm.state_dict()
    n_bn = {6: 17, 7: 17 + 12, 9: 18}[v]
    assert len(new) == 2 * n_bn
    for k, t in new.items():
        np.testing.assert_allclose(sd[k].numpy(), t.numpy(), **TOL,
                                   err_msg=k)


def test_full_width_parameter_counts():
    """vad v6, v7 and v9 at full width (base 32, td_dim 1024, 80 mels,
    2 channels) have JAX's parameter counts (jax.eval_shape)."""
    for v in VERSIONS:
        jm = JVADModel(v=v)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 80, 512, 2)))
        n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            shapes['params']))
        module = VADModel(v=v)
        assert sum(p.numel() for p in module.parameters()) == n
    assert n == 10_392_963


# ---------------------------------------------------------------- layer traps
@pytest.mark.parametrize('t', [64, 33, 5])
def test_smoothing_pools_match_flax_same_padding(t):
    """v6's pools for each of its kernel sizes: even windows pad (w-1)//2
    frames before and the rest after, the average divides by the in-bounds
    count, the max pads with -inf. Negative inputs show a zero pad; float64
    makes the sums exact on both sides."""
    from flax import linen as nn

    from challenge_tpu.models.layers import avg_pool_same
    rng = np.random.default_rng(t)
    x = -1.0 - rng.random((2, 3, 4, t))                   # NCHW, < 0
    for k in (16, 8, 4, 2, 1):
        with jax.enable_x64(True):
            xj = jnp.asarray(x.transpose(0, 2, 3, 1))     # NHWC
            ref = nn.max_pool(avg_pool_same(xj, (1, k), (1, 1)),
                              (1, 2 * k), (1, 1), padding='SAME')
            ref = np.asarray(ref).transpose(0, 3, 1, 2)
        out = layers.smoothing_pool(torch.from_numpy(x), k)
        assert out.shape == x.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-15, atol=0,
                                   err_msg=f'k={k}')


@pytest.fixture(scope='module')
def bilstm():
    """flax's BiLSTM(128) on 20-wide inputs, its variables from numpy, and
    the port's BiLSTM with them bridged; both in float64."""
    from challenge_tpu.models.layers import BiLSTM as JBiLSTM
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16, 20))
    jm = JBiLSTM(128, dtype=jnp.float64)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 20)))
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3)
                          .astype(np.float32), shapes['params'])
    pm = layers.BiLSTM(20, 128).double()
    sd = flax_to_state_dict({'params': {'BiLSTM_0': params}})
    pm.load_state_dict({k[len('lstm.'):]: v.double() for k, v in sd.items()},
                       strict=True)
    with _x64():
        ref = np.asarray(jax.jit(jm.apply)(
            {'params': _f64(params)}, jnp.asarray(x)))
    return x, params, pm, ref


def test_bilstm_directions_match_flax(bilstm):
    """Forward cell on the first 128 outputs, the reversed cell (scanned
    from the last frame, outputs kept in frame order) on the last 128."""
    x, _, pm, ref = bilstm
    with torch.no_grad():
        fwd = pm.cells[0](torch.from_numpy(x)).numpy()
        bwd = pm.cells[1](torch.from_numpy(x)).numpy()
        out = pm(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 16, 256)
    np.testing.assert_allclose(fwd, ref[..., :128], rtol=0, atol=1e-12)
    np.testing.assert_allclose(bwd, ref[..., 128:], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(out, np.concatenate([fwd, bwd], -1))
    # the last frame of the backward pass has seen one input, the first
    # frame of the forward pass likewise: a single cell step from zeros
    one = pm.cells[1](torch.from_numpy(x[:, -1:]))
    np.testing.assert_allclose(one.detach().numpy()[:, 0], bwd[:, -1],
                               rtol=0, atol=1e-12)


def test_lstm_has_one_bias_per_gate_and_agc_clips_each_gate(bilstm):
    """One trained bias per gate (flax's hidden Dense), none on the input
    kernels; AGC on the cell's tensors equals JAX's per-leaf AGC on the
    flax tree: each gate's bias [128] gets its own norm, each kernel's per
    output unit."""
    from challenge_tpu.train import optim as joptim
    _, params, pm, _ = bilstm
    names = [n for n, _ in pm.named_parameters()]
    assert sum(n.endswith('.bias') for n in names) == 8
    assert all(n.split('.')[-2][0] == 'h' for n in names
               if n.endswith('.bias'))
    rng = np.random.default_rng(6)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    # gradient units straddling the threshold: per gate, the bias of one
    # gate far above it, another far below
    g = jax.tree.map(lambda a: (a * rng.choice([1e-4, 0.5], a.shape[-1])
                                ).astype(np.float32), p)
    ref = flax_to_state_dict({'params': {'BiLSTM_0': jax.device_get(
        joptim.adaptive_clip_grad(p, g))}})
    pt = flax_to_state_dict({'params': {'BiLSTM_0': p}})
    gt = flax_to_state_dict({'params': {'BiLSTM_0': g}})
    keys = sorted(pt)
    out = adaptive_clip_grad([pt[k] for k in keys], [gt[k] for k in keys])
    clipped = 0
    for k, o in zip(keys, out):
        np.testing.assert_allclose(o.numpy(), ref[k].numpy(), rtol=1e-6,
                                   atol=0, err_msg=k)
        clipped += int(not torch.equal(o, gt[k]))
    assert clipped > 0
    # one norm over the four gates' biases would clip otherwise
    joint = adaptive_clip_grad(
        [torch.cat([pt[f'lstm.cells.0.gates.h{c}.bias'] for c in 'ifgo'])],
        [torch.cat([gt[f'lstm.cells.0.gates.h{c}.bias'] for c in 'ifgo'])])
    per_gate = torch.cat([out[keys.index(f'lstm.cells.0.gates.h{c}.bias')]
                          for c in 'ifgo'])
    assert not torch.equal(joint[0], per_gate)


def test_bilstm_gradients_match_flax(bilstm):
    """The backward pass through both scans: gradients of a weighted sum of
    the outputs with respect to every cell tensor and to the input."""
    x, params, pm, _ = bilstm
    from challenge_tpu.models.layers import BiLSTM as JBiLSTM
    r = np.random.default_rng(7).standard_normal((3, 16, 256))
    with _x64():
        jm = JBiLSTM(128, dtype=jnp.float64)

        def loss(p, x):
            return jnp.sum(jm.apply({'params': p}, x) * r)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            _f64(params), jnp.asarray(x))
        ref = flax_to_state_dict({'params': {'BiLSTM_0': jax.device_get(gp)}})
        gx = np.asarray(gx)
    xt = torch.from_numpy(x).requires_grad_()
    (pm(xt) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=1e-10)
    # the bridge hands JAX's gradients over rounded to float32
    for name, t in pm.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), ref['lstm.' + name].numpy(),
                                   rtol=1e-7, atol=0, err_msg=name)
        t.grad = None


# ------------------------------------------------------------- v9 one step
def test_v9_update_matches_jax_on_the_same_gradients():
    """The update half of v9's step (AGC per tensor, clipvalue, Keras Adam)
    on the same numpy gradients, both sides in float64: every parameter
    equal to JAX's as the bridge rounds it, to float32 (rtol 1e-7); the
    whole step is the slow test below."""
    from challenge_tpu.train.state import TrainState as JState
    from challenge_tpu.train.state import make_grad_update as jax_grad_update
    from challenge_tpu_torch.train.state import make_grad_update
    _, variables, pm, _ = _models(9)
    cfg = dict(model_type='vad', v=9, n_mels=N_MELS, n_frame=N_FRAME)
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda a: np.asarray(
        a * rng.choice([1e-4, 0.3], a.shape[-1]), np.float32),
        variables['params'])
    pm = copy.deepcopy(pm).double()
    bundle = ModelBundle(pm, SHAPE, Config(**cfg), torch.device('cpu'))
    state = TrainState(pm, make_optimizer(bundle.config, pm.parameters()))
    g = flax_to_state_dict({'params': grads})
    make_grad_update(bundle)[1](state, [g[n].double() for n, _ in
                                        pm.named_parameters()])
    # JAX's update on the head's subtree (the BiLSTM and the FC after it):
    # each tensor's update is its own, and the whole tree takes seconds
    # more to compile on a CPU
    head = ('BiLSTM_0', 'FullyConnectedLayer_3')
    with _x64():
        jm = JVADModel(v=9, base_fsize=8, td_dim=32, dtype=jnp.float64)
        _, update, opt = jax_grad_update(JBundle(jm, SHAPE, JConfig(**cfg)))
        w = _f64({k: variables['params'][k] for k in head})
        jstate = JState(step=jnp.zeros([], jnp.int32), params=w,
                        batch_stats={}, opt_state=opt.init(w), swa_params=w,
                        swa_batch_stats={}, swa_count=jnp.zeros([], jnp.int32))
        jstate = jax.device_get(jax.jit(update)(
            jstate, _f64({k: grads[k] for k in head}), {}))
    ref = flax_to_state_dict({'params': jstate.params})
    sd = pm.state_dict()
    assert len(ref) == 24 + 3          # the cells, FC 64's Dense and BN
    for k, t in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-7,
                                   atol=0, err_msg=k)
    assert not torch.equal(sd['lstm.cells.0.gates.hf.bias'],
                           flax_to_state_dict(variables)[
                               'lstm.cells.0.gates.hf.bias'].double())


@pytest.mark.slow
def test_v9_train_step_matches_jax_in_float64():
    """One training step of v9 (AGC, clipvalue, Keras Adam) from bridged
    weights on one batch, both sides in float64: the loss, every parameter
    and BN statistic after the step within 1e-5."""
    from challenge_tpu.train.state import TrainState as JState
    from challenge_tpu.train.state import make_train_step as jax_train_step
    _, variables, pm, x = _models(9)
    cfg = dict(model_type='vad', v=9, n_mels=N_MELS, n_frame=N_FRAME,
               batch_size=3)
    y = (np.random.default_rng(8).random((3, N_FRAME // 32, 3)) < 0.5
         ).astype(np.float32)
    pm = copy.deepcopy(pm).double()
    bundle = ModelBundle(pm, SHAPE, Config(**cfg), torch.device('cpu'))
    state = TrainState(pm, make_optimizer(bundle.config, pm.parameters()))
    logs = make_train_step(bundle)(state, (torch.from_numpy(x).double(),
                                           torch.from_numpy(y).double()))
    with _x64():
        jm = JVADModel(v=9, base_fsize=8, td_dim=32, dtype=jnp.float64)
        step, opt = jax_train_step(JBundle(jm, SHAPE, JConfig(**cfg)))
        w = _f64(variables)
        jstate = JState(step=jnp.zeros([], jnp.int32), params=w['params'],
                        batch_stats=w['batch_stats'],
                        opt_state=opt.init(w['params']),
                        swa_params=w['params'],
                        swa_batch_stats=w['batch_stats'],
                        swa_count=jnp.zeros([], jnp.int32))
        jstate, metrics = step(jstate, _f64((x, y)), jax.random.PRNGKey(0))
        jstate = jax.device_get(jstate)
    np.testing.assert_allclose(float(logs['loss']), float(metrics['loss']),
                               rtol=1e-5)
    ref = flax_to_state_dict({'params': jstate.params,
                              'batch_stats': jstate.batch_stats})
    sd = pm.state_dict()
    for k, t in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert not torch.equal(sd['lstm.cells.1.gates.hg.bias'],
                           flax_to_state_dict(variables)[
                               'lstm.cells.1.gates.hg.bias'].double())


def test_get_model_builds_the_new_versions_for_every_channel_count():
    for v in VERSIONS:
        for n_chan in (1, 3, 4):
            bundle = get_model(Config(model_type='vad', v=v, n_mels=N_MELS,
                                      n_frame=N_FRAME, n_chan=n_chan),
                               device='cpu')
            assert bundle.input_shape == (N_MELS, N_FRAME, n_chan)
            assert bundle.module.blocks[0].convs[0].in_channels == n_chan
