"""The EfficientNet-SED family of the port (challenge_tpu_torch/models/
effnet.py, the GRU of models/layers.py, the eff rules of
interop/jax_weights.py, stochastic depth through ``grad_fn`` and
``TrainLoop``) against the JAX ``EffNetSED``.

The same numpy-made variables go to both sides (random BN statistics
included), on B0 at small sizes: 32 mels x 64 frames (v5 at 128 frames, so
that it maps 4 frames to 2), v7 at 40 x 256 in eval mode (its gate conv
over the mels must give as many frames as the backbone: ceil(40 / 5) =
256 / 32) and 10 x 64 in training mode (2 and 2; JAX's float64 B0 step at
40 x 256 runs 20 s on a CPU). Tolerances: eval-mode outputs within 1e-5 of
the output's peak in float32; training-mode outputs and the new BN
statistics in float64, with JAX's keep masks of stochastic depth read from
its ``Dropout`` calls and given to the port: outputs 1e-10, the statistics
at JAX's values rounded to float32 by the bridge. The gradients likewise,
within 1e-9 of the largest, on a shallow, narrow backbone (``SHALLOW``):
JAX takes about 9 s to compile B0's. The GRU alone in float64 at 1e-12.
The port's own masks are held by their rate.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from _torch_parity import f64, inject_masks, vad_variables, x64
from challenge_tpu import config as jconfig
from challenge_tpu.models import effnet as jeff
from challenge_tpu.models import registry as jregistry
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models import effnet, layers
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.models.senet import SECascade
from challenge_tpu_torch.models.vad import VADModel

# (v, n_layers, n_mels, n_frame) of the eval-mode checks
EVAL_CASES = [(1, 0, 32, 64), (3, 0, 32, 64), (5, 0, 32, 128),
              (6, 0, 32, 64), (7, 0, 40, 256), (3, 2, 32, 64)]
TRAIN_CASES = [(3, 32, 64), (7, 10, 64)]
# jax.eval_shape's parameter counts at 80 mels, 512 frames, 2 channels
COUNTS = {(0, 1): 5_012_155, (7, 1): 65_774_319, (0, 3): 4_018_783,
          (0, 5): 7_064_287, (0, 6): 7_163_295, (0, 7): 11_251_039}


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """Two threads, as in test_torch_vad_versions.py: the suite runs in
    several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_params(model: int, v: int, n_mels: int = 80, n_frame: int = 512):
    m = jeff.EffNetSED(model=model, v=v, n_mels=n_mels, n_frame=n_frame)
    shapes = jax.eval_shape(
        lambda k: m.init({'params': k, 'dropout': k},
                         jnp.zeros((1, n_mels, n_frame, 2))),
        jax.random.PRNGKey(0))
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        shapes['params']))


def port_params(model: int, v: int, n_mels: int = 80, n_frame: int = 512):
    with torch.device('meta'):
        m = effnet.EffNetSED(model=model, v=v, n_mels=n_mels, n_frame=n_frame)
    return sum(p.numel() for p in m.parameters())


# ------------------------------------------------------------------ shapes
def test_scaling_and_rounding_equal_jax():
    assert effnet.SCALING == jeff.SCALING
    assert effnet.BLOCK_ARGS == jeff.BLOCK_ARGS
    for b, (width, depth) in jeff.SCALING.items():
        for f in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
            assert effnet.round_filters(f, width) == \
                jeff.round_filters(f, width), (b, f)
        for r in (1, 2, 3, 4):
            assert effnet.round_repeats(r, depth) == \
                jeff.round_repeats(r, depth), (b, r)


@pytest.mark.parametrize('model', range(8))
def test_backbone_parameter_counts_equal_jax(model):
    """B0-B7 with the v1 head at full width, the port built on the meta
    device."""
    n = jax_params(model, 1)
    assert port_params(model, 1) == n
    assert COUNTS.get((model, 1), n) == n


@pytest.mark.parametrize('v', [3, 5, 6, 7])
def test_head_parameter_counts_equal_jax(v):
    n = jax_params(0, v)
    assert port_params(0, v) == n == COUNTS[(0, v)]


@pytest.mark.parametrize('v', [2, 4, 9])
def test_bad_versions_raise_jax_messages(v):
    with pytest.raises(ValueError) as jerr:
        jregistry.get_model(jconfig.Config(model_type='eff', v=v))
    with pytest.raises(ValueError) as err:
        get_model(Config(model_type='eff', v=v), device='cpu')
    assert str(err.value) == str(jerr.value)


def test_same_padding_pads_more_at_the_end():
    """TF 'SAME' with stride 2 on even sizes: the stem (3/2) pads (0, 1),
    a 5/2 depthwise conv (1, 2); odd sizes pad evenly; v7's gate conv (16,
    stride 5) over 80 mels pads (5, 6)."""
    assert effnet.same_pads(40, 3, 2) == (0, 1)
    assert effnet.same_pads(40, 5, 2) == (1, 2)
    assert effnet.same_pads(5, 3, 2) == (1, 1)
    assert effnet.same_pads(80, 16, 5) == (5, 6)
    assert effnet.same_pads(40, 3, 1) == (1, 1)


# --------------------------------------------------------------------- GRU
@pytest.fixture(scope='module')
def bigru():
    """flax's BiGRU(128) on 20-wide inputs, its variables from numpy, the
    port's BiGRU with them bridged, and JAX's outputs and gradients of a
    weighted sum; all in float64."""
    from challenge_tpu.models.layers import BiGRU as JBiGRU
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16, 20))
    r = rng.standard_normal((3, 16, 256))
    jm = JBiGRU(128, dtype=jnp.float64)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 20)))
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3)
                          .astype(np.float32), shapes['params'])
    pm = layers.BiGRU(20, 128).double()
    sd = flax_to_state_dict({'params': {'BiGRU_0': params}})
    pm.load_state_dict({k[len('gru.'):]: v.double() for k, v in sd.items()},
                       strict=True)
    with x64():
        def loss(p, x):
            out = jm.apply({'params': p}, x)
            return jnp.sum(out * r), out
        (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(f64(params), jnp.asarray(x))
        ref, gp, gx = jax.device_get((ref, gp, gx))
    grads = flax_to_state_dict({'params': {'BiGRU_0': gp}})
    return x, r, params, pm, np.asarray(ref), grads, np.asarray(gx)


def test_gru_has_flax_leaves_and_four_biases(bigru):
    _, _, params, pm, *_ = bigru
    cell = params['GRUCell_0']
    assert sorted(cell) == ['hn', 'hr', 'hz', 'in', 'ir', 'iz']
    assert sorted(k for k in cell if 'bias' in cell[k]) == \
        ['hn', 'in', 'ir', 'iz']
    biases = [n for n, _ in pm.cells[0].named_parameters()
              if n.endswith('bias')]
    assert sorted(biases) == ['gates.hn.bias', 'gates.in.bias',
                              'gates.ir.bias', 'gates.iz.bias']
    np.testing.assert_array_equal(
        pm.cells[1].gates['in'].weight.detach().numpy(),
        params['GRUCell_1']['in']['kernel'].T)


def test_gru_cell_matches_flax(bigru):
    """One direction alone, the forward cell from zeros, and the reversed
    one: scanned from the last frame, outputs kept in frame order."""
    x, _, _, pm, ref, _, _ = bigru
    with torch.no_grad():
        fwd = pm.cells[0](torch.from_numpy(x)).numpy()
        bwd = pm.cells[1](torch.from_numpy(x)).numpy()
        one = pm.cells[1](torch.from_numpy(x[:, -1:])).numpy()
    np.testing.assert_allclose(fwd, ref[..., :128], rtol=0, atol=1e-12)
    np.testing.assert_allclose(bwd, ref[..., 128:], rtol=0, atol=1e-12)
    # the backward pass's last frame has seen one input: a single step
    np.testing.assert_allclose(one[:, 0], bwd[:, -1], rtol=0, atol=1e-12)


def test_bigru_outputs_and_gradients_match_flax(bigru):
    x, r, _, pm, ref, grads, gx = bigru
    xt = torch.from_numpy(x).requires_grad_()
    out = pm(xt)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-12)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=1e-10)
    # the bridge hands JAX's gradients over rounded to float32
    for name, t in pm.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), grads['gru.' + name],
                                   rtol=1e-7, atol=0, err_msg=name)


# ---------------------------------------------------------- eval forward
@functools.lru_cache(maxsize=None)
def _models(v, n_layers, n_mels, n_frame):
    """(numpy-made flax variables, the port's module with them bridged, a
    3-sample input)."""
    shape = (n_mels, n_frame, 2)
    jm = jeff.EffNetSED(v=v, n_layers=n_layers, n_mels=n_mels,
                        n_frame=n_frame)
    variables = vad_variables(jm, shape, seed=10 * v + n_layers)
    pm = effnet.EffNetSED(v=v, n_layers=n_layers, n_mels=n_mels,
                          n_frame=n_frame)
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd, strict=True)
    x = np.random.default_rng(v).standard_normal((3,) + shape)
    return variables, pm, x.astype(np.float32)


@pytest.mark.parametrize('v,n_layers,n_mels,n_frame', EVAL_CASES)
def test_eval_forward_matches_jax(v, n_layers, n_mels, n_frame):
    variables, pm, x = _models(v, n_layers, n_mels, n_frame)
    jm = jeff.EffNetSED(v=v, n_layers=n_layers, n_mels=n_mels,
                        n_frame=n_frame)
    ref = np.asarray(jax.jit(lambda w, x: jm.apply(w, x, training=False))(
        variables, x))
    pm.eval()
    with torch.no_grad():
        out = pm(torch.from_numpy(x))          # no generator needed
    frames = {1: n_frame, 5: n_frame * 256 // 16000}.get(v, n_frame // 32)
    assert out.shape == ref.shape == (3, frames, 3)
    assert out.dtype == torch.float32 and ref.std() > 1e-3
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


# ------------------------------------------------------ training forward
@contextlib.contextmanager
def record_dropout(rec):
    """flax's ``Dropout`` replaced by a subclass that appends each call's
    per-sample keep mask to ``rec``, in call order, with the largest
    distance of its output from ``where(keep, x / (1 - rate), 0)``."""

    class Dropout(nn.Dropout):
        def __call__(self, inputs, deterministic=None, rng=None):
            out = super().__call__(inputs, deterministic, rng)
            keep = jnp.any(out != 0, axis=(1, 2, 3))
            rec.append((keep, jnp.max(jnp.abs(jnp.where(
                keep[:, None, None, None], inputs / (1.0 - self.rate), 0.0)
                - out))))
            return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, 'Dropout', Dropout)
        yield


# a shallow, narrow EfficientNet for the whole-model gradients (width 0.25,
# depth 0.5: 10 blocks, 3 of them with stochastic depth), entered in both
# packages' SCALING under its own number; JAX compiles B0's float64
# gradient in about 9 s on a CPU
SHALLOW = 8


@functools.lru_cache(maxsize=None)
def _jax_train(v, n_mels, n_frame, model=0):
    """JAX's float64 training forward of a 3-sample batch, its new BN
    statistics, its keep masks and, for the shallow model, the gradients
    of a weighted sum of the outputs (one compile)."""
    shape = (n_mels, n_frame, 2)
    variables = vad_variables(jeff.EffNetSED(model, v=v, n_mels=n_mels,
                                             n_frame=n_frame), shape, seed=v)
    rng = np.random.default_rng(v + 1)
    x = rng.standard_normal((3,) + shape)
    r = rng.standard_normal((3, n_frame // 32, 3))
    with x64():
        jm = jeff.EffNetSED(model, v=v, n_mels=n_mels, n_frame=n_frame,
                            dtype=jnp.float64)

        def loss(params, stats, x):
            rec = []
            with record_dropout(rec):
                out, mut = jm.apply(
                    {'params': params, 'batch_stats': stats}, x,
                    training=True, mutable=['batch_stats'],
                    rngs={'dropout': jax.random.PRNGKey(1)})
            return jnp.sum(out * r), (out, mut, rec)

        w = f64(variables)
        args = (w['params'], w['batch_stats'], jnp.asarray(x))
        if model == SHALLOW:
            (_, (out, mut, rec)), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 2), has_aux=True))(*args)
        else:
            (_, (out, mut, rec)), grads = jax.jit(loss)(*args), None
        out, mut, rec, grads = jax.device_get((out, mut, rec, grads))
    return variables, x, r, out, mut, rec, grads


def _port_train(v, n_mels, n_frame, model=0):
    variables, x, r, out, mut, rec, grads = _jax_train(v, n_mels, n_frame,
                                                       model)
    pm = effnet.EffNetSED(model, v=v, n_mels=n_mels, n_frame=n_frame)
    pm.double().load_state_dict({k: t.double() for k, t in
                                 flax_to_state_dict(variables).items()})
    inject_masks(pm, [m for m, _ in rec])
    xt = torch.from_numpy(x).requires_grad_()
    o = pm.train()(xt, torch.Generator())
    (o * torch.from_numpy(r)).sum().backward()
    return pm, o.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize('v,n_mels,n_frame', TRAIN_CASES)
def test_train_forward_and_bn_stats_match_jax(v, n_mels, n_frame):
    """B0 in training mode: the outputs and every new BN statistic."""
    _, _, _, out, mut, rec, _ = _jax_train(v, n_mels, n_frame, 0)
    # JAX's own rule, where(keep, x / (1 - rate), 0), held by its masks
    assert all(float(err) == 0.0 for _, err in rec)
    masks = np.array([m for m, _ in rec])
    assert 0 < (~masks).sum() < masks.size       # some samples dropped
    pm, o, _ = _port_train(v, n_mels, n_frame, 0)
    np.testing.assert_allclose(o, out, rtol=0, atol=1e-10)
    new = flax_to_state_dict({'batch_stats': mut['batch_stats']})
    sd = pm.state_dict()
    assert len(new) == 2 * sum(isinstance(m, layers.BatchNorm)
                               for m in pm.modules())
    for k, t in new.items():
        np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-7,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize('v,n_mels,n_frame', TRAIN_CASES)
def test_train_gradients_match_jax(v, n_mels, n_frame, monkeypatch):
    """The shallow model's gradients of every parameter and of the input,
    with JAX's masks; the bridge rounds JAX's to float32, and a BN shift
    feeding another BN has a gradient of zero up to 1e-14, so each is
    held within 1e-9 of the largest."""
    for scaling in (jeff.SCALING, effnet.SCALING):
        monkeypatch.setitem(scaling, SHALLOW, (0.25, 0.5))
    _, _, _, out, _, rec, (gp, gx) = _jax_train(v, n_mels, n_frame, SHALLOW)
    assert len(rec) == 3 and not np.array([m for m, _ in rec]).all()
    pm, o, gxt = _port_train(v, n_mels, n_frame, SHALLOW)
    np.testing.assert_allclose(o, out, rtol=0, atol=1e-10)
    np.testing.assert_allclose(gxt, gx, rtol=1e-9, atol=1e-12)
    ref = flax_to_state_dict({'params': gp})
    peak = max(float(np.abs(t.numpy()).max()) for t in ref.values())
    assert set(ref) == {n for n, _ in pm.named_parameters()}
    for name, t in pm.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=1e-9 * peak,
                                   err_msg=name)


# --------------------------------------------------- the port's own masks
def test_port_masks_drop_at_the_block_rate():
    """A block draws one Bernoulli(1 - rate) per sample from the generator
    it is given; a dropped sample's output is its input, a kept one's the
    branch scaled by 1 / (1 - rate) plus the input. The eval forward draws
    nothing."""
    block = effnet.MBConv(3, 8, 8, 6, 1, drop_rate=0.3).train()
    gen = torch.Generator().manual_seed(0)
    keep = block.keep_mask(torch.zeros(40_000, 8, 1, 1), gen)
    assert keep.shape == (40_000, 1, 1, 1) and keep.dtype == torch.bool
    # 0.7 within 5 standard deviations of the mean of 40,000 draws
    assert abs(keep.float().mean().item() - 0.7) < 5 * (0.21 / 40_000) ** .5
    x = torch.randn(64, 8, 5, 5)
    state = gen.get_state()
    with torch.no_grad():
        y = block(x, gen)
        gen.set_state(state)
        m = block.keep_mask(x, gen)
        branch = copy.deepcopy(block)
        branch.residual = False
        z = branch(x)
    assert 0 < int(m.sum()) < 64
    torch.testing.assert_close(y[~m.flatten()], x[~m.flatten()], rtol=0,
                               atol=0)
    torch.testing.assert_close(y[m.flatten()],
                               (z / 0.7 + x)[m.flatten()])
    block.eval()
    before = gen.get_state()
    block(x, gen)
    assert torch.equal(gen.get_state(), before)


def test_training_forward_needs_a_generator():
    m = get_model(Config(model_type='eff', v=3, n_mels=32, n_frame=64),
                  device='cpu').module
    x = torch.zeros(2, 32, 64, 2)
    with pytest.raises(ValueError, match='dropout generator'):
        m.train()(x)
    assert m.eval()(x).shape == (2, 2, 3)


@pytest.mark.parametrize('v', effnet.VERSIONS)
def test_get_model_builds_each_head_on_the_cpu(v):
    n_mels, n_frame = (40, 256) if v == 7 else (32, 64)
    bundle = get_model(Config(model_type='eff', v=v, n_mels=n_mels,
                              n_frame=n_frame), device='cpu', seed=v)
    m = bundle.module
    assert bundle.input_shape == (n_mels, n_frame, 2)
    assert bundle.needs_dropout_gen and not bundle.multi_output
    # flax's initializers: unit BN scales, zero biases, LeCun kernels
    # (variance 1 / fan_in), orthogonal recurrent kernels
    w = m.backbone.blocks[5].convs[0].weight
    assert abs(w.var().item() * w[0].numel() - 1.0) < 0.1
    assert all(float(p.detach().abs().max()) == 0.0
               for n, p in m.named_parameters()
               if n.endswith('.bias') and 'bns' not in n and 'bn.' not in n)
    if m.gru is not None:
        h = m.gru.cells[1].gates['hz'].weight
        torch.testing.assert_close(h @ h.T, torch.eye(128), atol=1e-5,
                                   rtol=0)
    x = torch.randn(2, n_mels, n_frame, 2)
    assert torch.isfinite(m.train()(x, torch.Generator())).all()


# ------------------------------------------------------------------ bridge
def test_bridge_eff_names_and_layouts():
    """The eff rules: MBConv leaves shift by one without an expand conv,
    the gate conv and the transposed convs of 1-D kernels, the resample
    kernel as it is; vad v7 and se trees still map by their rules."""
    variables, pm, _ = _models(1, 0, 32, 64)
    sd = flax_to_state_dict(variables)
    p = variables['params']
    bb = p['EfficientNetBackbone_0']
    np.testing.assert_array_equal(        # MBConv_0: no expand conv
        sd['backbone.blocks.0.convs.0.weight'].numpy(),
        bb['MBConv_0']['Conv_0']['kernel'].transpose(3, 2, 0, 1))
    assert sd['backbone.blocks.0.convs.0.weight'].shape == (32, 1, 3, 3)
    assert sd['backbone.blocks.1.convs.1.weight'].shape == (96, 1, 3, 3)
    assert sd['backbone.head.weight'].shape == (1280, 320, 1, 1)
    k = p['ConvTranspose_0']['kernel']                 # [2, in, out]
    np.testing.assert_array_equal(sd['ups.0.weight'].numpy(),
                                  k[::-1].transpose(1, 2, 0))
    variables, _, _ = _models(5, 0, 32, 128)
    sd = flax_to_state_dict(variables)
    np.testing.assert_array_equal(
        sd['resample.weight'].numpy(),
        variables['params']['TimeAxisResample_0']['kernel'])
    variables, _, _ = _models(7, 0, 40, 256)
    sd = flax_to_state_dict(variables)
    k = variables['params']['Conv_0']['kernel']         # [16, in, out]
    assert k.shape == (16, 512, 256)
    np.testing.assert_array_equal(sd['gate.weight'].numpy(),
                                  k.transpose(2, 1, 0))
    # vad v7's top-level Conv_k are its bottlenecks', se's its U-Net's
    from challenge_tpu.models.senet import SECascade as JSECascade
    from challenge_tpu.models.vad import VADModel as JVADModel
    for jm, pm, shape in (
            (JVADModel(v=7, base_fsize=8, td_dim=32),
             VADModel(v=7, base_fsize=8, td_dim=32, n_mels=32),
             (32, 64, 2)),
            (JSECascade(pretrain=True), SECascade(pretrain=True),
             (256, 32, 2))):
        sd = flax_to_state_dict(vad_variables(jm, shape))
        assert set(sd) == set(pm.state_dict())
