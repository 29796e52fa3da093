"""Keras-2 legacy HDF5 checkpoints in both directions
(challenge_tpu_torch/interop/keras_h5.py, interop/jax_weights.py
``state_dict_to_flax``) against the JAX package's ``interop/keras_h5.py``.

For each family (vad v1, v7, v8, v9; se v9 with ``pretrain`` False and
True; eff B0 with heads v1, v3, v5, v6, v7; the density head), from the
same numpy-made flax variables:

* a file JAX's ``save_keras_h5_variables`` writes loads into the port,
  whose forward then equals JAX's on the same input within 1e-5 of the
  output's peak (float32; the two BLAS sum in another order);
* the port's file of those weights is JAX's file: the same attributes,
  ``layer_names``, ``weight_names`` in the same order and array bytes;
* JAX's ``load_keras_h5_variables`` reads the port's file back to the
  variables exactly (eff's stem kernel, scaled by 255 and back, within
  an ulp).

JAX's importer checks shapes against ``bundle.init``, which runs flax's
init eagerly (about 10 s for vad v8 here); the tests hand it the same
shapes through ``jax.eval_shape`` (``_torch_parity.shape_bundle``). The
vad models are built at base 8 and td_dim 32, as in
tests/test_torch_eval.py: the Keras plan depends only on the version.
"""

import h5py
import jax
import numpy as np
import pytest
import torch

from _torch_parity import N_FRAME, N_MELS, shape_bundle, vad_variables
from challenge_tpu.config import Config as JConfig
from challenge_tpu.interop import keras_h5 as jk
from challenge_tpu.models import registry as jreg
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.interop import keras_h5 as pk
from challenge_tpu_torch.interop.jax_weights import (
    _leaves, flax_to_state_dict, state_dict_to_flax)
from challenge_tpu_torch.models import registry as preg
from challenge_tpu_torch.models.vad import VADModel

CPU = torch.device('cpu')
FAMILIES = ['vad_v1', 'vad_v7', 'vad_v8', 'vad_v9', 'se_pretrain_False',
            'se_pretrain_True', 'eff_v1', 'eff_v3', 'eff_v5', 'eff_v6',
            'eff_v7', 'density']


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bundles(name):
    """(JAX bundle, port bundle) of one family at a small size."""
    kind, _, arg = name.partition('_')
    if kind == 'vad':
        v = int(arg[1:])
        shape = (N_MELS, N_FRAME, 2)
        cfg = dict(model_type='vad', v=v, n_mels=N_MELS, n_frame=N_FRAME,
                   n_chan=2)
        return (jreg.ModelBundle(JVADModel(v=v, base_fsize=8, td_dim=32),
                                 shape, JConfig(**cfg)),
                preg.ModelBundle(VADModel(v=v, base_fsize=8, td_dim=32,
                                          n_mels=N_MELS), shape,
                                 Config(**cfg), CPU))
    if kind == 'se':
        cfg = dict(model_type='se', v=9, n_frame=32, n_chan=2,
                   pretrain=arg.endswith('True'))
    elif kind == 'eff':
        v = int(arg[1:])
        cfg = dict(model_type='eff', model=0, v=v, n_chan=2, n_layers=1,
                   n_mels=10 if v == 7 else 32, n_frame=64)
    else:
        cfg = dict(model_type='eff', model='EfficientNetB0', n_classes=30,
                   n_mels=32, n_frame=64, n_chan=2, n_layers=1)
        return (jreg.get_density_model(JConfig(**cfg)),
                preg.get_density_model(Config(**cfg), device='cpu'))
    return jreg.get_model(JConfig(**cfg)), preg.get_model(Config(**cfg),
                                                          device='cpu')


@pytest.fixture(scope='module')
def weights():
    """Per family: (JAX bundle, port bundle, numpy flax variables)."""
    cache = {}

    def get(name):
        if name not in cache:
            jb, pb = _bundles(name)
            seed = FAMILIES.index(name)
            cache[name] = (jb, pb, vad_variables(jb.module, jb.input_shape,
                                                 seed=seed))
        return cache[name]
    return get


def _dump(path):
    """Everything a Keras legacy file holds, in file order."""
    out = []
    with h5py.File(path, 'r') as f:
        out.append(sorted((k, repr(v)) for k, v in f.attrs.items()))
        for lname in f.attrs['layer_names']:
            g = f[lname]
            out.append((lname, list(g.attrs['weight_names'])))
            for wn in g.attrs['weight_names']:
                a = np.asarray(g[wn])
                out.append((wn, a.dtype.str, a.shape, a.tobytes()))
    return out


def _tree(variables):
    return {(c,) + p: np.asarray(a) for c in ('params', 'batch_stats')
            for p, a in _leaves(variables.get(c, {}))}


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else (out,))]


@pytest.mark.parametrize('name', FAMILIES)
def test_jax_keras_file_loads_into_the_port(name, weights, tmp_path):
    """JAX writes the file; the port's module loaded from it gives JAX's
    forward within 1e-5 of the peak."""
    jb, pb, variables = weights(name)
    path = str(tmp_path / 'jax.h5')
    jk.save_keras_h5_variables(jb, variables, path)
    pb.module.load_state_dict(pk.load_keras_h5_state_dict(pb, path))
    x = np.random.default_rng(7).standard_normal(
        (2,) + tuple(jb.input_shape)).astype(np.float32)
    ref = _outputs(jax.jit(lambda v, x: jb.apply(v, x))(variables, x))
    pb.module.eval()
    with torch.no_grad():
        out = _outputs(pb.module(torch.from_numpy(x)))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and np.ptp(r) > 1e-3
        assert np.abs(o - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize('name', FAMILIES)
def test_port_keras_file_is_jax_file(name, weights, tmp_path):
    """From the same weights (bridged by ``flax_to_state_dict``) the port
    writes JAX's file: names, order and bytes."""
    jb, pb, variables = weights(name)
    jpath, ppath = str(tmp_path / 'jax.h5'), str(tmp_path / 'port.h5')
    jk.save_keras_h5_variables(jb, variables, jpath)
    pb.module.load_state_dict(flax_to_state_dict(variables))
    pk.save_keras_h5_state_dict(pb, pb.module.state_dict(), ppath)
    assert _dump(ppath) == _dump(jpath)


@pytest.mark.parametrize('name', FAMILIES)
def test_jax_reads_the_port_keras_file_exactly(name, weights, tmp_path):
    """JAX's importer reads the port's file to the tree it reads from its
    own file of the same weights, bit for bit, and that is the variables:
    exactly, but for eff's stem kernel, which the writer scales by 255
    (Keras' Rescaling(1/255) front) and the importer by 1/255, within an
    ulp. The port's importer gives that tree's state_dict exactly."""
    jb, pb, variables = weights(name)
    ppath, jpath = str(tmp_path / 'port.h5'), str(tmp_path / 'jax.h5')
    pk.save_keras_h5_state_dict(pb, flax_to_state_dict(variables), ppath)
    jk.save_keras_h5_variables(jb, variables, jpath)
    sb = shape_bundle(jb)
    back = jax.device_get(jk.load_keras_h5_variables(sb, ppath))
    flat, ref = _tree(back), _tree(jax.device_get(
        jk.load_keras_h5_variables(sb, jpath)))
    want = _tree(variables)
    assert flat.keys() == ref.keys() == want.keys()
    stem = ('params', 'EfficientNetBackbone_0', 'Conv_0', 'kernel')
    for k in want:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=str(k))
        if k == stem:
            np.testing.assert_allclose(flat[k], want[k], rtol=2.5e-7)
        else:
            np.testing.assert_array_equal(flat[k], want[k], err_msg=str(k))
    got, sd = pk.load_keras_h5_state_dict(pb, ppath), flax_to_state_dict(back)
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)


@pytest.mark.parametrize('name', ['vad_v9', 'se_pretrain_True', 'eff_v7',
                                  'density'])
def test_state_dict_to_flax_round_trips(name, weights):
    """``state_dict_to_flax`` inverts ``flax_to_state_dict`` in both
    directions, every leaf under flax's name."""
    _, pb, variables = weights(name)
    tree = state_dict_to_flax(flax_to_state_dict(variables), pb.config)
    assert _tree(tree).keys() == _tree(variables).keys()
    for k, a in _tree(variables).items():
        np.testing.assert_array_equal(_tree(tree)[k], a, err_msg=str(k))
    sd = pb.module.state_dict()
    back = flax_to_state_dict(state_dict_to_flax(pb.module, pb.config))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_biased_stem_conv_folds_into_the_mean(weights, tmp_path):
    """A stem Conv2D with a bias (legal Keras; keras.applications writes
    none) imports as the same weights as the bias-free conv with the bias
    taken off the stem BN's moving mean (tests/test_keras_h5.py:653), in
    the port as in JAX."""
    import shutil

    jb, pb, variables = weights('eff_v3')
    base = str(tmp_path / 'base.h5')
    jk.save_keras_h5_variables(jb, variables, base)
    biased, folded = str(tmp_path / 'biased.h5'), str(tmp_path / 'fold.h5')
    shutil.copy(base, biased)
    shutil.copy(base, folded)
    with h5py.File(biased, 'r+') as f:
        g = f['conv2d']
        b = np.random.default_rng(7).standard_normal(
            g['conv2d/kernel:0'].shape[-1]).astype('f4')
        g.create_dataset('conv2d/bias:0', data=b)
        g.attrs['weight_names'] = [b'conv2d/kernel:0', b'conv2d/bias:0']
    with h5py.File(folded, 'r+') as f:
        mm = f['batch_normalization']['batch_normalization/moving_mean:0']
        mm[...] = mm[...] - b
    sa = pk.load_keras_h5_state_dict(pb, biased)
    sb = pk.load_keras_h5_state_dict(pb, folded)
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    ref = flax_to_state_dict(jax.device_get(
        jk.load_keras_h5_variables(shape_bundle(jb), biased)))
    assert all(torch.equal(sa[k], ref[k]) for k in ref)
    mean = 'backbone.stem_bn.running_mean'
    assert not torch.equal(sa[mean],
                           flax_to_state_dict(variables)[mean])


def test_export_refuses_a_foreign_tree(weights, tmp_path):
    """A v8 state_dict does not export under v7's plan, in either
    package, with JAX's message."""
    _, pb8, variables = weights('vad_v8')
    jb7, pb7, _ = weights('vad_v7')
    with pytest.raises(ValueError, match='export') as port_err:
        pk.save_keras_h5_state_dict(pb7, flax_to_state_dict(variables),
                                    str(tmp_path / 'x.h5'))
    with pytest.raises(ValueError, match='export') as jax_err:
        jk.save_keras_h5_variables(jb7, variables, str(tmp_path / 'y.h5'))
    assert str(port_err.value) == str(jax_err.value)


def test_import_refuses_a_mismatched_checkpoint(weights, tmp_path):
    """A vad v1 file does not load into v7 or the se cascade: JAX's
    errors, not a mis-mapping; nor does a file without Keras'
    layer_names, nor a classic (reset_after=False) GRU."""
    jb1, _, variables = weights('vad_v1')
    path = str(tmp_path / 'v1.h5')
    jk.save_keras_h5_variables(jb1, variables, path)
    _, pb7, _ = weights('vad_v7')
    with pytest.raises(ValueError, match='ran out|unconsumed|mismatch'):
        pk.load_keras_h5_state_dict(pb7, path)
    _, pse, _ = weights('se_pretrain_False')
    with pytest.raises((ValueError, NotImplementedError)):
        pk.load_keras_h5_state_dict(pse, path)
    bare = str(tmp_path / 'bare.h5')
    with h5py.File(bare, 'w') as f:
        f.create_dataset('w', data=np.zeros(3))
    with pytest.raises(ValueError, match='no layer_names'):
        pk.read_keras_h5(bare)
    jb6, pb6, v6 = weights('eff_v6')
    gru = str(tmp_path / 'gru.h5')
    jk.save_keras_h5_variables(jb6, v6, gru)
    with h5py.File(gru, 'r+') as f:
        g = f['bidirectional']
        for d in ('forward_gru', 'backward_gru'):
            wn = f'bidirectional/{d}/gru_cell/bias:0'
            row = np.asarray(g[wn])[0]
            del g[wn]
            g.create_dataset(wn, data=row)
    with pytest.raises(NotImplementedError, match='reset_after=False'):
        pk.load_keras_h5_state_dict(pb6, gru)
