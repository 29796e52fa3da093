"""flax variables -> the port's ``state_dict`` (vad, se and eff families).

Takes the JAX package's variables as nested mappings of numpy arrays
(``{'params': ..., 'batch_stats': ...}``, e.g. after ``jax.device_get``)
and imports neither JAX nor ``challenge_tpu``. Conv kernels go from HWIO to
OIHW (a 1-D one from [k, in, out] to [out, in, k]), Dense kernels from
[in, out] to [out, in]; BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var. A ConvTranspose kernel
[*window, in, out] becomes [in, out, *window] flipped along the window:
flax (``transpose_kernel=False``) applies it unflipped, torch's
``ConvTranspose`` flipped. The se cascade's ``se/...`` and ``vad/...``
subtrees map to its ``se.`` and ``vad.`` submodules, the second by the
VAD rules. vad v7's top-level ``Conv_k`` and ``BatchNorm_k`` are its
bottlenecks' layers in threes (bottleneck k // 3, layer k % 3). The v9
BiLSTM's and the eff heads' BiGRU's cells keep flax's per-gate leaves, so
each maps to one Linear of the port's ``LSTM`` or ``GRU``.

The eff family's top-level names collide with vad's (its v7 ``Conv_0`` is
the gate conv, its ``Dense_0`` the first Dense of the head), so it has
rules of its own, chosen by the presence of ``EfficientNetBackbone_0``.
Its ``TimeAxisResample`` kernel [T, target] keeps its layout.

``state_dict_to_flax`` is the inverse: a ``state_dict`` back to the flax
names and layouts, every leaf flax has (the Keras writer of
``interop.keras_h5`` asserts that it maps each one).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_BN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
       'var': 'running_var'}
_GRU_RULE = (r'BiGRU_0/GRUCell_(\d)/([ih][rzn])/(kernel|bias)',
             'gru.cells.{0}.gates.{1}')
_RULES = [
    (r'se/ConvSet_(\d+)/Conv_(\d+)/kernel', 'se.convsets.{0}.convs.{1}'),
    (r'se/ConvSet_(\d+)/BatchNorm_(\d+)/BatchNorm_0/(\w+)',
     'se.convsets.{0}.bns.{1}'),
    (r'se/Upsampling_(\d+)/Conv_0/kernel', 'se.ups.{0}.conv'),
    (r'se/Upsampling_(\d+)/BatchNorm_0/BatchNorm_0/(\w+)', 'se.ups.{0}.bn'),
    (r'se/Upsampling_(\d+)/ConvTranspose_0/(kernel|bias)', 'se.ups.{0}.up'),
    (r'ConvMPBlock_(\d+)/Conv_(\d+)/(kernel|bias)', 'blocks.{0}.convs.{1}'),
    (r'ConvMPBlock_(\d+)/BatchNorm_(\d+)/BatchNorm_0/(\w+)',
     'blocks.{0}.bns.{1}'),
    (r'Conv_(\d+)/kernel',
     lambda k: f'bottlenecks.{int(k) // 3}.convs.{int(k) % 3}'),
    (r'BatchNorm_(\d+)/BatchNorm_0/(\w+)',
     lambda k, _: f'bottlenecks.{int(k) // 3}.bns.{int(k) % 3}'),
    (r'BiLSTM_0/OptimizedLSTMCell_(\d)/([ih][ifgo])/(kernel|bias)',
     'lstm.cells.{0}.gates.{1}'),
    _GRU_RULE,
    (r'Dense_0/(kernel|bias)', 'td'),
    (r'FullyConnectedLayer_(\d+)/Dense_0/(kernel|bias)', 'fcs.{0}.dense'),
    (r'FullyConnectedLayer_(\d+)/BatchNorm_0/BatchNorm_0/(\w+)',
     'fcs.{0}.bn'),
]
_EFF_RULES = [
    (r'EfficientNetBackbone_0/Conv_0/kernel', 'backbone.stem'),
    (r'EfficientNetBackbone_0/BatchNorm_0/BatchNorm_0/(\w+)',
     'backbone.stem_bn'),
    (r'EfficientNetBackbone_0/Conv_1/kernel', 'backbone.head'),
    (r'EfficientNetBackbone_0/BatchNorm_1/BatchNorm_0/(\w+)',
     'backbone.head_bn'),
    (r'EfficientNetBackbone_0/MBConv_(\d+)/Conv_(\d+)/(kernel|bias)',
     'backbone.blocks.{0}.convs.{1}'),
    (r'EfficientNetBackbone_0/MBConv_(\d+)/BatchNorm_(\d+)/BatchNorm_0/'
     r'(\w+)', 'backbone.blocks.{0}.bns.{1}'),
    (r'Dense_(\d+)/(kernel|bias)', 'denses.{0}'),
    (r'BatchNorm_(\d+)/BatchNorm_0/(\w+)', 'bns.{0}'),
    (r'ConvTranspose_(\d+)/(kernel|bias)', 'ups.{0}'),
    (r'TimeAxisResample_0/kernel', 'resample'),
    _GRU_RULE,
    (r'Conv_0/(kernel|bias)', 'gate'),
    (r'FullyConnectedLayer_(\d+)/Dense_0/(kernel|bias)', 'fcs.{0}.dense'),
    (r'FullyConnectedLayer_(\d+)/BatchNorm_0/BatchNorm_0/(\w+)',
     'fcs.{0}.bn'),
]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _torch_entry(path: str, leaf: str, arr: np.ndarray, rules):
    prefix = ''
    if path.startswith('vad/'):                 # the se cascade's head
        prefix, path = 'vad.', path[len('vad/'):]
    for pattern, target in rules:
        m = re.fullmatch(pattern, path)
        if m is None:
            continue
        module = prefix + (target(*m.groups()) if callable(target)
                           else target.format(*m.groups()))
        if leaf == 'kernel':
            nd, window = arr.ndim, tuple(range(arr.ndim - 2))
            if 'ConvTranspose' in path:      # [in, out, *window], flipped
                arr = np.flip(arr, window).transpose(nd - 2, nd - 1, *window)
            elif 'TimeAxisResample' not in path:
                # [*window, in, out] -> [out, in, *window]; Dense [out, in]
                arr = arr.transpose(nd - 1, nd - 2, *window)
            return f'{module}.weight', arr
        if 'BatchNorm' in path:
            return f'{module}.{_BN[leaf]}', arr
        return f'{module}.{leaf}', arr
    raise KeyError(f'no port counterpart for flax variable '
                   f'{prefix.replace(".", "/") + path!r}')


def flax_to_state_dict(variables: Mapping) -> dict:
    """Every leaf of ``variables`` as a ``state_dict`` entry (float32 CPU
    tensors). Collections ('params', 'batch_stats') are optional, so an
    optimizer moment tree passed as ``{'params': tree}`` maps too. A tree
    with ``EfficientNetBackbone_0`` maps by the eff family's rules."""
    trees = [variables.get(c, {}) for c in ('params', 'batch_stats')]
    eff = any('EfficientNetBackbone_0' in t for t in trees)
    rules = _EFF_RULES if eff else _RULES
    out = {}
    for tree in trees:
        for path, arr in _leaves(tree):
            key, arr = _torch_entry('/'.join(path), path[-1], arr, rules)
            out[key] = torch.from_numpy(
                np.array(arr, dtype=np.float32, order='C'))
    return out


# the inverse rules: the port's module path -> flax's module path
_INV_RULES = [
    (r'se\.convsets\.(\d+)\.convs\.(\d+)', 'se/ConvSet_{0}/Conv_{1}'),
    (r'se\.convsets\.(\d+)\.bns\.(\d+)',
     'se/ConvSet_{0}/BatchNorm_{1}/BatchNorm_0'),
    (r'se\.ups\.(\d+)\.conv', 'se/Upsampling_{0}/Conv_0'),
    (r'se\.ups\.(\d+)\.bn', 'se/Upsampling_{0}/BatchNorm_0/BatchNorm_0'),
    (r'se\.ups\.(\d+)\.up', 'se/Upsampling_{0}/ConvTranspose_0'),
    (r'blocks\.(\d+)\.convs\.(\d+)', 'ConvMPBlock_{0}/Conv_{1}'),
    (r'blocks\.(\d+)\.bns\.(\d+)',
     'ConvMPBlock_{0}/BatchNorm_{1}/BatchNorm_0'),
    (r'bottlenecks\.(\d+)\.convs\.(\d+)',
     lambda b, j: f'Conv_{3 * int(b) + int(j)}'),
    (r'bottlenecks\.(\d+)\.bns\.(\d+)',
     lambda b, j: f'BatchNorm_{3 * int(b) + int(j)}/BatchNorm_0'),
    (r'lstm\.cells\.(\d)\.gates\.(\w+)', 'BiLSTM_0/OptimizedLSTMCell_{0}/{1}'),
    (r'gru\.cells\.(\d)\.gates\.(\w+)', 'BiGRU_0/GRUCell_{0}/{1}'),
    (r'td', 'Dense_0'),
    (r'fcs\.(\d+)\.dense', 'FullyConnectedLayer_{0}/Dense_0'),
    (r'fcs\.(\d+)\.bn', 'FullyConnectedLayer_{0}/BatchNorm_0/BatchNorm_0'),
]
_INV_EFF_RULES = [
    (r'backbone\.stem', 'EfficientNetBackbone_0/Conv_0'),
    (r'backbone\.stem_bn', 'EfficientNetBackbone_0/BatchNorm_0/BatchNorm_0'),
    (r'backbone\.head', 'EfficientNetBackbone_0/Conv_1'),
    (r'backbone\.head_bn', 'EfficientNetBackbone_0/BatchNorm_1/BatchNorm_0'),
    (r'backbone\.blocks\.(\d+)\.convs\.(\d+)',
     'EfficientNetBackbone_0/MBConv_{0}/Conv_{1}'),
    (r'backbone\.blocks\.(\d+)\.bns\.(\d+)',
     'EfficientNetBackbone_0/MBConv_{0}/BatchNorm_{1}/BatchNorm_0'),
    (r'denses\.(\d+)', 'Dense_{0}'),
    (r'bns\.(\d+)', 'BatchNorm_{0}/BatchNorm_0'),
    (r'ups\.(\d+)', 'ConvTranspose_{0}'),
    (r'resample', 'TimeAxisResample_0'),
    (r'gru\.cells\.(\d)\.gates\.(\w+)', 'BiGRU_0/GRUCell_{0}/{1}'),
    (r'gate', 'Conv_0'),
    (r'fcs\.(\d+)\.dense', 'FullyConnectedLayer_{0}/Dense_0'),
    (r'fcs\.(\d+)\.bn', 'FullyConnectedLayer_{0}/BatchNorm_0/BatchNorm_0'),
]
_INV_BN = {v: k for k, v in _BN.items()}


def _flax_entry(key: str, arr: np.ndarray, rules):
    """(collection, flax path, array in flax's layout) of one ``state_dict``
    entry: the inverse of :func:`_torch_entry`."""
    module, _, leaf = key.rpartition('.')
    prefix = ''
    if module.startswith('vad.'):               # the se cascade's head
        prefix, module = 'vad/', module[len('vad.'):]
    for pattern, target in rules:
        m = re.fullmatch(pattern, module)
        if m is None:
            continue
        path = prefix + (target(*m.groups()) if callable(target)
                         else target.format(*m.groups()))
        if 'BatchNorm' in path:
            name = _INV_BN[leaf]
            return ('batch_stats' if name in ('mean', 'var') else 'params',
                    f'{path}/{name}', arr)
        if leaf == 'weight':
            nd = arr.ndim
            window = tuple(range(2, nd))
            if 'ConvTranspose' in path:      # [in, out, *window], flipped
                arr = np.flip(arr.transpose(*window, 0, 1),
                              tuple(range(nd - 2)))
            elif 'TimeAxisResample' not in path:
                arr = arr.transpose(*window, 1, 0)
            return 'params', f'{path}/kernel', arr
        return 'params', f'{path}/{leaf}', arr
    raise KeyError(f'no flax counterpart for state_dict entry {key!r}')


def flax_shapes(module, config) -> dict:
    """Each flax leaf's shape, by its 'collection/A/B/leaf' path, for
    ``module``'s ``state_dict`` (no weight leaves the device)."""
    rules = _INV_EFF_RULES if config.model_type == 'eff' else _INV_RULES
    out = {}
    for key, value in module.state_dict().items():
        # an untouched np.empty: only the views' shapes are read
        coll, path, arr = _flax_entry(
            key, np.empty(tuple(value.shape), np.float32), rules)
        out[f'{coll}/{path}'] = arr.shape
    return out


def state_dict_to_flax(module_or_state_dict, config) -> dict:
    """The flax variables ``{'params': ..., 'batch_stats': ...}`` (nested
    dicts of float32 numpy arrays) that :func:`flax_to_state_dict` maps to
    ``module_or_state_dict`` (an ``nn.Module`` or its ``state_dict``), by
    the rules of ``config.model_type``'s family."""
    sd = module_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    rules = _INV_EFF_RULES if config.model_type == 'eff' else _INV_RULES
    out = {'params': {}, 'batch_stats': {}}
    for key, value in sd.items():
        arr = value.detach().cpu().float().numpy()
        coll, path, arr = _flax_entry(key, arr, rules)
        node = out[coll]
        *parents, leaf = path.split('/')
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr, dtype=np.float32)
    return out
