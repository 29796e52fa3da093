"""flax variables -> the port's ``state_dict`` (VAD and se families).

Takes the JAX package's variables as nested mappings of numpy arrays
(``{'params': ..., 'batch_stats': ...}``, e.g. after ``jax.device_get``)
and imports neither JAX nor ``challenge_tpu``. Conv kernels go from HWIO to
OIHW, Dense kernels from [in, out] to [out, in]; BatchNorm scale/bias/mean/
var become weight/bias/running_mean/running_var. A ConvTranspose kernel
[kh, kw, in, out] becomes [in, out, kh, kw] flipped in both spatial dims:
flax (``transpose_kernel=False``) applies it unflipped, torch's
``ConvTranspose2d`` flipped. The se cascade's ``se/...`` and ``vad/...``
subtrees map to its ``se.`` and ``vad.`` submodules, the second by the
VAD rules. vad v7's top-level ``Conv_k`` and ``BatchNorm_k`` are its
bottlenecks' layers in threes (bottleneck k // 3, layer k % 3). The v9
BiLSTM's cells keep flax's per-gate leaves (``ii``..``io`` kernels,
``hi``..``ho`` kernels and biases), so each maps to one Linear of the
port's ``LSTM``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_BN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
       'var': 'running_var'}
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
    (r'Dense_0/(kernel|bias)', 'td'),
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


def _torch_entry(path: str, leaf: str, arr: np.ndarray):
    prefix = ''
    if path.startswith('vad/'):                 # the se cascade's head
        prefix, path = 'vad.', path[len('vad/'):]
    for pattern, target in _RULES:
        m = re.fullmatch(pattern, path)
        if m is None:
            continue
        module = prefix + (target(*m.groups()) if callable(target)
                           else target.format(*m.groups()))
        if leaf == 'kernel' and 'ConvTranspose' in path:
            return f'{module}.weight', arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if leaf == 'kernel':
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            return f'{module}.weight', arr
        if '.bn' in module:
            return f'{module}.{_BN[leaf]}', arr
        return f'{module}.{leaf}', arr
    raise KeyError(f'no port counterpart for flax variable '
                   f'{prefix.replace(".", "/") + path!r}')


def flax_to_state_dict(variables: Mapping) -> dict:
    """Every leaf of ``variables`` as a ``state_dict`` entry (float32 CPU
    tensors). Collections ('params', 'batch_stats') are optional, so an
    optimizer moment tree passed as ``{'params': tree}`` maps too."""
    out = {}
    for collection in ('params', 'batch_stats'):
        for path, arr in _leaves(variables.get(collection, {})):
            key, arr = _torch_entry('/'.join(path), path[-1], arr)
            out[key] = torch.from_numpy(
                np.array(arr, dtype=np.float32, order='C'))
    return out
