"""Keras-2 legacy HDF5 weight files in both directions (counterpart:
``challenge_tpu/interop/keras_h5.py``, a copy with numpy in place of
``jax.numpy``; reference: eval.py:63-65, get_csv_data.py:80-102).

The reference saves and loads its ``{run}.h5`` / ``_SWA.h5`` /
``_sample.h5`` trios with Keras' ``model.save_weights``. This module
reads that format with h5py into the flax-named variables tree of the JAX
package, and writes it from one, by the same plans, names and rules as
JAX, so that the port's file of a model is the JAX package's file of the
same weights: the same ``layer_names``, the same ``weight_names`` in the
same order, the same array bytes. The port's entries
:func:`load_keras_h5_state_dict` and :func:`save_keras_h5_state_dict`
bridge that tree to and from a ``state_dict`` through
``interop.jax_weights``.

Mapping rules (JAX's):

* Keras Conv2D kernels [kh, kw, in, out] and Dense kernels [in, out] are
  flax's. Keras Conv2DTranspose kernels are [kh, kw, OUT, IN] and
  spatially mirrored against flax's.
* Keras BatchNormalization [gamma, beta, moving_mean, moving_var] map to
  flax params {scale, bias} and batch_stats {mean, var}.
* the reference's conv/dense BIAS before a BatchNorm is dropped (the
  models are bias-free there) and folded into the BN's moving mean,
  ``mean_ours = moving_mean - bias``, which gives the same normalized
  output. The writer exports a zero bias there.
* Keras LSTM gates [i, f, c, o] split into flax's ii/if/ig/io and
  hi/hf/hg/ho denses; Keras GRU (``reset_after=True``) biases [2, 3u]
  combine for z and r and split for n.
* unsupported layouts raise with a clear message instead of mis-mapping.

h5py is imported inside the functions that read or write a file, never
when the package is imported.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import List, Tuple

import numpy as np


def _flat(tree, prefix: str = '') -> dict:
    """A nested mapping's leaves by their 'A/B/C' path."""
    out = {}
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if isinstance(v, Mapping):
            out.update(_flat(v, key + '/'))
        else:
            out[key] = np.asarray(v)
    return out


# --------------------------------------------------------------- h5 parsing
def read_keras_h5(path: str) -> List[Tuple[str, List[Tuple[str, np.ndarray]]]]:
    """Read a Keras-2 legacy HDF5 weight file into an ordered list of
    (layer_name, [(weight_name, array), ...]) for layers that have
    weights. A nested Model layer appears as one group with all its
    weights flattened (in the graph's topological order — NOT creation
    order; see _sublayer_units)."""
    import h5py

    with h5py.File(path, 'r') as f:
        root = f['model_weights'] if 'model_weights' in f else f
        if 'layer_names' not in root.attrs:
            raise ValueError(
                f'{path!r} is not a Keras legacy HDF5 weight file '
                '(no layer_names attribute)')
        layers = []
        for lname in root.attrs['layer_names']:
            lname = lname.decode() if isinstance(lname, bytes) else str(lname)
            g = root[lname]
            wnames = [n.decode() if isinstance(n, bytes) else str(n)
                      for n in g.attrs.get('weight_names', [])]
            if not wnames:
                continue
            layers.append(
                (lname, [(n, np.asarray(g[n])) for n in wnames]))
    return layers


def export_keras_legacy_h5(model, path: str) -> None:
    """Write a Keras model's weights in the Keras-2 legacy HDF5 layout
    (root attrs ``layer_names``, per-layer attrs ``weight_names`` carrying
    the real sublayer paths), the format reference-era checkpoints are in
    (counterpart: ``export_keras_legacy_h5``, keras_h5.py:73). Duck-typed:
    ``model.layers``, each with ``.name`` and ``.weights``, each weight
    array-like with a ``path`` or ``name``. Nested Model layers flatten
    into one group, as Keras 2 did."""
    import h5py

    with h5py.File(path, 'w') as f:
        names = []
        for layer in model.layers:
            weights = layer.weights
            if not weights:
                continue
            names.append(layer.name)
            g = f.create_group(layer.name)
            wnames = []
            for i, w in enumerate(weights):
                wn = getattr(w, 'path', None) or getattr(w, 'name', None) \
                    or f'{layer.name}/weight_{i}'
                if not wn.endswith(':0'):
                    wn = wn + ':0'
                g.create_dataset(wn, data=np.asarray(w))
                wnames.append(wn.encode())
            g.attrs['weight_names'] = wnames
        f.attrs['layer_names'] = [n.encode() for n in names]


# ------------------------------------------------------------- unit plans
def _vad_unit_plan(v: int, vad_variant: bool = True,
                   prefix: str = '') -> List[Tuple[str, str]]:
    """Ordered (kind, flax_prefix) units mirroring VADModel.__call__
    (models/vad.py) == the reference's define_keras_model layer order.
    With ``vad_variant=False`` (the 'se' cascade head) every version
    switch is inert (reference keys them off model_type == 'vad').
    kind: 'conv_bn' | 'dense' | 'dense_bn' | 'convT' | 'bilstm'."""
    units: List[Tuple[str, str]] = []
    for j in range(2):
        units.append(('conv_bn', f'{prefix}ConvMPBlock_0/Conv_{j}'))
    top = 0
    for i in range(1, 5):
        if vad_variant and v == 7:
            for _ in range(3):
                units.append(('conv_bn', f'{prefix}Conv_{top}'))
                top += 1
        for j in range(3):
            units.append(('conv_bn', f'{prefix}ConvMPBlock_{i}/Conv_{j}'))
    units.append(('dense', f'{prefix}Dense_0'))     # TimeDistributed Dense
    fc = 0
    v9 = vad_variant and v == 9
    for _nodes in ((512, 256, 128) if v9 else (256, 128)):
        units.append(
            ('dense_bn', f'{prefix}FullyConnectedLayer_{fc}/Dense_0'))
        fc += 1
    if v9:
        units.append(('bilstm', f'{prefix}BiLSTM_0'))
    units.append(('dense_bn', f'{prefix}FullyConnectedLayer_{fc}/Dense_0'))
    fc += 1
    units.append(('dense', f'{prefix}FullyConnectedLayer_{fc}/Dense_0'))
    return units


def _se_unit_plan(v: int) -> List[Tuple[str, str]]:
    """The 'se' composite (reference: sj_train.py:258-339): U-Net encoder
    (4 convsets), speech decoder (4 upsamplings), noise decoder (4), then
    the cascade's inner VAD head. Mirrors SECascade.__call__
    (models/senet.py)."""
    units: List[Tuple[str, str]] = []
    for i in range(4):
        for j in range(2):
            units.append(('conv_bn', f'se/ConvSet_{i}/Conv_{j}'))
    for d in range(8):      # Upsampling_0..3 speech, _4..7 noise
        units.append(('conv_bn', f'se/Upsampling_{d}/Conv_0'))
        units.append(('convT', f'se/Upsampling_{d}/ConvTranspose_0'))
    units.extend(_vad_unit_plan(v, vad_variant=False, prefix='vad/'))
    return units


def _eff_unit_plan(model: int, v: int, n_layers: int,
                   n_frame: int = 512):
    """The EfficientNet-SED family (reference: sj_train.py:340-401 over
    keras.applications EfficientNetB{model} with weights=None). Mirrors
    EffNetSED.__call__ (models/effnet.py). Emits (kind, core, bn) triples
    — MBConv's conv and BN auto-indices don't align (SE convs have no BN),
    so the BN path is explicit.

    The v5/6/7 BiGRU heads map exactly: Keras GRU (reset_after=True,
    the TF2 default) computes n = tanh(x W + b_in + r * (h R + b_rn)) —
    precisely flax GRUCell's candidate — so gates reorder (Keras z,r,h ->
    flax iz/ir/in) and the input/recurrent bias rows combine (see
    _put_gru).
    """
    from challenge_tpu_torch.models.effnet import (
        BLOCK_ARGS, SCALING, round_repeats)

    units = []
    B = 'EfficientNetBackbone_0'
    # stem: fold the Rescaling(1/255) [+ un-adapted Normalization] affine
    # into the conv kernel / BN mean (kind 'stem_bn' consumes a 'norm'
    # queue entry when the file has one)
    units.append(('stem_bn', f'{B}/Conv_0', f'{B}/BatchNorm_0/BatchNorm_0'))
    _, depth = SCALING[model]
    b = 0
    for _kernel, repeats, _f_in, _f_out, expand, _strides in BLOCK_ARGS:
        for j in range(round_repeats(repeats, depth)):
            p = f'{B}/MBConv_{b}'
            ci = bi = 0
            if expand != 1:
                units.append(('conv_bn', f'{p}/Conv_{ci}',
                              f'{p}/BatchNorm_{bi}/BatchNorm_0'))
                ci += 1
                bi += 1
            units.append(('dwconv_bn', f'{p}/Conv_{ci}',
                          f'{p}/BatchNorm_{bi}/BatchNorm_0'))
            ci += 1
            bi += 1
            units.append(('conv_bias', f'{p}/Conv_{ci}', None))  # se reduce
            ci += 1
            units.append(('conv_bias', f'{p}/Conv_{ci}', None))  # se expand
            ci += 1
            units.append(('conv_bn', f'{p}/Conv_{ci}',
                          f'{p}/BatchNorm_{bi}/BatchNorm_0'))    # project
            b += 1
    units.append(('conv_bn', f'{B}/Conv_1',
                  f'{B}/BatchNorm_1/BatchNorm_0'))               # top
    d = 0
    bn_i = 0
    for _ in range(n_layers):    # gated Dense stack (sj_train.py:347-350)
        units.append(('dense_bias_bn', f'Dense_{d}',
                      f'BatchNorm_{bn_i}/BatchNorm_0'))
        d += 1
        bn_i += 1
    if v == 1:                   # Conv1DTranspose decoder (sj_train:353-363)
        for t in range(5):
            units.append(('convT1', f'ConvTranspose_{t}', None))
    elif v == 5:                 # time resample + BiGRU (sj_train:377-382)
        t_back = n_frame
        for _ in range(5):
            t_back = -(-t_back // 2)
        if t_back != n_frame * 256 // 16000:
            units.append(('timeconv', 'TimeAxisResample_0', None))
            units.append(('bare_bn', None,
                          f'BatchNorm_{bn_i}/BatchNorm_0'))
            bn_i += 1
        units.append(('bigru', 'BiGRU_0', None))
    elif v == 6:                 # BiGRU + FC stack (sj_train:383-387)
        units.append(('bigru', 'BiGRU_0', None))
        for k in range(3):       # 256 / 128 / 64
            units.append(
                ('dense_bn', f'FullyConnectedLayer_{k}/Dense_0', None))
    elif v == 7:                 # BiGRU gated by tanh conv (sj_train:388-393)
        units.append(('bigru', 'BiGRU_0', None))
        units.append(('conv1d', 'Conv_0', None))
    units.append(('dense', f'Dense_{d}', None))
    return units


def _bn_prefix(core_prefix: str) -> str:
    """Flax path of the BatchNorm following a conv/dense at core_prefix:
    same parent module, same index, BatchNorm_<j>/BatchNorm_0."""
    parent, _, leaf = core_prefix.rpartition('/')
    idx = leaf.rsplit('_', 1)[1]
    bn = f'BatchNorm_{idx}/BatchNorm_0'
    return f'{parent}/{bn}' if parent else bn


# ---------------------------------------------------------------- importer
def _sublayer_units(path, layers):
    """Group the file's weights into per-(sub)layer units and recover
    CREATION order per kind.

    Keras functional models store layers (and a nested Model's flattened
    weights) in graph-topological order, which interleaves parallel
    branches (e.g. the 'se' U-Net's twin decoders). Creation order — which
    is what the unit plans mirror, since it follows the reference's source
    order — is recoverable from the auto-generated layer names
    ('conv2d_7', 'batch_normalization_12', ...): Keras numbers each layer
    class by instantiation order. So: bucket weights per layer id (the
    second-to-last weight-path component), classify each layer's kind by
    its arrays' shapes, and order within each kind by the parsed name
    index (falling back to file order if indices are missing/duplicated).

    Returns {kind: [ (layer_id, [arrays]) ... ]} with kinds
    'conv' | 'convT' | 'dense' | 'bn'.
    """
    per_layer: dict = {}
    order: list = []
    for lname, pairs in layers:
        for wname, arr in pairs:
            parts = wname.rstrip(':0123456789').split('/')
            # the full path minus the weight leaf: a bare leaf id would
            # merge e.g. a Bidirectional wrapper's forward and backward
            # cells (both named 'lstm_cell' under Keras 3)
            lid = '/'.join(parts[:-1]) if len(parts) >= 2 else lname
            key = (lname, lid)
            if key not in per_layer:
                per_layer[key] = []
                order.append(key)
            per_layer[key].append(arr)

    def classify(lid, arrs):
        dims = [a.ndim for a in arrs]
        if dims == [4, 1]:
            if 'transpose' in lid:
                return 'convT'
            return 'conv'
        if dims == [4]:
            a = arrs[0]
            # DepthwiseConv2D kernels are [kh, kw, C, 1]
            if a.shape[-1] == 1 and a.shape[2] > 1:
                return 'dwconv'
            return 'conv'
        if dims == [3, 1]:
            # Conv1DTranspose kernels are [k, out, in]; plain Conv1D
            # kernels [k, in, out] — names disambiguate
            return 'convT1' if 'transpose' in lid else 'conv1d'
        if dims == [3]:
            return 'timeconv'        # bias-free Conv1D (sj_train v5 head)
        if dims == [2, 1]:
            return 'dense'
        if dims == [2, 2, 1] or dims == [2, 2, 2]:
            # recurrent cell [kernel, recurrent_kernel, bias]: LSTMs pack
            # 4 gates, GRUs 3 (reset_after biases are [2, 3u])
            u = arrs[1].shape[0]
            if arrs[1].shape[1] == 4 * u:
                return 'lstm'
            if arrs[1].shape[1] == 3 * u:
                return 'gru'
        if len(arrs) == 4 and all(d == 1 for d in dims):
            return 'bn'
        if dims == [1, 1, 0]:
            return 'norm'            # keras Normalization [mean, var, count]
        raise NotImplementedError(
            f'{path!r}: unsupported Keras layer {lid!r} with weight shapes '
            f'{[a.shape for a in arrs]} (recurrent/custom layers are not '
            'importable)')

    def name_index(lid):
        tail = lid.rsplit('/', 1)[-1].rsplit('_', 1)
        if len(tail) == 2 and tail[1].isdigit():
            return int(tail[1])
        return 0

    kinds: dict = {'conv': [], 'convT': [], 'dense': [], 'bn': [],
                   'dwconv': [], 'convT1': [], 'norm': [], 'conv1d': [],
                   'timeconv': [], 'lstm': [], 'gru': []}
    for key in order:
        lname, lid = key
        kinds[classify(lid, per_layer[key])].append((lid, per_layer[key]))
    for kind, items in kinds.items():
        idxs = [name_index(lid) for lid, _ in items]
        if len(set(idxs)) == len(idxs):     # well-defined creation order
            items.sort(key=lambda it: name_index(it[0]))
    return kinds


class _KindQueues:
    """Plan-driven consumer: each plan unit pops the next layer of the
    kind it needs."""

    def __init__(self, path, layers):
        self.path = path
        self.kinds = _sublayer_units(path, layers)
        self.pos = {k: 0 for k in self.kinds}

    def take(self, kind: str, unit: str):
        items = self.kinds[kind]
        i = self.pos[kind]
        if i >= len(items):
            raise ValueError(
                f'{self.path!r}: ran out of {kind} layers at unit '
                f'{unit!r} — wrong model family/version for this file?')
        self.pos[kind] = i + 1
        return items[i]

    def done(self):
        leftover = {k: len(v) - self.pos[k]
                    for k, v in self.kinds.items() if len(v) > self.pos[k]}
        if leftover:
            raise ValueError(
                f'{self.path!r}: unconsumed weight layers {leftover} — '
                'wrong model family/version for this file?')


def _family_plan(bundle):
    """The (kind, flax_prefix[, bn]) unit plan for a ModelBundle's family —
    shared by the importer and the exporter so both walk the same layer
    sequence."""
    config = bundle.config
    if config.model_type == 'vad':
        return _vad_unit_plan(config.v, vad_variant=True)
    if config.model_type == 'se':
        return _se_unit_plan(config.v)
    if config.model_type == 'eff':
        # trainer.py's density variant names the backbone as a string
        # ('EfficientNetB4') and its head has no version switches (v=0
        # plan: backbone + gated stack + plain Dense)
        from challenge_tpu_torch.models.registry import parse_model_id
        model_id = parse_model_id(config.model)
        v = 0 if getattr(bundle.module, 'density', False) else config.v
        return _eff_unit_plan(model_id, v,
                              getattr(config, 'n_layers', 0),
                              n_frame=config.n_frame)
    raise NotImplementedError(
        'Keras .h5 interop supports the vad, se and eff families '
        f'(got model_type={config.model_type!r})')


def load_keras_h5_variables(bundle, path: str):
    """Read a reference Keras .h5 checkpoint and return flax ``variables``
    ({'params', 'batch_stats'}) for ``bundle`` (a ModelBundle). Shapes are
    validated leaf-by-leaf against the module's own initialization."""
    plan = _family_plan(bundle)
    queues = _KindQueues(path, read_keras_h5(path))

    params: dict = {}
    stats: dict = {}

    def put(tree, prefix, leaf, value):
        node = tree
        for part in prefix.split('/'):
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value, np.float32)

    def put_bn(bnp, gamma, beta, mmean, mvar):
        put(params, bnp, 'scale', gamma)
        put(params, bnp, 'bias', beta)
        put(stats, bnp, 'mean', mmean)
        put(stats, bnp, 'var', mvar)

    def put_lstm(cell, kernel, recurrent, bias):
        """Keras LSTM gates are [i, f, c, o] column blocks; flax
        OptimizedLSTMCell uses separate denses (ii..io / hi..ho, flax 'g'
        == keras 'c') with the bias on the recurrent dense."""
        u = recurrent.shape[0]
        for gi, g in enumerate(('i', 'f', 'g', 'o')):
            sl = slice(gi * u, (gi + 1) * u)
            put(params, f'{cell}/i{g}', 'kernel', kernel[:, sl])
            put(params, f'{cell}/h{g}', 'kernel', recurrent[:, sl])
            put(params, f'{cell}/h{g}', 'bias', bias[sl])

    def put_gru(cell, kernel, recurrent, bias):
        """Keras GRU gates are [z, r, h] column blocks; flax GRUCell's
        candidate n = tanh(xW + b_in + r*(hR + b_hn)) IS Keras
        reset_after=True, so input/recurrent bias rows combine for r/z
        (whose recurrent denses are bias-free in flax) and split for n."""
        u = recurrent.shape[0]
        if bias.ndim != 2:
            # reset_after=False computes the candidate as (r*h) @ R —
            # structurally different from flax's r * (h @ R); refuse
            # rather than import wrong recurrent semantics
            raise NotImplementedError(
                'classic (reset_after=False) Keras GRUs are not '
                'importable: their candidate gate applies the reset '
                'before the recurrent matmul')
        b_in, b_rec = bias[0], bias[1]
        for g, gi in (('z', 0), ('r', 1), ('n', 2)):
            sl = slice(gi * u, (gi + 1) * u)
            put(params, f'{cell}/i{g}', 'kernel', kernel[:, sl])
            put(params, f'{cell}/h{g}', 'kernel', recurrent[:, sl])
        put(params, f'{cell}/iz', 'bias', b_in[0:u] + b_rec[0:u])
        put(params, f'{cell}/ir', 'bias', b_in[u:2 * u] + b_rec[u:2 * u])
        put(params, f'{cell}/in', 'bias', b_in[2 * u:])
        put(params, f'{cell}/hn', 'bias', b_rec[2 * u:])

    for entry in plan:
        kind, prefix = entry[0], entry[1]
        bnp = entry[2] if len(entry) == 3 and entry[2] is not None \
            else (_bn_prefix(prefix) if prefix else None)
        if kind == 'dense':
            _, (kernel, bias) = queues.take('dense', prefix)
            put(params, prefix, 'kernel', kernel)
            put(params, prefix, 'bias', bias)
        elif kind == 'convT':
            # Keras Conv2DTranspose kernels are [kh, kw, out, in] AND
            # spatially mirrored relative to lax.conv_transpose (Keras
            # computes the gradient-of-conv, which flips the taps) — both
            # the axis swap and the spatial flip are required (verified
            # against Keras numerically; without the flip, outputs permute
            # within each stride block)
            _, (kernel, bias) = queues.take('convT', prefix)
            put(params, prefix, 'kernel',
                kernel.transpose(0, 1, 3, 2)[::-1, ::-1])
            put(params, prefix, 'bias', bias)
        elif kind == 'convT1':
            # Keras Conv1DTranspose kernels are [k, out, in], mirrored
            # (see convT)
            _, (kernel, bias) = queues.take('convT1', prefix)
            put(params, prefix, 'kernel', kernel.transpose(0, 2, 1)[::-1])
            put(params, prefix, 'bias', bias)
        elif kind == 'conv_bias':
            _, (kernel, bias) = queues.take('conv', prefix)
            put(params, prefix, 'kernel', kernel)
            put(params, prefix, 'bias', bias)
        elif kind == 'conv1d':
            # keras Conv1D kernels are [k, in, out] — same as flax
            _, (kernel, bias) = queues.take('conv1d', prefix)
            put(params, prefix, 'kernel', kernel)
            put(params, prefix, 'bias', bias)
        elif kind == 'timeconv':
            # Conv1D(target, 1, channels_first, no bias): kernel
            # [1, T, target] -> our TimeAxisResample matrix [T, target]
            _, (kernel,) = queues.take('timeconv', prefix)
            put(params, prefix, 'kernel', kernel[0])
        elif kind == 'bare_bn':
            _, bn = queues.take('bn', bnp)
            put_bn(bnp, *bn)
        elif kind == 'bilstm':
            for c, cell in enumerate(('OptimizedLSTMCell_0',
                                      'OptimizedLSTMCell_1')):
                _, arrays = queues.take('lstm', f'{prefix}[{c}]')
                put_lstm(f'{prefix}/{cell}', *arrays)
        elif kind == 'bigru':
            for c, cell in enumerate(('GRUCell_0', 'GRUCell_1')):
                _, arrays = queues.take('gru', f'{prefix}[{c}]')
                put_gru(f'{prefix}/{cell}', *arrays)
        elif kind == 'dwconv_bn':
            # DepthwiseConv2D [kh, kw, C, 1] -> flax grouped-conv
            # [kh, kw, 1, C]; no bias in the EfficientNet blocks
            _, core = queues.take('dwconv', prefix)
            put(params, prefix, 'kernel', core[0].transpose(0, 1, 3, 2))
            _, bn = queues.take('bn', prefix)
            put_bn(bnp, *bn)
        elif kind == 'dense_bias_bn':
            # our flax Dense here keeps its bias (no folding)
            _, (kernel, bias) = queues.take('dense', prefix)
            put(params, prefix, 'kernel', kernel)
            put(params, prefix, 'bias', bias)
            _, bn = queues.take('bn', prefix)
            put_bn(bnp, *bn)
        elif kind == 'stem_bn':
            # fold the keras front affine (Rescaling 1/255 + un/adapted
            # Normalization) into the stem conv kernel and BN moving mean:
            # conv(W, a*x + b) = conv(W * a, x) + sum_hwi(W[...,i,:] b[i])
            _, core = queues.take('conv', prefix)
            kernel, cbias = core if len(core) == 2 else (core[0], None)
            if queues.kinds['norm']:
                _, (nmean, nvar, _count) = queues.take('norm', prefix)
                a_norm = 1.0 / np.maximum(np.sqrt(nvar), 1e-7)
                a = (1.0 / 255.0) * a_norm
                shift = -nmean * a_norm
            else:
                # no Normalization weights -> the checkpoint's graph fed
                # the stem raw (the reference's `efficientnet` package
                # does no in-model preprocessing). Refuse rather than
                # silently mis-scale if the file still carried a
                # weight-less Rescaling front layer (newer
                # keras.applications variants): its 1/255 cannot be
                # recovered from weights alone.
                import h5py
                with h5py.File(path, 'r') as f:
                    root = (f['model_weights']
                            if 'model_weights' in f else f)
                    names = [n.decode() if isinstance(n, bytes) else str(n)
                             for n in root.attrs.get('layer_names', [])]
                if any('rescaling' in n.lower() for n in names):
                    raise NotImplementedError(
                        f'{path!r}: stem has a Rescaling layer but no '
                        'Normalization weights — this Keras variant\'s '
                        'input scaling cannot be folded from the weight '
                        'file; import is refused instead of producing '
                        'mis-scaled activations')
                a = np.full((kernel.shape[2],), 1.0)
                shift = np.zeros((kernel.shape[2],))
            folded = kernel * a[None, None, :, None]
            const = np.einsum('hwio,i->o', kernel, shift)
            if cbias is not None:
                # a biased stem conv (not produced by keras.applications,
                # but legal Keras): the bias is one more pre-BN constant —
                # fold it into the BN moving mean like conv_bn does rather
                # than silently dropping it
                const = const + cbias
            put(params, prefix, 'kernel', folded)
            _, (gamma, beta, mmean, mvar) = queues.take('bn', prefix)
            put_bn(bnp, gamma, beta, mmean - const, mvar)
        else:   # conv_bn / dense_bn: pre-BN bias folds into BN mean (exact)
            core_kind = 'conv' if kind == 'conv_bn' else 'dense'
            _, core = queues.take(core_kind, prefix)
            kernel, bias = core if len(core) == 2 else (core[0], None)
            _, (gamma, beta, mmean, mvar) = queues.take('bn', prefix)
            put(params, prefix, 'kernel', kernel)
            put_bn(bnp, gamma, beta,
                   mmean if bias is None else mmean - bias, mvar)
    queues.done()

    variables = {'params': params, 'batch_stats': stats}

    # leaf-by-leaf shape validation against the module's own weights
    from challenge_tpu_torch.interop.jax_weights import flax_shapes
    template = flax_shapes(bundle.module, bundle.config)
    v_flat = _flat(variables)
    if len(v_flat) != len(template):
        raise ValueError(
            f'{path!r}: imported tree has {len(v_flat)} leaves, model '
            f'expects {len(template)}')
    for tpath, shape in template.items():
        if tpath not in v_flat:
            raise ValueError(f'{path!r}: missing imported leaf {tpath}')
        if v_flat[tpath].shape != shape:
            raise ValueError(
                f'{path!r}: shape mismatch at {tpath}: '
                f'{v_flat[tpath].shape} vs model {shape}')
    return variables


# ---------------------------------------------------------------- exporter
class _TreeReader:
    """Pop leaves out of a flax variables tree by 'A/B/C' path, tracking
    consumption so the exporter can prove it mapped every weight."""

    def __init__(self, variables):
        self.params = variables.get('params', variables)
        self.stats = variables.get('batch_stats', {})
        self.seen: set = set()

    def _get(self, tree, prefix, leaf, which):
        node = tree
        for part in prefix.split('/'):
            if part not in node:
                raise ValueError(
                    f'export: no {which} module {prefix!r} in the variables '
                    '(wrong model family/version for this tree?)')
            node = node[part]
        if leaf not in node:
            raise ValueError(
                f'export: module {prefix!r} has no {which} leaf {leaf!r}')
        self.seen.add((which, prefix, leaf))
        return np.asarray(node[leaf], np.float32)

    def p(self, prefix, leaf='kernel'):
        return self._get(self.params, prefix, leaf, 'params')

    def s(self, prefix, leaf):
        return self._get(self.stats, prefix, leaf, 'batch_stats')

    def assert_consumed(self):
        for which, tree in (('params', self.params),
                            ('batch_stats', self.stats)):
            for kpath in _flat(tree):
                prefix, _, leaf = kpath.rpartition('/')
                key = (which, prefix, leaf)
                if key not in self.seen:
                    raise ValueError(
                        f'export: variables leaf {key} was not mapped to '
                        'any Keras weight (wrong family/version plan?)')


class _Names:
    """Keras-style auto names (conv2d, conv2d_1, ...) so exported files
    look like native Keras saves and the importer's name-based
    disambiguation (the 'transpose' substring checks) round-trips."""

    def __init__(self):
        self.counts: dict = {}

    def __call__(self, base):
        i = self.counts.get(base, 0)
        self.counts[base] = i + 1
        return base if i == 0 else f'{base}_{i}'


def _export_unit_layers(kind, prefix, bnp, r: _TreeReader, name: _Names,
                        conv_bn_bias: bool = True):
    """Expand one plan unit into Keras leaf layers
    ``(name, trainable[(wname, arr)], non_trainable[(wname, arr)])`` —
    the exact inverse of the importer's mappings (bias-free pre-BN
    conv/dense slots export a zero bias where the Keras layer carries one;
    transposed/mirrored kernels map back; recurrent gates re-concatenate).
    ``conv_bn_bias=False`` for the EfficientNet backbone, whose Keras
    convs are themselves use_bias=False."""
    layers = []

    def bn_layer(bn_prefix):
        n = name('batch_normalization')
        return (n,
                [(f'{n}/gamma:0', r.p(bn_prefix, 'scale')),
                 (f'{n}/beta:0', r.p(bn_prefix, 'bias'))],
                [(f'{n}/moving_mean:0', r.s(bn_prefix, 'mean')),
                 (f'{n}/moving_variance:0', r.s(bn_prefix, 'var'))])

    if kind in ('conv_bn', 'dense_bn'):
        conv = kind == 'conv_bn'
        kernel = r.p(prefix)
        n = name('conv2d' if conv else 'dense')
        # our pre-BN convs/denses are bias-free (the bias is inert through
        # BN); where the reference layer has one, export zeros — exact
        ws = [(f'{n}/kernel:0', kernel)]
        if not conv or conv_bn_bias:
            ws.append((f'{n}/bias:0',
                       np.zeros(kernel.shape[-1], np.float32)))
        layers.append((n, ws, []))
        layers.append(bn_layer(bnp))
    elif kind == 'dense_bias_bn':
        n = name('dense')
        layers.append((n, [(f'{n}/kernel:0', r.p(prefix)),
                           (f'{n}/bias:0', r.p(prefix, 'bias'))], []))
        layers.append(bn_layer(bnp))
    elif kind == 'dense':
        n = name('dense')
        layers.append((n, [(f'{n}/kernel:0', r.p(prefix)),
                           (f'{n}/bias:0', r.p(prefix, 'bias'))], []))
    elif kind == 'conv_bias':
        n = name('conv2d')
        layers.append((n, [(f'{n}/kernel:0', r.p(prefix)),
                           (f'{n}/bias:0', r.p(prefix, 'bias'))], []))
    elif kind == 'conv1d':
        n = name('conv1d')
        layers.append((n, [(f'{n}/kernel:0', r.p(prefix)),
                           (f'{n}/bias:0', r.p(prefix, 'bias'))], []))
    elif kind == 'timeconv':
        # our TimeAxisResample matrix [T, target] -> channels_first
        # bias-free Conv1D kernel [1, T, target]
        n = name('conv1d')
        layers.append((n, [(f'{n}/kernel:0', r.p(prefix)[None])], []))
    elif kind == 'convT':
        # invert the import mapping: keras Conv2DTranspose kernels are
        # [kh, kw, out, in] and spatially mirrored vs lax.conv_transpose
        n = name('conv2d_transpose')
        layers.append((n, [(f'{n}/kernel:0',
                            r.p(prefix)[::-1, ::-1].transpose(0, 1, 3, 2)),
                           (f'{n}/bias:0', r.p(prefix, 'bias'))], []))
    elif kind == 'convT1':
        n = name('conv1d_transpose')
        layers.append((n, [(f'{n}/kernel:0',
                            r.p(prefix)[::-1].transpose(0, 2, 1)),
                           (f'{n}/bias:0', r.p(prefix, 'bias'))], []))
    elif kind == 'dwconv_bn':
        # flax grouped-conv [kh, kw, 1, C] -> keras DepthwiseConv2D
        # [kh, kw, C, 1]; no bias in the EfficientNet blocks
        n = name('depthwise_conv2d')
        layers.append((n, [(f'{n}/kernel:0',
                            r.p(prefix).transpose(0, 1, 3, 2))], []))
        layers.append(bn_layer(bnp))
    elif kind == 'stem_bn':
        # inverse of the import fold: emit an identity Normalization and
        # scale the stem kernel by 255 to cancel the keras Rescaling(1/255)
        # front layer (keras.applications EfficientNet graph). Forward
        # outputs match to float rounding (one x*255 * x/255 pair).
        n = name('normalization')
        c_in = r.p(prefix).shape[2]
        layers.append((n, [],
                       [(f'{n}/mean:0', np.zeros(c_in, np.float32)),
                        (f'{n}/variance:0', np.ones(c_in, np.float32)),
                        (f'{n}/count:0', np.asarray(0, np.int64))]))
        n = name('conv2d')
        layers.append((n, [(f'{n}/kernel:0',
                            r.p(prefix) * np.float32(255.0))], []))
        layers.append(bn_layer(bnp))
    elif kind == 'bare_bn':
        layers.append(bn_layer(bnp))
    elif kind == 'bilstm':
        # keras LSTM packs gates as [i, f, c, o] column blocks; flax
        # OptimizedLSTMCell holds one dense per gate with the bias on the
        # recurrent side (see _put_lstm in the importer)
        n = name('bidirectional')
        ws = []
        for c, (cell, d) in enumerate(
                (('OptimizedLSTMCell_0', 'forward_lstm'),
                 ('OptimizedLSTMCell_1', 'backward_lstm'))):
            cp = f'{prefix}/{cell}'
            kernel = np.concatenate(
                [r.p(f'{cp}/i{g}') for g in 'ifgo'], axis=1)
            recurrent = np.concatenate(
                [r.p(f'{cp}/h{g}') for g in 'ifgo'], axis=1)
            bias = np.concatenate(
                [r.p(f'{cp}/h{g}', 'bias') for g in 'ifgo'])
            base = f'{n}/{d}/lstm_cell'
            ws += [(f'{base}/kernel:0', kernel),
                   (f'{base}/recurrent_kernel:0', recurrent),
                   (f'{base}/bias:0', bias)]
        layers.append((n, ws, []))
    elif kind == 'bigru':
        # keras GRU gates are [z, r, h] columns with reset_after [2, 3u]
        # biases; flax splits the candidate bias rows (see _put_gru). The
        # z/r input-vs-recurrent bias split is underdetermined (only the
        # sum enters the gate) — all of it goes to the input row, which is
        # forward-identical
        n = name('bidirectional')
        ws = []
        for c, (cell, d) in enumerate((('GRUCell_0', 'forward_gru'),
                                       ('GRUCell_1', 'backward_gru'))):
            cp = f'{prefix}/{cell}'
            kernel = np.concatenate(
                [r.p(f'{cp}/i{g}') for g in 'zrn'], axis=1)
            recurrent = np.concatenate(
                [r.p(f'{cp}/h{g}') for g in 'zrn'], axis=1)
            u = recurrent.shape[0]
            bias = np.zeros((2, 3 * u), np.float32)
            bias[0, :u] = r.p(f'{cp}/iz', 'bias')
            bias[0, u:2 * u] = r.p(f'{cp}/ir', 'bias')
            bias[0, 2 * u:] = r.p(f'{cp}/in', 'bias')
            bias[1, 2 * u:] = r.p(f'{cp}/hn', 'bias')
            base = f'{n}/{d}/gru_cell'
            ws += [(f'{base}/kernel:0', kernel),
                   (f'{base}/recurrent_kernel:0', recurrent),
                   (f'{base}/bias:0', bias)]
        layers.append((n, ws, []))
    else:
        raise NotImplementedError(f'export: unsupported unit kind {kind!r}')
    return layers


def save_keras_h5_variables(bundle, variables, path: str) -> None:
    """Write flax ``variables`` as a Keras-2 legacy HDF5 weight file that
    the REFERENCE's own ``model.load_weights(NAME + '.h5')`` restores into
    the corresponding Keras model (reference: eval.py:63-65) — the inverse
    of :func:`load_keras_h5_variables`, closing the interop loop: models
    trained in this framework can be handed back to reference tooling.

    Keras' legacy loader is ORDER-based (keras legacy_h5_format
    ``load_weights_from_hdf5_group``): file groups must line up with
    ``model.layers`` filtered to weight-bearing layers, each group's
    weights in ``trainable_weights + non_trainable_weights`` order. The
    unit plans emit creation order == topological order for the sequential
    families; the two known divergences are handled explicitly (the 'se'
    composite's twin decoders interleave per depth level inside one nested
    group, and eff v7's gating Conv1D sorts before the BiGRU). The 'se'
    group order additionally depends on ``config.pretrain``, because the
    reference freezes one cascade half at build time and a frozen nested
    Model flattens per-sublayer instead of trainable-first (see
    ``flatten`` below) — export with the same ``pretrain`` the consuming
    model will be built with.

    Pre-BN conv/dense slots (bias-free in our models) export a zero bias;
    a tree imported from a reference checkpoint therefore re-exports with
    the original bias folded into the BN moving mean — different bytes,
    identical forward outputs (BN subtracts the mean).
    """
    import h5py

    plan = _family_plan(bundle)
    r = _TreeReader(variables)
    name = _Names()

    conv_bn_bias = bundle.config.model_type != 'eff'
    unit_layers = []     # creation order, one list of keras layers per unit
    for entry in plan:
        kind, prefix = entry[0], entry[1]
        bnp = entry[2] if len(entry) == 3 and entry[2] is not None \
            else (_bn_prefix(prefix) if prefix else None)
        unit_layers.append((kind, prefix,
                            _export_unit_layers(kind, prefix, bnp, r, name,
                                                conv_bn_bias=conv_bn_bias)))
    r.assert_consumed()

    model_type = bundle.config.model_type
    if model_type == 'se':
        # nested composite: two flattened groups (U-Net, then the vad
        # head). The U-Net's twin decoders (speech Upsampling_0..3 / noise
        # Upsampling_4..7) share graph depths, so keras orders them
        # interleaved PER SUBLAYER: s.conv, n.conv, s.bn, n.bn, s.convT,
        # n.convT for each decoder level.
        se_units = [(k, p, ls) for k, p, ls in unit_layers
                    if not p.startswith('vad/')]
        vad_units = [(k, p, ls) for k, p, ls in unit_layers
                     if p.startswith('vad/')]
        enc = [ls for k, p, ls in se_units if '/ConvSet_' in p]
        ups = {}
        for k, p, ls in se_units:
            if '/Upsampling_' in p:
                d = int(p.split('/Upsampling_')[1].split('/')[0])
                ups.setdefault(d, {})[k] = ls
        se_layers = [lay for ls in enc for lay in ls]
        for d in range(4):
            s, n_ = ups[d], ups[d + 4]
            s_conv, s_bn = s['conv_bn']
            n_conv, n_bn = n_['conv_bn']
            se_layers += [s_conv, n_conv, s_bn, n_bn,
                          s['convT'][0], n_['convT'][0]]

        def flatten(layers, frozen):
            """Keras' legacy weight order for a nested Model group is
            ``trainable_weights + non_trainable_weights`` — and the
            reference FREEZES exactly one cascade half at build time
            (sj_train.py:306 ``se_model.trainable = False`` unless
            pretrain; :317 vadmodel frozen when pretrain). A frozen
            half has NO trainable weights, so its group flattens in
            per-sublayer ``layer.weights`` order instead (BN moving
            stats inline after gamma/beta) — the order must match the
            freeze state of the model the file will be loaded into."""
            if frozen:
                return [w for _, tr, nt in layers for w in tr + nt]
            return ([w for _, tr, _ in layers for w in tr]
                    + [w for _, _, nt in layers for w in nt])

        pretrain = bool(getattr(bundle.config, 'pretrain', False))
        groups = [('se_model', flatten(se_layers, frozen=not pretrain)),
                  ('vad_model',
                   flatten([lay for _, _, ls in vad_units for lay in ls],
                           frozen=pretrain))]
    else:
        ordered = unit_layers
        if model_type == 'eff':
            # eff v7's gating Conv1D branches off the raw input and sorts
            # BEFORE the BiGRU in keras' depth order (verified against the
            # reference graph), while the build order creates it after
            kinds = [k for k, _, _ in ordered]
            if 'bigru' in kinds and 'conv1d' in kinds:
                gi, ci = kinds.index('bigru'), kinds.index('conv1d')
                if ci == gi + 1:
                    ordered = list(ordered)
                    ordered[gi], ordered[ci] = ordered[ci], ordered[gi]
        groups = [(lname, tr + nt)
                  for _, _, ls in ordered for lname, tr, nt in ls]

    with h5py.File(path, 'w') as f:
        f.attrs['layer_names'] = [n.encode() for n, _ in groups]
        f.attrs['backend'] = b'tensorflow'
        f.attrs['keras_version'] = b'2.15.0'
        for gname, ws in groups:
            g = f.create_group(gname)
            g.attrs['weight_names'] = [wn.encode() for wn, _ in ws]
            for wn, arr in ws:
                g.create_dataset(wn, data=arr)


# ------------------------------------------------------- the port's entries
def load_keras_h5_state_dict(bundle, path: str) -> dict:
    """A Keras HDF5 checkpoint as a ``state_dict`` for ``bundle.module``
    (float32 CPU tensors): :func:`load_keras_h5_variables` bridged by
    ``flax_to_state_dict``."""
    from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
    return flax_to_state_dict(load_keras_h5_variables(bundle, path))


def save_keras_h5_state_dict(bundle, state_dict, path: str) -> None:
    """Write ``state_dict`` (tensors on any device) as the Keras HDF5 file
    that :func:`save_keras_h5_variables` writes of the same weights: they
    are copied to the host and bridged by ``state_dict_to_flax``."""
    from challenge_tpu_torch.interop.jax_weights import state_dict_to_flax
    save_keras_h5_variables(
        bundle, state_dict_to_flax(state_dict, bundle.config), path)
