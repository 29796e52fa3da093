"""Shared inputs for the parity tests of ``challenge_tpu_torch`` against
``challenge_tpu`` (tests/test_torch_*.py).

Everything random is made here with numpy and handed to both packages: the
two frameworks' generators give different numbers from the same seed.
JAX's batch draws are taken at the synthesis kernel's boundary so that the
port can be fed exactly what JAX drew.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

N_FRAME, N_MELS, BATCH = 64, 32, 4


def small_sources(seed: int = 0):
    """(backgrounds, voices, int labels, noises) as [257, T, 4] float32
    lists. One background is shorter than N_FRAME, so the background bank is
    cyclically tiled; voice and noise lengths vary, so clip banks have zero
    tails and per-sample effective lengths differ."""
    rng = np.random.default_rng(seed)

    def specs(lengths):
        return [rng.standard_normal((257, int(t), 4)).astype(np.float32)
                for t in lengths]
    return (specs((94, N_FRAME // 3, 70)), specs((40, 23, 31, 40, 12)),
            rng.integers(0, 30, size=5), specs((20, 9, 14)))


def strip_flat(flat, chan: int, freq: int):
    """[..., chan * f_r] channel-major flat columns -> [..., chan * freq]:
    drops the JAX bank's 128-lane column padding."""
    flat = np.asarray(flat)
    f_r = flat.shape[-1] // chan
    planes = flat.reshape(flat.shape[:-1] + (chan, f_r))[..., :freq]
    return planes.reshape(flat.shape[:-1] + (chan * freq,))


def numpy_ordered_sum(nf, a, fma: bool, magnitude: bool = True):
    """The kernel's function in numpy, slot by slot in order. fma=True
    rounds ``acc + w * clip`` and ``re * re + im * im`` once, as an FMA
    does (the float64 product of two float32 values is exact).
    magnitude=False returns the float32 window itself."""
    t = np.arange(nf)
    acc = a['bgbank'][a['bidx'][:, None], a['boff'][:, None] + t[None, :]]
    for p in ('v', 'n'):
        if f'{p}bank' not in a:
            continue
        bank, idx, w = a[f'{p}bank'], a[f'{p}idx'], a[f'{p}w']
        rows = bank.shape[1]
        lens = a.get(f'{p}lens', np.full(idx.shape, rows))
        for k in range(idx.shape[1]):
            j = t[None, :] - a[f'{p}shift'][:, k, None]
            on = (j >= 0) & (j < lens[:, k, None]) & (w[:, k, None] != 0)
            clip = bank[idx[:, k, None], np.clip(j, 0, rows - 1)]
            wk = w[:, k, None, None]
            new = ((wk.astype(np.float64) * clip + acc).astype(np.float32)
                   if fma else acc + wk * clip)
            acc = np.where(on[..., None], new, acc)
    if not magnitude:
        return acc
    h = acc.shape[-1] // 2
    re, im = acc[..., :h], acc[..., h:]
    sq = ((re.astype(np.float64) * re + im * im).astype(np.float32)
          if fma else re * re + im * im)
    return np.sqrt(sq)


def synth_case(name):
    """(n_frame, arrays) for one adversarial draw; flat width 128 (the JAX
    kernel's lane rule), rows multiples of 8 (its sublane rule)."""
    if name == 'random':
        # negative shifts, shifts up to n_frame - 1, voices and noises
        rng = np.random.default_rng(1)
        b, nf, f = 4, 64, 128
        a = dict(
            bgbank=rng.standard_normal((3, 96, f)),
            bidx=rng.integers(0, 3, b), boff=rng.integers(0, 96 - nf, b),
            vbank=rng.standard_normal((5, 24, f)),
            vidx=rng.integers(0, 5, (b, 3)),
            vshift=rng.integers(-20, nf, (b, 3)),
            vw=rng.uniform(0.1, 1, (b, 3)),
            nbank=rng.standard_normal((4, 16, f)),
            nidx=rng.integers(0, 4, (b, 2)),
            nshift=rng.integers(-12, nf, (b, 2)),
            nw=rng.uniform(0.1, 1, (b, 2)))
    elif name == 'long_then_short':
        # a long clip then short ones through the same slot positions;
        # rows past each clip's length are zero (the bank contract)
        rng = np.random.default_rng(4)
        b, nf, f = 2, 64, 128
        lens = np.array([96, 20, 50, 96])
        vbank = rng.standard_normal((4, 96, f))
        for i, n in enumerate(lens):
            vbank[i, n:] = 0.0
        vidx = np.array([[0, 1, 2], [3, 2, 1]])
        a = dict(bgbank=rng.standard_normal((2, 128, f)),
                 bidx=np.array([0, 1]), boff=np.array([3, 40]),
                 vbank=vbank, vidx=vidx,
                 vshift=rng.integers(-10, nf, (b, 3)),
                 vw=rng.uniform(0.5, 1, (b, 3)), vlens=lens[vidx])
    elif name == 'edges':
        # w == 0 slots, a shift of exactly n_frame (lands nowhere), a shift
        # that leaves one row inside, a clip fully before the window
        rng = np.random.default_rng(6)
        b, nf, f = 3, 32, 128
        vw = rng.uniform(0.2, 1, (b, 4))
        vw[0, 1] = vw[2, 0] = vw[1, 3] = 0.0
        nw = rng.uniform(0.2, 1, (b, 2))
        nw[:, 1] = 0.0
        a = dict(bgbank=rng.standard_normal((2, 64, f)),
                 bidx=np.array([0, 1, 1]), boff=np.array([0, 8, 5]),
                 vbank=rng.standard_normal((3, 16, f)),
                 vidx=rng.integers(0, 3, (b, 4)),
                 vshift=np.array([[nf, -15, 0, 31], [-16, nf - 1, 7, 3],
                                  [2, 2, 2, -40]]),
                 vw=vw,
                 nbank=rng.standard_normal((2, 8, f)),
                 nidx=rng.integers(0, 2, (b, 2)),
                 nshift=np.array([[-7, 0], [nf - 8, 4], [nf, 1]]), nw=nw)
    else:
        raise KeyError(name)
    ints = {'bidx', 'boff', 'vidx', 'vshift', 'nidx', 'nshift', 'vlens'}
    return nf, {k: np.asarray(v, np.int32 if k in ints else np.float32)
                for k, v in a.items()}


def bank_case(name, dtype):
    """An adversarial case of :func:`synth_case` in one bank dtype, as
    (n_frame, the arrays JAX's kernel takes, the arrays of the numpy
    oracle). Bank rows are zero-padded to a multiple of 32 (JAX's int8
    sublane rule) with each clip's true length passed, so the sum is the
    float32 case's; bfloat16 banks are that case rounded, int8 banks
    quantized per item with the clip scales folded into the weights and
    the background scales passed, as the int8 banks are."""
    nf, a = synth_case(name)
    a = dict(a)
    for p in ('v', 'n'):
        if f'{p}bank' in a and f'{p}lens' not in a:
            a[f'{p}lens'] = np.full(a[f'{p}idx'].shape, a[f'{p}bank'].shape[1],
                                    np.int32)
    for key in ('bgbank', 'vbank', 'nbank'):
        if key in a:
            rows = a[key].shape[1]
            a[key] = np.pad(a[key], ((0, 0), (0, 32 - rows % 32 + 32),
                                     (0, 0)))
    oracle = dict(a)
    if dtype == 'bfloat16':
        for key in ('bgbank', 'vbank', 'nbank'):
            if key in a:
                a[key] = np.asarray(a[key], jax.numpy.bfloat16)
                oracle[key] = a[key].astype(np.float32)
    elif dtype == 'int8':
        scales = {}
        for key in ('bgbank', 'vbank', 'nbank'):
            if key in a:
                peak = np.abs(a[key]).max(axis=(1, 2))
                scales[key] = np.where(peak > 0, peak / 127.0,
                                       1.0).astype(np.float32)
                a[key] = np.clip(np.round(a[key] / scales[key][:, None, None]),
                                 -127, 127).astype(np.int8)
        a['bgscale'] = scales['bgbank'][a['bidx']]
        a['vw'] = a['vw'] * scales['vbank'][a['vidx']]
        if 'nbank' in a:
            a['nw'] = a['nw'] * scales['nbank'][a['nidx']]
        oracle = dict(a)
        oracle.pop('bgscale')
        for key in ('bgbank', 'vbank', 'nbank'):
            if key in a:
                oracle[key] = a[key].astype(np.float32)
        oracle['bgbank'] = oracle['bgbank'] * scales['bgbank'][:, None, None]
    return nf, a, oracle


def to_torch(a):
    return {k: (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                if v.dtype == jax.numpy.bfloat16 else torch.from_numpy(v))
            for k, v in a.items()}


def jax_draws(banks, key, batch_size: int = BATCH, n_frame: int = N_FRAME,
              **kw):
    """JAX's ``sample_batch(..., use_pallas=True, layout='tfc',
    magnitude='flat')`` draws, taken at the synthesis kernel's boundary
    (the kernel itself is not run: its arguments are recorded and zeros
    returned), with the per-voice labels. Returns a dict of numpy arrays."""
    import challenge_tpu.data.mixture as jmix
    import challenge_tpu.ops.pallas_synth as ps

    rec = {}

    def synth(n_frame_, bgflat, *args, **kw):
        (rec['bidx'], rec['boff'], _, rec['vidx'], rec['vshift'], rec['vw'],
         _, rec['nidx'], rec['nshift'], rec['nw'], rec['vlens'],
         rec['nlens']) = args[:12]
        assert kw['magnitude'] is True
        return jnp.zeros((args[0].shape[0], n_frame_, bgflat.shape[-1] // 2))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, 'synthesize_windows', synth)

        @jax.jit
        def run(key, banks):
            # unjitted sample_batch, so the recorded values are run()'s
            _, label = jmix.sample_batch.__wrapped__(
                key, banks, batch_size, n_frame, use_pallas=True,
                layout='tfc', magnitude='flat', **kw)
            return dict(rec, label=label)
        out = jax.device_get(run(key, banks))
    return {k: np.array(v) for k, v in out.items()}


def jax_magnitude(banks, d, n_frame: int = N_FRAME):
    """The JAX Pallas kernel (interpret mode) in magnitude mode on the
    draws ``d`` of :func:`jax_draws`: [B, n_frame, 2 * f_r] flat."""
    from challenge_tpu.ops.pallas_synth import synthesize_windows
    return np.asarray(synthesize_windows(
        n_frame, banks.backgrounds.flat, d['bidx'], d['boff'],
        banks.voices.flat, d['vidx'], d['vshift'], d['vw'],
        banks.noises.flat, d['nidx'], d['nshift'], d['nw'],
        d['vlens'], d['nlens'], magnitude=True, interpret=True))


def jax_features(cfg, mag, label, key):
    """JAX's ``make_feature_fn(cfg)`` training chain on its fused-magnitude
    branch, fed the given ``sample_batch`` output: flat magnitude ``mag``
    [B, T, 2 * f_r] and per-voice labels [B, V, T, C]. Returns a dict of
    numpy arrays: the features ``x``, ``y``, the mel before (``mel_raw``)
    and after (``mel``) minmax, and the SpecAugment masks the chain drew."""
    import challenge_tpu.data.pipeline as jpipe
    from challenge_tpu.ops.augment import batch_mask_keep

    rec = {}
    orig_minmax = jpipe.minmax

    def minmax(x):
        out = orig_minmax(x)
        rec['mel_raw'], rec['mel'] = x, out
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, 'sample_batch',
                   lambda *a, **kw: (jnp.asarray(mag), jnp.asarray(label)))
        mp.setattr(jpipe, 'minmax', minmax)
        fn = jpipe.make_feature_fn(cfg, training=True, jit=False,
                                   n_classes=label.shape[-1],
                                   use_pallas=False, fused_mag=True)

        @jax.jit
        def run(key):
            x, y = fn(key, None)
            return dict(rec, x=x, y=y)
        out = jax.device_get(run(key))
    # the masks make_feature_fn draws from its aug key (pipeline.py:191-202)
    _, k_aug, _ = jax.random.split(key, 3)
    k_t, k_f = jax.random.split(k_aug)
    out['tmask'] = batch_mask_keep(k_t, cfg.batch_size, cfg.n_frame,
                                   max_mask_size=24, n_mask=6)
    out['fmask'] = batch_mask_keep(k_f, cfg.batch_size, 257,
                                   max_mask_size=16, n_mask=1)
    return {k: np.array(v) for k, v in out.items()}


def port_draws(rec, n_frame: int = N_FRAME):
    """The port's Draws from a :func:`jax_draws` record."""
    from challenge_tpu_torch.data.mixture import Draws
    t = {k: torch.from_numpy(np.array(rec[k])) for k in (
        'bidx', 'boff', 'vidx', 'vshift', 'vw', 'vlens', 'nidx', 'nshift',
        'nw', 'nlens')}
    return Draws(n_frame, **t)


def vad_variables(module, input_shape, seed: int = 0):
    """flax variables of ``module`` filled from numpy: kernels scaled by
    1/sqrt(fan_in), BN scales near 1, biases and running statistics away
    from their initial values so that every bridged tensor matters."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + tuple(input_shape)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)
