"""The JAX package's public API in the port: the reference-shaped batch
and sample synthesis (data/mixture.py ``sample_batch``,
``merge_complex_specs``), the raw pipeline and ``make_feature_fn``
(data/pipeline.py), ``sj_train.make_dataset``, ``multiply_label``, the
key-based augment ops (ops/augment.py, with a ``torch.Generator`` for the
key), ``stft_magnitude``, ``log_on_mel``, ``minmax_log_on_mel``,
``make_infer_fn``, ``set_learning_rate``, ``export_keras_legacy_h5``, and
the subpackages' exports, each against its JAX counterpart on the CPU.

torch cannot reproduce ``jax.random``, so JAX's draws are fed to the port:
``sample_batch``'s at the kernel boundary (``_torch_parity.jax_draws``),
``merge_complex_specs``' recomputed from its key here, the augment ops'
masks and factors through the port's draw functions. The port's own draws
are held to their distributions. Tolerances (ROADMAP "Tolerances"):
labels exact; float32 spectrograms at rtol 1e-5 / atol 1e-6 against JAX's
interpret-mode kernel; bfloat16 and int8 banks within one bfloat16 ulp of
JAX's own bfloat16 output (or 1e-6), the bound of
test_torch_synth_flat.py, since the interpret mode's FMAs can move a
float32 sum across a bfloat16 rounding boundary; masks and the filter at
0.0; log-mel by mean absolute error.

JAX's interpret-mode kernel costs a few seconds of compile a call, so the
``sample_batch`` cases run 2 samples of 32 frames with 3 voice slots (2
for the se triple, three kernel calls).
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    N_FRAME, N_MELS, jax_draws, port_draws, record_grids, small_sources,
    vad_variables, write_dev_set)
import challenge_tpu
import challenge_tpu.data.mixture as jmix
import challenge_tpu.ops.pallas_synth as jps
from challenge_tpu.config import Config as JConfig
from challenge_tpu.data import labels as jlabels
from challenge_tpu.data import pipeline as jpipe
from challenge_tpu.evaluate import infer as jinfer
from challenge_tpu.interop import keras_h5 as jkeras
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu.ops import augment as jaug
from challenge_tpu.ops import dsp as jdsp
from challenge_tpu.ops import norms as jnorms
from challenge_tpu.train import optim as joptim
import challenge_tpu_torch
from challenge_tpu_torch.cli import sj_train
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data import pipeline
from challenge_tpu_torch.data.labels import multiply_label
from challenge_tpu_torch.data.pipeline import (
    FeatureFn, build_banks, make_feature_fn, make_pipeline)
from challenge_tpu_torch.evaluate import infer
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.interop.keras_h5 import export_keras_legacy_h5
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.ops import augment, dsp, norms
from challenge_tpu_torch.train.optim import make_optimizer, set_learning_rate
from challenge_tpu_torch.train.state import TrainState

RTOL, ATOL = 1e-5, 1e-6
B, NF = 2, 32                     # sample_batch's cases
DTYPES = ['float32', 'bfloat16', 'int8']
ROUTES = {'ftc': dict(layout='ftc'), 'tfc': dict(layout='tfc'),
          'magnitude': dict(layout='tfc', magnitude=True),
          'se': dict(layout='ftc', seperate_noise_voice=True)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _within_one_bf16_ulp(out, ref):
    """|out - ref| <= one bfloat16 ulp of ref, or 1e-6."""
    out, ref = _f32(out), _f32(ref)
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(out - ref) > np.maximum(ulp, 1e-6)
    assert not bad.any(), (int(bad.sum()), np.abs(out - ref).max())


def _close(mine, ref, dtype):
    assert tuple(mine.shape) == tuple(np.shape(ref))
    if dtype == 'float32':
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
    else:
        assert mine.dtype == torch.bfloat16
        assert np.asarray(ref).dtype == jnp.bfloat16
        _within_one_bf16_ulp(mine, ref)


# ------------------------------------------------------------ sample_batch
_SOURCES = small_sources(4)
_DRAWS = {}


def _jax_draws(max_voices):
    """JAX's float32 banks' draws; its bfloat16 and int8 banks draw the
    same (the draws read only lengths), as test_torch_synth_flat.py
    shows."""
    if max_voices not in _DRAWS:
        _DRAWS[max_voices] = jax_draws(
            jpipe.build_banks(*_SOURCES, n_frame=NF), jax.random.PRNGKey(3),
            batch_size=B, n_frame=NF, max_voices=max_voices)
    return _DRAWS[max_voices]


def _jax_sample_batch(dtype, max_voices, **kw):
    """JAX's ``sample_batch(use_pallas=True)`` with its kernel in interpret
    mode, on its banks of ``dtype``."""
    banks = jpipe.build_banks(*_SOURCES, n_frame=NF, flat_dtype=dtype)
    orig = jps.synthesize_windows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, 'synthesize_windows',
                   lambda *a, **k: orig(*a, interpret=True, **k))
        out = jax.jit(lambda k, b: jmix.sample_batch.__wrapped__(
            k, b, B, NF, max_voices=max_voices, use_pallas=True, **kw))(
            jax.random.PRNGKey(3), banks)
        return jax.device_get(out)


@pytest.mark.parametrize('route', list(ROUTES))
@pytest.mark.parametrize('dtype', DTYPES)
def test_sample_batch_matches_jax(dtype, route):
    """The port's batch from JAX's draws (``batch_of``) against JAX's
    ``sample_batch`` in both layouts, magnitude mode and the se triple:
    its shapes, labels exactly, spectrograms at the dtype's bound."""
    kw = ROUTES[route]
    mv = 2 if route == 'se' else 3
    spec, label = _jax_sample_batch(dtype, mv, **kw)
    pb = build_banks(*_SOURCES, n_frame=NF, flat_dtype=dtype, device='cpu')
    mine, mlabel = mixture.batch_of(pb, port_draws(_jax_draws(mv), NF), **kw)
    shape = {'ftc': (B, 257, NF, 4), 'tfc': (B, NF, 257, 4),
             'magnitude': (B, NF, 2, 257), 'se': (B, 257, NF, 4)}[route]
    assert tuple(mine.shape) == shape
    _close(mine, spec, dtype)
    if route == 'se':
        (label, only_voice, only_noise), (mlabel, mv_, mn_) = label, mlabel
        _close(mv_, only_voice, dtype)
        _close(mn_, only_noise, dtype)
    assert mlabel.shape == (B, mv, NF, 3) and mlabel.dtype == torch.float32
    np.testing.assert_array_equal(mlabel.numpy(), label)


def test_sample_batch_draws_and_refusals():
    """``sample_batch`` with a generator is ``draw`` then ``batch_of`` on
    the same generator state; JAX's asserts are ValueErrors."""
    pb = build_banks(*_SOURCES, n_frame=NF, device='cpu')
    spec, label = mixture.sample_batch(torch.Generator().manual_seed(5), pb,
                                       3, NF, max_voices=4)
    d = mixture.draw(torch.Generator().manual_seed(5), pb, 3, NF,
                     max_voices=4)
    ref, ref_label = mixture.batch_of(pb, d)
    assert torch.equal(spec, ref) and torch.equal(label, ref_label)
    assert spec.shape == (3, 257, NF, 4) and label.shape == (3, 4, NF, 3)
    mag, _ = mixture.batch_of(pb, d, layout='tfc', magnitude=True)
    flat, _ = mixture.synthesize(pb, d)
    assert torch.equal(flat.reshape(mag.shape), mag)
    for bad in (dict(magnitude=True), dict(layout='tfc', magnitude=True,
                                           seperate_noise_voice=True),
                dict(layout='xyz'), dict(n_classes=4)):
        with pytest.raises(ValueError):
            mixture.batch_of(pb, d, **bad)


# ----------------------------------------------------- merge_complex_specs
def _jax_merge_draws(key, v, n, n_frame, bg_len, voice_len, noise_len,
                     min_ratio=2 / 3, min_noise_ratio=0.5, snr=-20.0):
    """JAX's draws of ``merge_complex_specs(key, ...)``, recomputed with its
    own helpers and key splits (mixture.py:168-216)."""
    k_bg, k_nv, k_voice, k_noise = jax.random.split(key, 4)
    n_tile = -(-n_frame // bg_len)
    bg_offset = jmix._dyn_randint(k_bg, jnp.int32(n_tile * bg_len
                                                  - n_frame + 1))
    n_voices = jax.random.randint(k_nv, (), 1, v) if v > 1 else 1
    ratios, offsets = [], []
    for vk in jax.random.split(k_voice, v):
        k_ratio, k_off = jax.random.split(vk)
        ratios.append(jnp.power(10.0, -jax.random.uniform(
            k_ratio, (), minval=0.0, maxval=-snr / 10.0)))
        offsets.append(jmix._placement_draw(
            k_off, jnp.int32(voice_len), n_frame, min_ratio, False)[0])
    k_nn, k_each = jax.random.split(k_noise)
    n_noises = jax.random.randint(k_nn, (), 0, n)
    n_ratios, n_offsets = [], []
    for nk in jax.random.split(k_each, n):
        k_ratio, k_off = jax.random.split(nk)
        n_ratios.append(jnp.power(10.0, -jax.random.uniform(
            k_ratio, (), maxval=2.0)))
        n_offsets.append(jmix._placement_draw(
            k_off, jnp.int32(noise_len), n_frame, min_noise_ratio, True)[0])

    def t(x, dt=torch.int32):
        return torch.from_numpy(np.array(x)).to(dt)
    return mixture.MergeDraws(
        t(bg_offset), t(n_voices), t(ratios, torch.float32), t(offsets),
        t(n_noises), t(n_ratios, torch.float32), t(n_offsets))


def _merge_inputs(seed=0):
    rng = np.random.default_rng(seed)
    bg = rng.standard_normal((257, 20, 4)).astype(np.float32)
    voices = np.abs(rng.standard_normal((5, 257, 12, 4))).astype(np.float32)
    voices[:, :, 9:] = 0.0                  # zero tails: frames not voiced
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=5)]
    noises = rng.standard_normal((3, 257, 9, 4)).astype(np.float32)
    return bg, voices, labels, noises


@pytest.mark.parametrize('seperate', [False, True])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_merge_complex_specs_matches_jax_on_its_draws(seed, seperate):
    bg, voices, labels, noises = _merge_inputs(seed)
    key = jax.random.PRNGKey(seed)
    nf = 30
    ref = jmix.merge_complex_specs(key, bg, (voices, labels), noises,
                                   n_frame=nf, seperate_noise_voice=seperate)
    draws = _jax_merge_draws(key, 5, 3, nf, 20, 12, 9)
    out = mixture.merge_placed(
        torch.from_numpy(bg), (torch.from_numpy(voices),
                               torch.from_numpy(labels)),
        torch.from_numpy(noises), draws, n_frame=nf,
        seperate_noise_voice=seperate)
    (spec, label), (jspec, jlabel) = out, ref
    if seperate:
        (label, ov, on), (jlabel, jov, jon) = label, jlabel
        np.testing.assert_allclose(ov.numpy(), jov, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(on.numpy(), jon, rtol=RTOL, atol=ATOL)
    assert spec.shape == (257, nf, 4) and label.shape == (5, nf, 3)
    np.testing.assert_allclose(spec.numpy(), jspec, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(label.numpy(), jlabel)


def test_merge_complex_specs_draws_follow_jax_distributions():
    """The port's own draws: the voice count in [1, V), the noise count in
    [0, N), the ratios' ranges, the offsets in their ranges; and a sample's
    labels never overlap (at most 1 per frame and class)."""
    bg, voices, labels, noises = (torch.from_numpy(a)
                                  for a in _merge_inputs(3))
    gen = torch.Generator().manual_seed(0)
    counts, n_counts = set(), set()
    for _ in range(200):
        d = mixture.merge_draws(gen, 5, 30, 20, 12, 3, 9)
        counts.add(int(d.n_voices))
        n_counts.add(int(d.n_noises))
        assert ((d.voice_ratios > 0.01 - 1e-7)
                & (d.voice_ratios <= 1.0)).all()
        assert ((d.noise_ratios > 0.01 - 1e-7)
                & (d.noise_ratios <= 1.0)).all()
        assert 0 <= int(d.bg_offset) < 2 * 20 - 30 + 1
        pad = 30 - int(np.floor(np.float32(2 / 3) * 12))
        assert ((d.voice_offsets >= 0)
                & (d.voice_offsets < 12 + 2 * pad - 30)).all()
    assert counts == {1, 2, 3, 4} and n_counts == {0, 1, 2}
    spec, label = mixture.merge_complex_specs(
        gen, bg, (voices, labels), noises, n_frame=30)
    assert spec.shape == (257, 30, 4) and label.sum(0).max() <= 1.0


# ---------------------------------------------------------- the pipelines
def test_make_pipeline_yields_reference_shaped_samples(monkeypatch):
    """Single samples [freq, n_frame, chan] and [V, n_frame, C] (the
    triple's parts for se), and the bare pipeline's min_ratio 2/3, as
    JAX's ``_RawPipeline`` sets it."""
    bgs, voices, labels, noises = _SOURCES
    onehot = np.eye(3, dtype=np.float32)[labels % 3]
    seen = []
    orig = pipeline.sample_batch
    monkeypatch.setattr(pipeline, 'sample_batch',
                        lambda *a, **kw: seen.append(kw) or orig(*a, **kw))
    pipe = make_pipeline(bgs, voices, onehot, noises, n_frame=NF,
                         max_voices=3, max_noises=2, device='cpu')
    (spec, label), = pipe.take(1)
    assert spec.shape == (257, NF, 4) and label.shape == (3, NF, 3)
    jpipe_ = jpipe._RawPipeline(None, NF, 3, 2, 3)
    assert seen[0]['min_ratio'] == jpipe_._sample.keywords['min_ratio'] \
        == 2 / 3 and seen[0]['batch_size'] == 1
    se = make_pipeline(bgs, voices, onehot, noises, n_frame=NF,
                       max_voices=3, max_noises=2, device='cpu',
                       seperate_noise_voice=True, min_ratio=1.0)
    spec, (label, ov, on) = next(iter(se))
    assert seen[-1]['min_ratio'] == 1.0
    assert spec.shape == ov.shape == on.shape == (257, NF, 4)
    with pytest.raises(ValueError, match='n_samples, n_classes'):
        make_pipeline(bgs, voices, labels, noises, device='cpu')


def test_make_feature_fn_and_make_dataset(tmp_path, monkeypatch):
    """``make_feature_fn`` is the port's FeatureFn with JAX's arguments;
    ``sj_train.make_dataset`` a DevicePipeline over ``make_banks``."""
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 batch_size=2)
    fn = make_feature_fn(cfg, training=False, n_classes=3, device='cpu')
    assert isinstance(fn, FeatureFn) and not fn.training
    assert not fn.fused_mel and fn.n_classes == 3
    assert make_feature_fn(cfg, fused_mel=True, device='cpu').fused_mel
    from _helpers import make_datafiles
    make_datafiles(tmp_path)
    monkeypatch.chdir(tmp_path)
    files = dict(background_sounds='bg.pickle', voices='voice.pickle',
                 labels='labels.npy', noises='noise.pickle',
                 test_background_sounds='test_bg.pickle',
                 test_voices='test_voice.pickle',
                 test_labels='test_labels.npy')
    ds = sj_train.make_dataset(cfg.replace(datapath=str(tmp_path),
                                           stream_chunks=2, **files),
                               training=True, device='cpu')
    assert isinstance(ds, pipeline.DevicePipeline)
    x, y = next(iter(ds))
    assert x.shape == (2, N_MELS, N_FRAME, 2) and y.shape == (2, 2, 3)


def test_feature_fn_equals_its_composition_from_the_api():
    """A FeatureFn training batch at 0.0 against the same batch composed
    from ``sample_batch`` (magnitude), ``batch_specaugment`` and
    ``minmax_log_on_mel`` on the same generator: the new functions draw in
    FeatureFn's order."""
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 batch_size=3)
    pb = build_banks(*_SOURCES, n_frame=N_FRAME, device='cpu')
    fn = FeatureFn(cfg, device='cpu')
    x, y = fn(torch.Generator().manual_seed(9), pb)
    gen = torch.Generator().manual_seed(9)
    mag, label = mixture.sample_batch(
        gen, pb, cfg.batch_size, cfg.n_frame, max_voices=cfg.max_voices,
        max_noises=cfg.max_noises, snr=cfg.snr, layout='tfc',
        magnitude=True)                              # [B, T, 2, freq]
    mag = augment.batch_specaugment(gen, mag, time_axis=1, freq_axis=3)
    mel = torch.matmul(mag, fn.melm).permute(0, 3, 1, 2)
    assert torch.equal(norms.minmax_log_on_mel(mel), x)
    assert torch.equal(fn.labels(label), y)


# ------------------------------------------------------------- the augments
def _specs(shape=(3, 257, 40, 4), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _feed(monkeypatch, name, values):
    """Make ``augment.<name>`` return ``values`` in turn (JAX's draws)."""
    it = iter(values)
    monkeypatch.setattr(augment, name,
                        lambda *a, **kw: torch.from_numpy(
                            np.asarray(next(it), np.float32)))


def test_batch_mask_and_specaugment_apply_jax_spans(monkeypatch):
    x = _specs()
    key = jax.random.PRNGKey(1)
    ref = jaug.batch_mask(key, x, axis=-2, max_mask_size=24, n_mask=6)
    _feed(monkeypatch, 'batch_mask_keep', [jaug.batch_mask_keep(
        key, 3, 40, 24, 6)])
    out = augment.batch_mask(None, torch.from_numpy(x), -2, 24, 6)
    np.testing.assert_array_equal(out.numpy(), ref)
    ref = jaug.batch_specaugment(key, x)
    k_t, k_f = jax.random.split(key)
    _feed(monkeypatch, 'batch_mask_keep', [
        jaug.batch_mask_keep(k_t, 3, 40, 24, 6),
        jaug.batch_mask_keep(k_f, 3, 257, 16, 1)])
    out = augment.batch_specaugment(None, torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_mask_and_specaugment_apply_jax_spans(monkeypatch):
    x = _specs((257, 40, 4))
    key = jax.random.PRNGKey(2)
    ones = np.ones_like(x)
    keep = jaug.mask(key, ones, axis=1, max_mask_size=24, n_mask=6)[0, :, 0]
    _feed(monkeypatch, 'batch_mask_keep', [keep[None]])
    out = augment.mask(None, torch.from_numpy(x), 1, 24, 6)
    np.testing.assert_array_equal(
        out.numpy(), jaug.mask(key, x, axis=1, max_mask_size=24, n_mask=6))
    k_t, k_f = jax.random.split(key)
    tkeep = jaug.mask(k_t, ones, axis=-2, max_mask_size=24, n_mask=6)
    fkeep = jaug.mask(k_f, ones, axis=-3, max_mask_size=16, n_mask=1)
    _feed(monkeypatch, 'batch_mask_keep', [tkeep[0, :, 0][None],
                                           fkeep[:, 0, 0][None]])
    out, lab = augment.specaugment(None, torch.from_numpy(x), 'y')
    ref, jlab = jaug.specaugment(key, x, 'y')
    np.testing.assert_array_equal(out.numpy(), ref)
    assert lab == jlab == 'y'


def test_random_shift_applies_jax_shift(monkeypatch):
    x = _specs((50, 6))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = jaug.random_shift(key, x, axis=0, width=16)
        offset = int(jax.random.randint(key, (), 0, 33))
        orig = torch.randint
        with monkeypatch.context() as mp:
            mp.setattr(augment.torch, 'randint',
                       lambda *a, **kw: torch.tensor(offset))
            out = augment.random_shift(torch.Generator(),
                                       torch.from_numpy(x), 0, 16)
        assert torch.randint is orig
        np.testing.assert_array_equal(out.numpy(), ref)


def test_batch_random_merge_aug_and_stft_filter_match_jax(monkeypatch):
    x = _specs()
    key = jax.random.PRNGKey(4)
    ref = jaug.batch_random_merge_aug(6)(key, x)
    factors = [jax.random.uniform(k, (1, 1, 4), minval=0.1, maxval=0.9)
               for k in jax.random.split(key, 3)]
    _feed(monkeypatch, 'merge_factors',
          [np.concatenate([f.reshape(1, 4) for f in factors])])
    out = augment.batch_random_merge_aug(6)(None, torch.from_numpy(x))
    assert out.shape == ref.shape == (3, 257, 40, 12)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    filt, jfilt = augment.stft_filter(13), jaug.stft_filter(13)
    np.testing.assert_array_equal(filt(torch.from_numpy(x)).numpy(),
                                  jfilt(x))
    tfc = np.swapaxes(x, 1, 2)
    out, y = augment.stft_filter(13, freq_axis=-2)(torch.from_numpy(tfc), 1)
    np.testing.assert_array_equal(out.numpy(),
                                  jaug.stft_filter(13, freq_axis=-2)(tfc))
    assert y == 1


def test_augment_draws_follow_jax_distributions():
    """Over 4,000 draws from a seeded generator and from JAX: every span
    shorter than its bound, and the masked share of the axis, the zeroed
    spans a sample, the shifts and the merge factors agree in mean within
    five standard errors."""
    n = 4000
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    keep = augment.batch_mask_keep(gen, n, 100, 24, 6).numpy()
    jkeep = np.asarray(jaug.batch_mask_keep(key, n, 100, 24, 6))
    for a in (keep, jkeep):
        assert set(np.unique(a)) <= {0.0, 1.0}
    frac, jfrac = 1 - keep.mean(1), 1 - jkeep.mean(1)
    se = np.sqrt(frac.var() / n + jfrac.var() / n)
    assert abs(frac.mean() - jfrac.mean()) < 5 * se
    one = 1 - augment.batch_mask_keep(gen, n, 257, 16, 1).numpy()
    assert one.sum(1).max() <= 15
    # out[j] = x[j + s]: the value 20 of x = 1..40 lands at j = 19 - s
    shifts = np.array([19 - np.argmax(augment.random_shift(
        gen, torch.arange(1.0, 41.0)[:, None], 0, 16)[:, 0].numpy() == 20.0)
        for _ in range(400)])
    assert set(shifts) == set(range(-16, 17))
    f = augment.merge_factors(gen, n, 3).numpy()
    jf = np.asarray(jax.random.uniform(key, (n,), minval=0.1, maxval=0.9))
    assert 0.1 <= f.min() and f.max() < 0.9
    se = np.sqrt(f.var() / n + jf.var() / n)
    assert abs(f.mean() - jf.mean()) < 5 * se


# ---------------------------------------------------- dsp, norms, labels
def test_stft_magnitude_matches_jax():
    wav = np.random.default_rng(3).standard_normal((2, 5000)).astype(
        np.float32)
    out = dsp.stft_magnitude(torch.from_numpy(wav))
    ref = np.asarray(jdsp.stft_magnitude(wav))
    assert out.shape == ref.shape == (2, 257, 5000 // 256 + 1)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_log_on_mel_and_minmax_log_on_mel_match_jax():
    mel = np.abs(np.random.default_rng(4).standard_normal(
        (3, 40, 64, 2))).astype(np.float32)
    mel[0, :, :5] = 0.0                  # log(eps) bins
    for fn, jfn in ((norms.log_on_mel, jnorms.log_on_mel),
                    (norms.minmax_log_on_mel, jnorms.minmax_log_on_mel)):
        out, lab = fn(torch.from_numpy(mel), 'y')
        ref, jlab = jfn(mel, 'y')
        assert lab == jlab == 'y' and out.shape == ref.shape
        assert np.abs(out.numpy() - np.asarray(ref)).mean() < 1e-6
        assert torch.equal(fn(torch.from_numpy(mel)), out)
    assert norms.LOG_EPSILON == jnorms.LOG_EPSILON


def test_load_wav_device_is_load_wav(tmp_path):
    write_dev_set(tmp_path, seconds=(1.0,))
    path = str(tmp_path / 'clip0.wav')
    a = dsp.load_wav_device(path, device='cpu')
    assert torch.equal(a, dsp.load_wav(path, device='cpu'))
    ref = np.asarray(jdsp.load_wav_device(path))
    assert np.abs(a.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_multiply_label_matches_jax():
    x, y = _specs((2, 4)), _specs((2, 8, 3), seed=1)
    out = multiply_label(2.5)(torch.from_numpy(x), torch.from_numpy(y))
    ref = jlabels.multiply_label(2.5)(x, y)
    np.testing.assert_array_equal(out[0].numpy(), ref[0])
    np.testing.assert_array_equal(out[1].numpy(), ref[1])


# ------------------------------------------------ infer, optimizer, h5
CFG = dict(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME)


def test_make_infer_fn_grid_equals_jax_and_evaluate(tmp_path, monkeypatch):
    """vad v8 at base 8 and td_dim 32 with bridged weights: the port's
    ``make_infer_fn`` grid equals JAX's ``make_infer_fn`` grid on each
    clip and the per-clip ``evaluate`` grid."""
    write_dev_set(tmp_path)
    jm = JVADModel(v=8, base_fsize=8, td_dim=32)
    variables = vad_variables(jm, (N_MELS, N_FRAME, 2), seed=5)
    jfn = jinfer.make_infer_fn(JBundle(jm, (N_MELS, N_FRAME, 2),
                                       JConfig(**CFG)), JConfig(**CFG),
                               overlap_hop=32)
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    pm.load_state_dict(flax_to_state_dict(variables))
    fn = infer.make_infer_fn(pm, Config(**CFG), overlap_hop=32)
    grids = record_grids(monkeypatch, infer)
    infer.evaluate(Config(**CFG), pm, overlap_hop=32, batched=False,
                   eval_dir=str(tmp_path))
    paths = sorted(str(p) for p in tmp_path.glob('*.wav'))
    assert len(grids) == len(paths) == 3
    for path, grid in zip(paths, grids):
        out = fn(dsp.load_wav(path, device='cpu'))
        ref = np.asarray(jfn(variables, jdsp.load_wav_device(path)))
        assert out.dtype == torch.float32 and out.shape[1] == 3
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(out.numpy(), grid)
    assert any(g.any() for g in grids)
    with pytest.raises(ValueError, match='clip_seed'):
        infer.make_infer_fn(pm, Config(**CFG, n_chan=4))(
            dsp.load_wav(paths[0], device='cpu'))


def test_set_learning_rate_matches_jax():
    cfg = Config(lr=1e-3)
    module = torch.nn.Linear(2, 1)
    opt = make_optimizer(cfg, module.parameters())
    state = TrainState(module, opt)
    set_learning_rate(state.optimizer, 3.3e-4)
    jopt = joptim.make_optimizer(JConfig(lr=1e-3))
    jstate = joptim.set_learning_rate(
        jopt.init({'w': jnp.zeros(2)}), 3.3e-4)
    assert float(opt.param_groups[0]['lr']) == float(
        jstate.hyperparams['learning_rate'])


class _Layer:
    def __init__(self, name, weights):
        self.name, self.weights = name, weights


class _Weight(np.ndarray):
    pass


def _weight(a, name=None):
    w = np.asarray(a, np.float32).view(_Weight)
    if name is not None:
        w.name = name
    return w


def test_export_keras_legacy_h5_writes_jax_file(tmp_path):
    pytest.importorskip('h5py')
    rng = np.random.default_rng(0)
    model = type('Model', (), {})()
    model.layers = [
        _Layer('conv2d', [_weight(rng.standard_normal((3, 3, 2, 4)),
                                  'conv2d/kernel'),
                          _weight(rng.standard_normal(4), 'conv2d/bias:0')]),
        _Layer('dropout', []),
        _Layer('dense', [_weight(rng.standard_normal((4, 3)))])]
    export_keras_legacy_h5(model, str(tmp_path / 'port.h5'))
    jkeras.export_keras_legacy_h5(model, str(tmp_path / 'jax.h5'))
    import h5py
    dumps = []
    for name in ('port.h5', 'jax.h5'):
        with h5py.File(tmp_path / name, 'r') as f:
            dump = [list(f.attrs['layer_names'])]
            for lname in f.attrs['layer_names']:
                g = f[lname]
                dump.append(list(g.attrs['weight_names']))
                dump += [np.asarray(g[w]).tobytes()
                         for w in g.attrs['weight_names']]
            dumps.append(dump)
    assert dumps[0] == dumps[1]
    assert [str(n) for n in dumps[0][0]] == ['conv2d', 'dense']
    assert [str(n) for n in dumps[0][1]] == ['conv2d/kernel:0',
                                             'conv2d/bias:0']
    assert [str(n) for n in dumps[0][4]] == ['dense/weight_0:0']


# ------------------------------------------------------------- the exports
# JAX names without a counterpart in the port, and why
NO_COUNTERPART = {
    'parallel': {
        'BATCH_AXIS': "the name of the jax.sharding.Mesh axis; the port's "
                      'mesh is one axis of ranks',
        'batch_sharding': "a jax.sharding.NamedSharding; a rank holds its "
                          'share itself',
        'replicated': 'a jax.sharding.NamedSharding; replicate() copies '
                      "rank 0's state",
    },
    'train': {
        'scale_by_adabelief': 'an optax transform; the port has the '
                              'AdaBelief optimizer',
    },
}
# JAX modules and names that are TPU or JAX mechanics, listed for the
# reader: none is exported by a JAX __init__
NOT_EXPORTED = ('data.mixture.pallas_synth_eligible',
                'data.specset.flat_freq_pad', 'data.specset.flat_row_align',
                'data.specset.normalize_flat_dtype',
                'train.optim.ScaleByKerasAdamState',
                'train.optim.ScaleByAdaBeliefState',
                'train.optim.KerasMomentumState',
                'train.optim.KerasRMSpropState',
                'train.optim.scale_by_keras_adam', 'interop.refstubs',
                'interop.keras_compat')
SUBPACKAGES = ['', 'cli', 'data', 'evaluate', 'interop', 'models', 'ops',
               'parallel', 'train', 'utils']


def _jax_exports(sub):
    """The public names a JAX ``__init__`` defines or imports."""
    path = os.path.join(os.path.dirname(challenge_tpu.__file__), sub,
                        '__init__.py')
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets
                      if isinstance(t, ast.Name)}
        elif isinstance(node, ast.FunctionDef):
            names.add(node.name)
    return {n for n in names if n == '__version__' or not n.startswith('_')}


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_every_jax_export_has_a_counterpart(sub):
    port = importlib.import_module(
        'challenge_tpu_torch' + ('.' + sub if sub else ''))
    skip = NO_COUNTERPART.get(sub, {})
    missing = sorted(n for n in _jax_exports(sub)
                     if n not in skip and not hasattr(port, n))
    assert not missing, f'{sub or "top level"}: {missing}'
    for n in skip:
        assert n in _jax_exports(sub) and not hasattr(port, n)
    if sub:
        assert set(getattr(port, '__all__', ())) <= set(dir(port))


def test_tpu_mechanics_are_not_ported():
    """The listed JAX-only mechanics exist in JAX and not in the port."""
    for dotted in NOT_EXPORTED:
        mod, _, name = dotted.rpartition('.')
        jax_mod = importlib.import_module('challenge_tpu.' + mod)
        if name in ('refstubs', 'keras_compat'):
            assert os.path.exists(os.path.join(
                os.path.dirname(jax_mod.__file__), name + '.py'))
            assert importlib.util.find_spec(
                f'challenge_tpu_torch.{mod}.{name}') is None
            continue
        assert hasattr(jax_mod, name), dotted
        port = importlib.import_module('challenge_tpu_torch.' + mod)
        assert not hasattr(port, name), dotted
    assert challenge_tpu_torch.__version__ == challenge_tpu.__version__
    assert challenge_tpu_torch.EPSILON == challenge_tpu.EPSILON
