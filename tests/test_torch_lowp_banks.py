"""Reduced-precision spec banks of the port (``--bank_dtype bfloat16|int8``:
challenge_tpu_torch/data/specset.py, mixture.py, ops/synth.py in its B3
mode, FeatureFn) against the JAX package.

Both packages get the same numpy-made sources, with one all-zero voice
(its int8 scale is 1.0) and one background shorter than the window (the
wrapped bank). JAX's draws are recorded on its float32 banks, which draw
exactly as its reduced-precision banks do (the draws read only lengths).

Tolerances:
* banks: bit for bit once JAX's padding is stripped (the same numpy
  quantization; bfloat16 rounding to nearest even on both sides);
* synthesis: within one bfloat16 ulp of JAX's interpret-mode kernel, rtol
  2**-8 / atol 1e-6. Both upcast and sum in float32 in the same order; only
  JAX's FMA contraction on the CPU (ROADMAP C1) can move a float32 value
  across a bfloat16 rounding boundary. The port equals a rounded
  ordered-sum numpy oracle exactly;
* labels: exact, and equal to the float32 banks' labels;
* log-mel: the port's chain against JAX's on the same bfloat16 magnitude,
  draws and masks, mean abs < 1e-5 (the float32 chain's bound,
  test_torch_features.py); and the port's int8 and bfloat16 features
  against its float32 ones below the JAX package's own recorded errors,
  6.59e-3 and 1.37e-3 mean abs (BENCH_r05).
"""

import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    BATCH, N_FRAME, N_MELS, jax_draws, jax_features, numpy_ordered_sum,
    port_draws, small_sources, strip_flat)
from challenge_tpu.config import Config as JConfig
from challenge_tpu.data.pipeline import build_banks as jax_build_banks
from challenge_tpu.ops.pallas_synth import synthesize_windows
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data.pipeline import FeatureFn, build_banks
from challenge_tpu_torch.data.specset import build_bank

CFG = dict(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
           batch_size=BATCH)
BF16_ULP = 2.0 ** -8
JAX_RECORDED_ERR = {'int8': 6.59e-3, 'bfloat16': 1.37e-3}   # BENCH_r05


def _f32(x):
    """numpy float32 copy of a JAX (possibly bfloat16) or torch array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.fixture(scope='module')
def sources():
    bgs, voices, labels, noises = small_sources(0)
    voices[2] = np.zeros_like(voices[2])        # an all-zero item
    return bgs, voices, labels, noises


@pytest.fixture(scope='module')
def draws(sources):
    """JAX's draws and labels for one batch, on its float32 banks."""
    return jax_draws(jax_build_banks(*sources, n_frame=N_FRAME),
                     jax.random.PRNGKey(3))


@pytest.fixture(scope='module')
def f32_port(sources, draws):
    banks = build_banks(*sources, n_frame=N_FRAME, device='cpu')
    return mixture.synthesize(banks, port_draws(draws))


@pytest.fixture(scope='module', params=['bfloat16', 'int8'])
def lowp(request, sources, draws):
    """One bank dtype: JAX's and the port's banks, the weights and
    background scales as sample_batch folds them for the JAX kernel, and
    the port's synthesize on JAX's draws."""
    dt = request.param
    jb = jax_build_banks(*sources, n_frame=N_FRAME, flat_dtype=dt)
    pb = build_banks(*sources, n_frame=N_FRAME, flat_dtype=dt, device='cpu')
    d = draws
    vw, nw, bgscale = d['vw'], d['nw'], None
    if dt == 'int8':
        vw = vw * np.asarray(jb.voices.flat_scale)[d['vidx']]
        nw = nw * np.asarray(jb.noises.flat_scale)[d['nidx']]
        bgscale = np.asarray(jb.backgrounds.flat_scale)[d['bidx']]
    mag, label = mixture.synthesize(pb, port_draws(d))
    return dict(dtype=dt, jb=jb, pb=pb, mag=mag, label=label,
                folded=(vw, nw, bgscale))


@pytest.fixture(scope='module')
def jmag(lowp, draws):
    """The JAX Pallas kernel (interpret mode) on the same banks and
    draws: [B, n_frame, 2 * f_r] bfloat16."""
    d, jb = draws, lowp['jb']
    vw, nw, bgscale = lowp['folded']
    return np.asarray(synthesize_windows(
        N_FRAME, jb.backgrounds.flat, d['bidx'], d['boff'],
        jb.voices.flat, d['vidx'], d['vshift'], vw,
        jb.noises.flat, d['nidx'], d['nshift'], nw,
        d['vlens'], d['nlens'], magnitude=True, interpret=True,
        bgscale=bgscale))


@pytest.fixture(scope='module')
def jrec(jmag, draws):
    """JAX's feature chain on its kernel's bfloat16 magnitude: the
    features and the SpecAugment masks it draws."""
    return jax_features(JConfig(**CFG), jmag, draws['label'],
                        jax.random.PRNGKey(5))


@pytest.mark.parametrize('which', ['backgrounds', 'voices', 'noises'])
def test_banks_equal_jax_without_padding(lowp, which):
    jb, pb = getattr(lowp['jb'], which), getattr(lowp['pb'], which)
    assert pb.flat.dtype == {'int8': torch.int8,
                             'bfloat16': torch.bfloat16}[lowp['dtype']]
    np.testing.assert_array_equal(pb.lens.numpy(), np.asarray(jb.lens))
    # pos_mask comes from the float32 frames, as in JAX
    np.testing.assert_array_equal(pb.pos_mask.numpy(),
                                  np.asarray(jb.pos_mask))
    assert pb.contig_exact_frames == jb.contig_exact_frames
    rows = pb.flat.shape[1]
    np.testing.assert_array_equal(
        _f32(pb.flat), strip_flat(_f32(jb.flat)[:, :rows], 4, 257))
    if lowp['dtype'] == 'int8':
        np.testing.assert_array_equal(pb.flat_scale.numpy(),
                                      np.asarray(jb.flat_scale))
        if which == 'voices':
            assert pb.flat_scale[2] == 1.0      # the all-zero item
            assert not pb.flat[2].any()
        if which == 'backgrounds':
            assert pb.contig_exact_frames == N_FRAME    # wrapped bank
    else:
        assert pb.flat_scale is None and jb.flat_scale is None


def test_int8_quantization_is_symmetric_max_abs():
    """scale = peak / 127 per item, values clip(round(x / scale)); the
    peak element maps to +-127 and the dequantized bank is within half a
    step of the float32 one."""
    rng = np.random.default_rng(2)
    specs = [rng.standard_normal((257, t, 4)).astype(np.float32) * s
             for t, s in ((9, 1.0), (5, 3.0))]
    bank = build_bank(specs, flat_dtype='int8', device='cpu')
    f32 = build_bank(specs, device='cpu').flat.numpy()
    q, scale = bank.flat.numpy().astype(np.float32), bank.flat_scale.numpy()
    for i in range(2):
        assert np.abs(q[i]).max() == 127
        assert scale[i] == np.float32(np.abs(f32[i]).max() / 127.0)
    err = np.abs(q * scale[:, None, None] - f32)
    assert err.max() <= 0.5 * scale.max() * (1 + 1e-6)
    with pytest.raises(ValueError, match='float32, bfloat16 or int8'):
        build_bank(specs, flat_dtype='float16', device='cpu')


def test_synthesis_within_one_bf16_ulp_of_jax_kernel(lowp, jmag):
    ref = strip_flat(_f32(jmag), 2, 257)
    assert jmag.dtype == jax.numpy.bfloat16
    assert lowp['mag'].dtype == torch.bfloat16
    assert lowp['mag'].shape == ref.shape == (BATCH, N_FRAME, 2 * 257)
    np.testing.assert_allclose(_f32(lowp['mag']), ref, rtol=BF16_ULP,
                               atol=1e-6)


def test_synthesis_is_the_rounded_ordered_sum(lowp, draws):
    """Bit for bit: the upcast banks (int8 backgrounds times their scale,
    as the kernel's first multiply), the folded weights, the ordered
    rounded float32 sum, the IEEE root, one rounding to bfloat16."""
    pb = lowp['pb']
    vw, nw, bgscale = lowp['folded']
    bg = _f32(pb.backgrounds.flat)
    if bgscale is not None:
        bg = bg * pb.backgrounds.flat_scale.numpy()[:, None, None]
    a = dict(bgbank=bg, bidx=draws['bidx'], boff=draws['boff'],
             vbank=_f32(pb.voices.flat), vidx=draws['vidx'],
             vshift=draws['vshift'], vw=vw, vlens=draws['vlens'],
             nbank=_f32(pb.noises.flat), nidx=draws['nidx'],
             nshift=draws['nshift'], nw=nw, nlens=draws['nlens'])
    oracle = torch.from_numpy(numpy_ordered_sum(N_FRAME, a, fma=False))
    assert torch.equal(lowp['mag'], oracle.to(torch.bfloat16))


def test_labels_equal_the_float32_banks_labels(lowp, draws, f32_port):
    np.testing.assert_array_equal(lowp['label'].numpy(), draws['label'])
    assert torch.equal(lowp['label'], f32_port[1])


def test_logmel_matches_jax_chain_on_the_same_bf16_magnitude(jmag, jrec,
                                                            draws):
    """JAX's bfloat16 kernel output through both feature chains, with the
    masks JAX's chain draws."""
    rec = jrec
    mag = torch.from_numpy(strip_flat(_f32(jmag), 2, 257))
    x, y = FeatureFn(Config(**CFG), device='cpu').features(
        mag.to(torch.bfloat16), torch.from_numpy(draws['label']),
        torch.from_numpy(rec['tmask']), torch.from_numpy(rec['fmask']))
    assert x.dtype == torch.float32
    assert np.abs(x.numpy() - rec['x']).mean() < 1e-5
    np.testing.assert_array_equal(y.numpy(), rec['y'])


def test_logmel_error_against_f32_below_jax_recorded(lowp, draws, f32_port,
                                                     jrec):
    fn = FeatureFn(Config(**CFG), device='cpu')
    tmask = torch.from_numpy(jrec['tmask'])
    fmask = torch.from_numpy(jrec['fmask'])
    label = torch.from_numpy(draws['label'])
    x32, _ = fn.features(f32_port[0], label, tmask, fmask)
    xq, _ = fn.features(lowp['mag'], label, tmask, fmask)
    err = float((xq - x32).abs().mean())
    assert 0 < err < JAX_RECORDED_ERR[lowp['dtype']], err


def test_wrapper_takes_bgscale_iff_the_banks_are_int8(lowp, draws):
    from challenge_tpu_torch.ops.synth import synthesize_magnitude
    args = list(mixture.synth_args(lowp['pb'], port_draws(draws)))
    assert (args[-1] is not None) == (lowp['dtype'] == 'int8')
    args[-1] = None if args[-1] is not None else torch.ones(BATCH)
    with pytest.raises(ValueError, match='bgscale is required iff'):
        synthesize_magnitude(*args)


@pytest.mark.slow
def test_trained_er_int8_matches_f32(tmp_path):
    """The int8 accuracy story at the challenge-ER level (port of
    tests/test_train.py::test_trained_er_int8_slim_matches_f32): training
    from int8 banks reaches the same trained dev ER as training from
    float32 banks, the mean within one dev-set ER quantum (0.09, as in
    JAX). Same corpus, loop seed and batch draws; the only difference is
    the int8 quantization noise of the features. Per clip the bound is two
    events of that clip (2 / its event count): on this corpus the trained
    ER of either package moves by one or two events a clip with the loop
    seed, so quantization noise can flip as much."""
    from test_train import _trained_er_corpus

    from challenge_tpu_torch.evaluate.infer import evaluate
    from challenge_tpu_torch.models.registry import get_model
    from challenge_tpu_torch.train.loop import TrainLoop

    n_frame = 128
    bgs, voices, onehot = _trained_er_corpus(tmp_path, n_frame=n_frame)
    cfg = Config(model_type='vad', v=3, n_mels=40, n_frame=n_frame,
                 n_chan=2, batch_size=8, snr=-2, max_voices=3, lr=1e-3)

    def train_and_score(dtype):
        banks = build_banks(bgs, voices, onehot, n_frame=n_frame,
                            flat_dtype=dtype, device='cpu')
        loop = TrainLoop(get_model(cfg, device='cpu'), seed=0, banks=banks,
                         val_banks=banks)
        hist = loop.fit(epochs=14, steps_per_epoch=25, validation_steps=1,
                        verbose=0)
        return hist, evaluate(cfg, loop.state.module, overlap_hop=32,
                              eval_dir=str(tmp_path))

    hist32, er32 = train_and_score('float32')
    hist_q, er_q = train_and_score('int8')
    for hist in (hist32, hist_q):
        assert hist[-1]['f1_score'] > 0.4, hist[-1]
        assert hist[-1]['loss'] < 0.6 * hist[0]['loss'], (hist[0], hist[-1])
    assert np.isfinite(er32).all() and np.isfinite(er_q).all(), (er32, er_q)
    print('trained ER f32:', er32, 'int8:', er_q)
    assert abs(float(np.mean(er_q)) - float(np.mean(er32))) <= 0.09, \
        (er32, er_q)
    with open(tmp_path / 'sample_answer.json') as f:
        answers = json.load(f)['task2_answer']
    n_events = [len(answers[k]) for k in sorted(answers)]
    for a, b, n in zip(er32, er_q, n_events):
        assert abs(a - b) <= 2 / n + 1e-9, (er32, er_q, n_events)

