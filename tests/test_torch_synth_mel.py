"""The fused mel synthesis of the port (challenge_tpu_torch/ops/synth.py
``synthesize_mel``, kernel mode B4; data/mixture.py ``synthesize_mel``;
the ``fused_mel`` path of data/pipeline.py ``FeatureFn``) against the JAX
package, whose Pallas kernel runs in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernels are held against that plain version on the card by chip_smoke.py.

Tolerances:
* the plain version equals a rounded ordered-sum numpy oracle bit for bit,
  mel and min/max, in every bank dtype;
* against JAX's kernel: the pre-log mel and min/max at rtol 1e-5 (atol
  1e-7 for the masked zeros), in every bank dtype: JAX's interpret mode
  contracts the synthesis sums into FMAs (ROADMAP C1) and takes the mel
  GEMM in another order. Measured on these cases: at most 3.5e-7 relative on the
  mel and 1.5e-7 on the min and max;
* the fused FeatureFn against the unfused one on the same generator state
  (the same draws and masks), as JAX's own tests hold its fused path
  (tests/test_pallas_synth.py:512-620): float32 log-mel at rtol 1e-4 /
  atol 1e-5; bfloat16 and int8 banks at atol 1.5e-2 with a mean below
  1e-3, since the unfused path rounds the magnitude to bfloat16 and the
  fused one does not; labels exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    bank_case, numpy_ordered_sum, small_sources, synth_case, to_torch)
from challenge_tpu.ops.pallas_synth import synthesize_windows
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data.pipeline import FeatureFn, build_banks
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.ops.mel import mel_filterbank
from challenge_tpu_torch.ops.synth import (
    mel_band, synthesize_mel, synthesize_mel_plain)

CASES = ['random', 'long_then_short', 'edges']
DTYPES = ['float32', 'bfloat16', 'int8']
FREQ, N_MELS = 32, 8          # the cases' flat width 128 is 4 planes of 32


def _masks(b, nf, seed, zero_sample=False):
    """{0,1} float32 time masks [B, nf] and column masks [B, 2 * FREQ];
    ``zero_sample`` masks every frame of sample 0."""
    rng = np.random.default_rng(seed)
    tmask = (rng.random((b, nf)) > 0.2).astype(np.float32)
    fmask = (rng.random((b, 2 * FREQ)) > 0.2).astype(np.float32)
    if zero_sample:
        tmask[0] = 0.0
    return tmask, fmask


def _melm():
    return mel_filterbank(N_MELS, FREQ)


def _jax_mel(nf, a, tmask, fmask):
    """JAX's kernel in mel mode: the block-diagonal [2 FREQ, 2 N_MELS]
    matrix (row c * FREQ + f -> column m * 2 + c), then the mel reshaped to
    the port's [B, N_MELS, nf, 2] and mm's lanes 0 and 1."""
    big = np.zeros((2 * FREQ, N_MELS, 2), np.float32)
    for c in range(2):
        big[c * FREQ:(c + 1) * FREQ, :, c] = _melm()
    mel, mm = synthesize_windows(
        nf, **a, mel=(big.reshape(2 * FREQ, -1), tmask.T, fmask),
        interpret=True)
    mel = np.asarray(mel).reshape(-1, nf, N_MELS, 2).transpose(0, 2, 1, 3)
    return mel, np.asarray(mm)[:, 0, :2]


def _oracle(nf, oracle, tmask, fmask):
    """The kernel's function in numpy float32, every product and sum
    rounded, the mel sum over the nonzero rows in increasing order."""
    mag = numpy_ordered_sum(nf, oracle, fma=False) * fmask[:, None, :]
    x = mag.reshape(mag.shape[0], nf, 2, FREQ)
    m = _melm()
    mel = np.zeros(x.shape[:3] + (N_MELS,), np.float32)
    for f in np.flatnonzero(m.any(axis=1)):
        mel = mel + x[..., f, None] * m[f]
    mel = (mel * tmask[:, :, None, None]).transpose(0, 3, 1, 2)
    return mel, np.stack([mel.min(axis=(1, 2, 3)),
                          mel.max(axis=(1, 2, 3))], 1)


def _port(nf, a, tmask, fmask):
    mel, mm = synthesize_mel_plain(
        nf, **to_torch(a), melm=torch.from_numpy(_melm()),
        tmask=torch.from_numpy(tmask), fmask=torch.from_numpy(fmask))
    return mel.numpy(), mm.numpy()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_mel_plain_is_the_rounded_ordered_sum(name, dtype):
    nf, a, oracle = bank_case(name, dtype)
    b = a['bidx'].shape[0]
    tmask, fmask = _masks(b, nf, 1, zero_sample=True)
    mel, mm = _port(nf, a, tmask, fmask)
    ref_mel, ref_mm = _oracle(nf, oracle, tmask, fmask)
    assert mel.shape == (b, N_MELS, nf, 2) and mel.dtype == np.float32
    np.testing.assert_array_equal(mel, ref_mel)
    np.testing.assert_array_equal(mm, ref_mm)
    # the sample whose frames are all masked: min = max = 0
    assert mm[0].tolist() == [0.0, 0.0] and (mel[1:] > 0).any()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_mel_plain_matches_pallas_mel_mode(name, dtype):
    nf, a, _ = bank_case(name, dtype)
    tmask, fmask = _masks(a['bidx'].shape[0], nf, 2)
    ref_mel, ref_mm = _jax_mel(nf, a, tmask, fmask)
    mel, mm = _port(nf, a, tmask, fmask)
    assert mel.shape == ref_mel.shape
    np.testing.assert_allclose(mel, ref_mel, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mm, ref_mm, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('masks', ['eval', 'filter', 'batch1'])
def test_mel_plain_edges_match_pallas(masks):
    """Eval masks (all ones), the stft filter's column zeros in the column
    mask, and batch 1, the edge of JAX's software-pipelined grid
    (tests/test_pallas_synth.py:623)."""
    nf, a, _ = bank_case('random', 'float32')
    if masks == 'batch1':
        a = {k: (v[:1] if k not in ('bgbank', 'vbank', 'nbank') else v)
             for k, v in a.items()}
    b = a['bidx'].shape[0]
    tmask, fmask = _masks(b, nf, 3)
    if masks != 'batch1':
        tmask, fmask = np.ones_like(tmask), np.ones_like(fmask)
    if masks == 'filter':
        keep = np.ones(FREQ, np.float32)
        keep[1:4] = 0.0
        fmask = fmask * np.tile(keep, 2)
    ref_mel, ref_mm = _jax_mel(nf, a, tmask, fmask)
    mel, mm = _port(nf, a, tmask, fmask)
    assert mel.shape == (b, N_MELS, nf, 2)
    np.testing.assert_allclose(mel, ref_mel, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mm, ref_mm, rtol=1e-5, atol=1e-7)


def test_mel_band_is_the_nonzero_pattern():
    """For the 80-bin filterbank the band is rows 4-121 with 232 entries,
    at most 2 nonzeros a row and 6 a bin; rows ascend within each bin."""
    m = torch.from_numpy(mel_filterbank(80, 257))
    band = mel_band(m)
    assert (band.f_lo, band.n_f, band.row.numel()) == (4, 118, 232)
    assert band.rows == tuple(range(4, 122))
    off, row, w = band.off.numpy(), band.row.numpy(), band.w.numpy()
    assert off[0] == 0 and off[-1] == 232 and np.diff(off).max() == 6
    dense = np.zeros((257, 80), np.float32)
    for j in range(80):
        seg = row[off[j]:off[j + 1]]
        assert (np.diff(seg) > 0).all()
        dense[seg, j] = w[off[j]:off[j + 1]]
    np.testing.assert_array_equal(dense, m.numpy())
    with pytest.raises(ValueError, match='>= 0'):
        mel_band(-m)


def test_mel_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    nf, a, _ = bank_case('edges', 'int8')
    t = to_torch(a)
    tmask, fmask = (torch.from_numpy(m) for m in _masks(3, nf, 4))
    kw = dict(melm=torch.from_numpy(_melm()), tmask=tmask, fmask=fmask)
    cuda.reset_launch_counts()
    mel, mm = synthesize_mel(nf, **t, **kw)
    ref = synthesize_mel_plain(nf, **t, **kw)
    assert torch.equal(mel, ref[0]) and torch.equal(mm, ref[1])
    assert sum(cuda.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match='needs melm, tmask and fmask'):
        synthesize_mel(nf, **t)
    with pytest.raises(ValueError, match='bgscale is required iff'):
        synthesize_mel(nf, **{**t, 'bgscale': None}, **kw)
    with pytest.raises(ValueError, match='unsupported device'):
        synthesize_mel(nf, **{k: v.to('meta') for k, v in t.items()}, **kw)
    band = mel_band(kw['melm'])
    assert torch.equal(synthesize_mel(nf, **t, **kw, band=band)[0], mel)


# ------------------------------------------------- the fused FeatureFn path
CFG = dict(model_type='vad', v=9, n_mels=32, n_frame=64, batch_size=4)


@pytest.fixture(scope='module')
def banks():
    return {dt: build_banks(*small_sources(2), n_frame=64, flat_dtype=dt,
                            device='cpu') for dt in DTYPES}


def _both(cfg, banks, training, seed=3):
    """The unfused and the fused FeatureFn on one generator state."""
    out = [FeatureFn(cfg, training, device='cpu', fused_mel=fused)(
        torch.Generator().manual_seed(seed), banks) for fused in (False, True)]
    return out[0], out[1]


@pytest.mark.parametrize('name,training', [('', True), ('filter', True),
                                           ('', False)])
def test_fused_mel_features_match_unfused_float32(banks, name, training):
    (xu, yu), (xf, yf) = _both(Config(name=name, **CFG), banks['float32'],
                               training)
    assert xf.shape == xu.shape == (4, 32, 64, 2) and xf.dtype == torch.float32
    np.testing.assert_allclose(xf.numpy(), xu.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(yf.numpy(), yu.numpy())


@pytest.mark.parametrize('dtype', ['bfloat16', 'int8'])
def test_fused_mel_features_reduced_precision_banks(banks, dtype):
    (xu, yu), (xf, yf) = _both(Config(**CFG), banks[dtype], True)
    assert xf.dtype == torch.float32
    gap = (xf - xu).abs()
    assert float(gap.max()) <= 1.5e-2 and float(gap.mean()) < 1e-3
    np.testing.assert_array_equal(yf.numpy(), yu.numpy())


def test_fused_mel_batch_one_and_masks_reach_the_kernel(banks, monkeypatch):
    """Batch 1; and the kernel's inputs: the training masks of the unfused
    path (time [B, T]; frequency tiled over both channels and times the
    filter columns for runs named 'filter')."""
    cfg = Config(name='filter', **dict(CFG, batch_size=1))
    (xu, yu), (xf, yf) = _both(cfg, banks['float32'], True, seed=5)
    assert xf.shape == (1, 32, 64, 2)
    np.testing.assert_allclose(xf.numpy(), xu.numpy(), rtol=1e-4, atol=1e-5)
    seen = {}
    orig = mixture.synth.synthesize_mel

    def spy(*a, **kw):
        seen.update(kw)
        return orig(*a, **kw)
    monkeypatch.setattr(mixture.synth, 'synthesize_mel', spy)
    fn = FeatureFn(cfg, device='cpu', fused_mel=True)
    gen = torch.Generator().manual_seed(5)
    fn(gen, banks['float32'])
    gen.manual_seed(5)
    mixture.draw(gen, banks['float32'], 1, 64)
    tmask, fmask = fn.masks(gen)
    assert torch.equal(seen['tmask'], tmask)
    assert torch.equal(seen['fmask'], fmask.repeat(1, 2) * fn.filter_cols)
    assert (seen['fmask'][0, 1:4] == 0).all()                # rows 1..3
    assert (seen['fmask'][0, 258:261] == 0).all()


def test_fused_mel_requires_the_n_chan_2_vad_configuration():
    for cfg in (dict(n_chan=3), dict(model_type='se', v=9)):
        with pytest.raises(ValueError, match='fused_mel requires'):
            FeatureFn(Config(**{**CFG, **cfg}), device='cpu', fused_mel=True)


def test_feature_fn_fused_mel_is_off_by_default():
    assert not FeatureFn(Config(**CFG), device='cpu').fused_mel


def test_jax_fused_mel_feature_fn_matches_port_on_its_draws():
    """JAX's make_feature_fn(fused_mel=True) on one batch, its kernel in
    interpret mode, against the port's fused FeatureFn fed JAX's draws and
    masks: the log-mel as the unfused comparison holds it (mean abs error,
    test_torch_features.py), labels exact."""
    import challenge_tpu.data.mixture as jmix
    import challenge_tpu.data.pipeline as jpipe
    import challenge_tpu.ops.pallas_synth as ps
    from challenge_tpu.config import Config as JConfig
    from challenge_tpu.ops.augment import batch_mask_keep
    rec = {}

    def synth(n_frame, bgflat, bidx, boff, vflat, vidx, vshift, vw, nflat,
              nidx, nshift, nw, vlens, nlens, **kw):
        rec.update(bidx=bidx, boff=boff, vidx=vidx, vshift=vshift, vw=vw,
                   nidx=nidx, nshift=nshift, nw=nw, vlens=vlens, nlens=nlens)
        return synthesize_windows(n_frame, bgflat, bidx, boff, vflat, vidx,
                                  vshift, vw, nflat, nidx, nshift, nw, vlens,
                                  nlens, interpret=True, **kw)
    src = small_sources(2)
    jbanks = jpipe.build_banks(*src, n_frame=64)
    key = jax.random.PRNGKey(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, 'synthesize_windows', synth)
        # unjitted, so the recorded values are run()'s
        mp.setattr(jpipe, 'sample_batch', jmix.sample_batch.__wrapped__)
        fn = jpipe.make_feature_fn(JConfig(**CFG), training=True, jit=False,
                                   use_pallas=True, fused_mel=True)

        @jax.jit
        def run(key, banks):
            return dict(rec, features=fn(key, banks))
        out = jax.device_get(run(key, jbanks))
    _, k_aug, _ = jax.random.split(key, 3)
    k_t, k_f = jax.random.split(k_aug)
    tmask = np.asarray(batch_mask_keep(k_t, 4, 64, 24, 6))
    fmask = np.asarray(batch_mask_keep(k_f, 4, 257, 16, 1))
    from _torch_parity import port_draws
    draws = port_draws({k: np.asarray(v) for k, v in out.items()
                        if k != 'features'}, n_frame=64)
    pb = build_banks(*src, n_frame=64, device='cpu')
    port = FeatureFn(Config(**CFG), device='cpu', fused_mel=True)
    (mel, mm), y = mixture.synthesize_mel(
        pb, draws, port.melm, torch.from_numpy(tmask),
        torch.from_numpy(np.tile(fmask, 2)))
    x, y = port.fused_features(mel, mm, y)
    jx, jy = out['features']
    assert x.shape == jx.shape == (4, 32, 64, 2)
    assert float((x - torch.from_numpy(np.asarray(jx))).abs().mean()) < 1e-5
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert np.asarray(jy).any()
