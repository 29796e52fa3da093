"""The flat-complex synthesis of the port (challenge_tpu_torch/ops/synth.py
``synthesize_flat``, kernel mode B2) and the se v9 targets built on it
(data/mixture.py ``synthesize_se``, data/labels.py, FeatureFn's se branch)
against the JAX package, whose Pallas kernel runs in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernels are held against that plain version on the card by chip_smoke.py.

Tolerances, as for the magnitude mode (test_torch_synth.py,
test_torch_lowp_banks.py):
* the port equals a rounded ordered-sum numpy oracle bit for bit, in every
  bank dtype (a bfloat16 output is the float32 sum rounded once);
* against JAX's kernel: float32 at rtol 1e-5 / atol 1e-6, the bound of
  ROADMAP C1 (JAX's interpret mode contracts the sum into FMAs, and an
  FMA-emulating oracle equals it bit for bit); bfloat16 and int8 banks
  within one bfloat16 ulp of JAX's value (or 1e-6), as only those FMAs can
  move a float32 sum across a bfloat16 rounding boundary;
* labels exact.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    BATCH, N_FRAME, bank_case, numpy_ordered_sum, port_draws, small_sources,
    to_torch)
from challenge_tpu.config import Config as JConfig
from challenge_tpu.data.pipeline import build_banks as jax_build_banks
from challenge_tpu.ops.pallas_synth import synthesize_windows
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data import pipeline as port_pipeline
from challenge_tpu_torch.data.labels import speech_enhancement_preprocess
from challenge_tpu_torch.data.pipeline import FeatureFn, build_banks
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.ops.synth import (
    synthesize_flat, synthesize_flat_plain)

RTOL, ATOL = 1e-5, 1e-6
CASES = ['random', 'long_then_short', 'edges']
DTYPES = ['float32', 'bfloat16', 'int8']


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


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_flat_plain_matches_pallas_flat_mode(name, dtype):
    nf, a, _ = bank_case(name, dtype)
    ref = synthesize_windows(nf, **a, interpret=True)
    out = synthesize_flat_plain(nf, **to_torch(a))
    assert out.shape == ref.shape == (a['bidx'].shape[0], nf, 128)
    assert out.dtype == (torch.float32 if dtype == 'float32'
                         else torch.bfloat16)
    if dtype == 'float32':
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert ref.dtype == jax.numpy.bfloat16
        _within_one_bf16_ulp(out, ref)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_flat_plain_is_the_rounded_ordered_sum(name, dtype):
    """Bit for bit, the raw window; JAX's float32 window equals the
    FMA-contracted sum, so the FMAs are the whole gap between the two."""
    nf, a, oracle = bank_case(name, dtype)
    out = synthesize_flat_plain(nf, **to_torch(a))
    acc = torch.from_numpy(numpy_ordered_sum(nf, oracle, fma=False,
                                             magnitude=False))
    assert torch.equal(out, acc.to(out.dtype))
    if dtype == 'float32':
        ref = synthesize_windows(nf, **a, interpret=True)
        np.testing.assert_array_equal(
            np.asarray(ref),
            numpy_ordered_sum(nf, oracle, fma=True, magnitude=False))


def test_flat_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    nf, a, _ = bank_case('random', 'int8')
    t = to_torch(a)
    cuda.reset_launch_counts()
    assert torch.equal(synthesize_flat(nf, **t),
                       synthesize_flat_plain(nf, **t))
    assert sum(cuda.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match='bgscale is required iff'):
        synthesize_flat(nf, **{**t, 'bgscale': None})
    with pytest.raises(ValueError, match='unsupported device'):
        synthesize_flat(nf, **{k: v.to('meta') for k, v in t.items()})


# ------------------------------------------------------------ se targets
SE_CFG = dict(model_type='se', v=9, n_frame=N_FRAME, batch_size=BATCH)


def _jax_se(banks):
    """JAX's se v9 feature function (``make_feature_fn``) on one batch,
    with its kernel in interpret mode. Returns numpy copies of the
    ``sample_batch(..., seperate_noise_voice=True, layout='ftc')`` output
    ``(spec, (label, only_voice, only_noise))`` it consumed, its features
    ``(x, (labels, only_voice, only_noise))``, and the draws of the first
    (full-mix) kernel call."""
    import challenge_tpu.data.mixture as jmix
    import challenge_tpu.data.pipeline as jpipe
    import challenge_tpu.ops.pallas_synth as ps

    rec = {}

    def synth(n_frame, bgflat, bidx, boff, vflat, vidx, vshift, vw,
              nflat=None, nidx=None, nshift=None, nw=None, vlens=None,
              nlens=None, **kw):
        if 'draws' not in rec:
            rec['draws'] = dict(bidx=bidx, boff=boff, vidx=vidx,
                                vshift=vshift, vw=vw, nidx=nidx,
                                nshift=nshift, nw=nw, vlens=vlens,
                                nlens=nlens)
        return synthesize_windows(n_frame, bgflat, bidx, boff, vflat, vidx,
                                  vshift, vw, nflat, nidx, nshift, nw, vlens,
                                  nlens, interpret=True, **kw)

    def sample_batch(*a, **kw):
        # unjitted, so the recorded values are run()'s
        rec['batch'] = jmix.sample_batch.__wrapped__(*a, **kw)
        return rec['batch']

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, 'synthesize_windows', synth)
        mp.setattr(jpipe, 'sample_batch', sample_batch)
        fn = jpipe.make_feature_fn(JConfig(**SE_CFG), training=True,
                                   jit=False, use_pallas=True)

        @jax.jit
        def run(key, banks):
            return dict(rec, features=fn(key, banks))
        out = jax.device_get(run(jax.random.PRNGKey(8), banks))
    draws = {k: np.array(v) for k, v in out['draws'].items()}
    return out['batch'], out['features'], draws


@pytest.fixture(scope='module')
def sources():
    bgs, voices, labels, noises = small_sources(4)
    voices = [np.abs(v) for v in voices]      # energy in every voice frame
    return bgs, voices, labels, noises


@pytest.fixture(scope='module')
def jax_f32(sources):
    return _jax_se(jax_build_banks(*sources, n_frame=N_FRAME))


@pytest.fixture(scope='module', params=DTYPES)
def se_run(request, sources, jax_f32):
    """One bank dtype: the port's banks, and JAX's batch and features on
    its banks of that dtype. JAX's reduced-precision banks draw as its
    float32 banks do (the draws read only lengths), so the float32 run's
    draws serve all three."""
    dt = request.param
    batch, features, draws = jax_f32 if dt == 'float32' else _jax_se(
        jax_build_banks(*sources, n_frame=N_FRAME, flat_dtype=dt))
    for k in ('bidx', 'boff', 'vidx', 'vshift', 'nidx', 'nshift'):
        np.testing.assert_array_equal(draws[k], jax_f32[2][k])
    pb = build_banks(*sources, n_frame=N_FRAME, flat_dtype=dt, device='cpu')
    return dict(dtype=dt, batch=batch, features=features, pb=pb,
                draws=port_draws(jax_f32[2]))


def _close(mine, ref, dtype):
    if dtype == 'float32':
        np.testing.assert_allclose(mine.numpy(), ref, rtol=RTOL, atol=ATOL)
    else:
        assert mine.dtype == torch.bfloat16
        _within_one_bf16_ulp(mine, ref)


def test_synthesize_se_matches_jax_sample_batch(se_run):
    """The full mix, only_voice and only_noise of the port from JAX's
    draws against JAX's three kernel calls, and the labels exactly."""
    spec, (label, ov, on) = se_run['batch']
    assert se_run['pb'].backgrounds.chan == 4
    out, targets = mixture.synthesize_se(se_run['pb'], se_run['draws'])
    np.testing.assert_array_equal(targets[0].numpy(), label)
    assert label.sum() > 0
    for mine, ref in ((out, spec), (targets[1], ov), (targets[2], on)):
        assert mine.shape == ref.shape == (BATCH, 257, N_FRAME, 4)
        _close(mine, ref, se_run['dtype'])
    # only_voice holds the voices alone: zero where no voice lands
    voiced = label.sum(axis=(1, 3)) > 0                       # [B, T]
    assert (np.abs(_f32(targets[1])).max(axis=(1, 3))[~voiced] == 0).all()


def test_se_features_match_jax_feature_fn(se_run, monkeypatch):
    """FeatureFn's se v9 branch on JAX's draws against make_feature_fn's:
    the real half without the DC row [B, 256, T, 2], the 32x-downsampled
    frame labels, and the targets with channel 0 only [B, 256, T, 1] (the
    reference quirk)."""
    x, y = se_run['features']
    monkeypatch.setattr(port_pipeline, 'draw',
                        lambda *a, **kw: se_run['draws'])
    px, py = FeatureFn(Config(**SE_CFG), device='cpu')(None, se_run['pb'])
    assert px.shape == x.shape == (BATCH, 256, N_FRAME, 2)
    _close(px, x, se_run['dtype'])
    np.testing.assert_array_equal(py[0].numpy(), y[0])
    assert py[0].shape == (BATCH, N_FRAME // 32, 3) and py[0].dtype == \
        torch.float32
    for mine, ref in zip(py[1:], y[1:]):
        assert mine.shape == ref.shape == (BATCH, 256, N_FRAME, 1)
        _close(mine, ref, se_run['dtype'])


def test_quiet_voices_survive_in_only_voice():
    """only_voice is accumulated from zeros (reference pipeline.py:37,
    82-83): voices of about 1e-4 at snr -20 over backgrounds of 1e4 would
    cancel in float32 if it were taken as spec - background (mirrors
    tests/test_pipeline.py::test_sample_batch_se_targets_exact_at_low_snr,
    with the port's own draws)."""
    rng = np.random.default_rng(7)
    bgs = [np.full((257, 30, 4), 1e4, np.float32) for _ in range(2)]
    voices = [np.abs(rng.standard_normal((257, 8, 4))).astype(np.float32)
              * 1e-4 for _ in range(4)]
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=4)]
    banks = build_banks(bgs, voices, labels, n_frame=16, device='cpu')
    d = mixture.draw(torch.Generator().manual_seed(11), banks, 4, 16,
                     max_voices=3, max_noises=0, snr=-20.0)
    spec, (label, ov, on) = mixture.synthesize_se(banks, d)
    assert 0 < float(ov.max()) < 1e-3
    # in the full mix the voices vanish against the background in float32
    assert float(on.min()) == float(spec.max()) == 1e4
    voiced = label.sum(dim=(1, 3)) > 0                        # [B, T]
    assert voiced.any()
    assert (ov.abs().amax(dim=(1, 3))[~voiced] == 0).all()
    x, y = speech_enhancement_preprocess(spec, (label, ov, on))
    assert x.shape == (4, 256, 16, 2)
    assert y[1].shape == y[2].shape == (4, 256, 16, 1)
    np.testing.assert_array_equal(y[1].numpy(), ov[:, 1:, :, :1].numpy())

