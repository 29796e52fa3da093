"""The n_chan 1, 3 and > 3 configurations of the port: the channel maps
(challenge_tpu_torch/data/labels.py ``mono_chan``, ``stereo_mono``;
ops/augment.py ``random_merge_aug``, ``stft_filter_keep``), the complex
feature branch of data/pipeline.py ``FeatureFn`` (kernel B2, then masks,
map, filter, mel, minmax, log), and the eval chain's maps
(evaluate/infer.py), against the JAX package.

JAX's draws (taken at its interpret-mode kernel), masks and merge factors
are fed to the port. Tolerances:
* the maps on the same arrays: exact, except the merge's
  ``f * re0 + sqrt(1 - f) * re1`` at rtol 1e-6 (XLA may contract it into an
  FMA, ROADMAP C1);
* the complex branch, as test_torch_features.py holds the magnitude
  branch: the pre-log mel at rtol 1e-5 (atol 1e-7 for masked zeros), the
  log-mel by its mean abs error < 1e-5, labels exact. That holds for
  float32 banks, and for n_chan > 3 from any banks, since the merge
  promotes to float32 (measured: at most 2.0e-7 relative). From bfloat16
  and int8 banks with n_chan 1 and 3 the maps' sums and the magnitude stay
  in bfloat16, as JAX's dtypes say, one rounding after each op; XLA:CPU
  keeps a fused chain's intermediates in float32 instead (its
  excess-precision default), so the pre-log mel is held within 2^-7
  relative (two bfloat16 ulps) and the log-mel within JAX's own bound for
  bfloat16 features, atol 1.5e-2 with a mean below 1e-3
  (tests/test_pallas_synth.py:561-620). Measured: at most 3.8e-3
  relative, mean 7.0e-4; log-mel at most 5.1e-3, mean 2.9e-4;
* ``evaluate()``: grids and ERs identical to JAX's for n_chan 1 and 3, and
  for n_chan 4 with JAX's per-clip merge factors injected (the port draws
  its own from a generator seeded with the clip index, ROADMAP C).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _helpers import write_wav
from _torch_parity import (
    BATCH, N_FRAME, N_MELS, port_draws, small_sources, vad_variables)
from challenge_tpu.config import Config as JConfig
from challenge_tpu.data import labels as jlabels
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu.ops import augment as jaug
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data import labels, mixture
from challenge_tpu_torch.data.pipeline import (
    DevicePipeline, FeatureFn, build_banks)
from challenge_tpu_torch.evaluate import infer
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.ops import augment
from challenge_tpu_torch.train.loop import TrainLoop

CFG = dict(model_type='vad', v=9, n_mels=N_MELS, n_frame=N_FRAME,
           batch_size=BATCH)


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """Full-width models on torch's default thread count (every core)
    oversubscribe the CPU when the suite runs in several workers and slow
    the other test files (as in test_torch_se.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ the maps
@pytest.mark.parametrize('dtype', [np.float32, jnp.bfloat16])
def test_channel_maps_match_jax(dtype):
    """On [B, T, freq, 4] complex planes: mono_chan's 3-plane quirk (JAX's
    with labels; without, JAX's is the identity, which the port's eval
    keeps in channel_map), stereo_mono, the merge with JAX's
    per-sample factors (imaginary planes summed without the factor, the
    result promoted to float32), and the stft filter's rows."""
    rng = np.random.default_rng(1)
    x = np.asarray(rng.standard_normal((3, 5, 7, 4)), dtype)
    xt = torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)

    def same(out, ref, **tol):
        ref = np.asarray(ref)
        assert out.shape == ref.shape
        assert str(out.dtype)[len('torch.'):] == str(ref.dtype)
        np.testing.assert_allclose(out.float().numpy(),
                                   ref.astype(np.float32), **tol)

    mono = labels.mono_chan(xt)
    assert mono.shape[-1] == 3
    same(mono, jlabels.mono_chan(x, 'y')[0], rtol=0, atol=0)
    assert jlabels.mono_chan(x) is x       # eval: channel_map's identity
    same(labels.stereo_mono(xt), jlabels.stereo_mono(x), rtol=0, atol=0)
    key = jax.random.PRNGKey(3)
    ref = jaug.batch_random_merge_aug(5)(key, x)
    factors = jax.vmap(lambda k: jax.random.uniform(
        k, (1, 1, 3), minval=0.1, maxval=0.9))(jax.random.split(key, 3))
    out = augment.random_merge_aug(
        xt, torch.from_numpy(np.array(factors).reshape(3, 1, 1, 3)))
    assert out.dtype == torch.float32
    same(out, ref, rtol=1e-6, atol=0)
    keep = augment.stft_filter_keep(7, 3)
    same(xt * keep.to(xt.dtype)[:, None],
         jaug.stft_filter(3, freq_axis=-2)(x), rtol=0, atol=0)


def test_merge_factor_distribution():
    f = augment.merge_factors(torch.Generator().manual_seed(0), 4096, 5)
    assert f.shape == (4096, 3) and f.dtype == torch.float32
    assert 0.1 <= float(f.min()) < 0.11 and 0.89 < float(f.max()) <= 0.9
    assert abs(float(f.mean()) - 0.5) < 0.01


# ------------------------------------------------------ the complex branch
def _jax_complex(n_chan, jbanks, key, batch=None):
    """JAX's make_feature_fn for ``n_chan`` on one batch: the pre-log mel
    and the features, and the masks and merge factors its keys give. With
    ``batch`` (spec [B, T, freq, 4] 'tfc' and per-voice labels) it is fed
    that ``sample_batch`` output; else it synthesizes from ``jbanks`` with
    its kernel in interpret mode, and the draws at the kernel are recorded
    too."""
    import challenge_tpu.data.mixture as jmix
    import challenge_tpu.data.pipeline as jpipe
    import challenge_tpu.ops.pallas_synth as ps
    from challenge_tpu.ops.augment import batch_mask_keep
    rec = {}
    orig_synth, orig_minmax = ps.synthesize_windows, jpipe.minmax

    def synth(n_frame, bgflat, bidx, boff, vflat, vidx, vshift, vw, nflat,
              nidx, nshift, nw, vlens, nlens, **kw):
        rec.update(bidx=bidx, boff=boff, vidx=vidx, vshift=vshift, vw=vw,
                   nidx=nidx, nshift=nshift, nw=nw, vlens=vlens, nlens=nlens)
        return orig_synth(n_frame, bgflat, bidx, boff, vflat, vidx, vshift,
                          vw, nflat, nidx, nshift, nw, vlens, nlens,
                          interpret=True, **kw)

    def minmax(x):
        rec['mel_raw'] = x
        return orig_minmax(x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, 'synthesize_windows', synth)
        # unjitted, so the recorded values are run()'s
        mp.setattr(jpipe, 'sample_batch', jmix.sample_batch.__wrapped__
                   if batch is None else lambda *a, **kw: batch)
        mp.setattr(jpipe, 'minmax', minmax)
        fn = jpipe.make_feature_fn(JConfig(n_chan=n_chan, **CFG),
                                   training=True, jit=False, use_pallas=True,
                                   n_classes=3)

        @jax.jit
        def run(key, banks):
            return dict(rec, features=fn(key, banks))
        out = jax.device_get(run(key, jbanks))
    _, k_aug, k_chan = jax.random.split(key, 3)
    k_t, k_f = jax.random.split(k_aug)
    out['tmask'] = batch_mask_keep(k_t, BATCH, N_FRAME, 24, 6)
    out['fmask'] = batch_mask_keep(k_f, BATCH, 257, 16, 1)
    out['factors'] = jax.vmap(lambda k: jax.random.uniform(
        k, (1, 1, max(n_chan - 2, 1)), minval=0.1, maxval=0.9))(
            jax.random.split(k_chan, BATCH)).reshape(BATCH, -1)
    return {k: (v if k == 'features' else np.array(v))
            for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _sources():
    bgs, voices, labels_, noises = small_sources(4)
    return bgs, voices, labels_, [np.abs(n) for n in noises]


def _port(n_chan, flat, y, jax_out):
    """The port's complex branch on ``flat`` with JAX's masks and factors:
    (log-mel, labels, mel before minmax)."""
    fn = FeatureFn(Config(n_chan=n_chan, **CFG), device='cpu')
    masks = (torch.from_numpy(jax_out['tmask']),
             torch.from_numpy(jax_out['fmask']),
             torch.from_numpy(jax_out['factors']) if n_chan > 3 else None)
    x, y = fn.complex_features(flat, y, *masks)
    return x, y, fn.complex_mel(flat, *masks)


def _check(dtype, n_chan, x, y, mel_raw, jax_out):
    jx, jy = (np.asarray(a) for a in jax_out['features'])
    # n_chan 1 keeps 2 channels: the mono_chan quirk, as in JAX
    assert x.shape == jx.shape == (BATCH, N_MELS, N_FRAME, max(n_chan, 2))
    assert x.dtype == mel_raw.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), jy)
    assert jy.any()
    ref = jax_out['mel_raw']
    if dtype == 'float32' or n_chan > 3:
        np.testing.assert_allclose(mel_raw.numpy(), ref, rtol=1e-5,
                                   atol=1e-7)
        assert float(np.abs(x.numpy() - jx).mean()) < 1e-5
    else:
        gap = np.abs(mel_raw.numpy() - ref) / np.maximum(np.abs(ref), 1e-30)
        assert gap.max() < 2.0 ** -7, gap.max()
        err = np.abs(x.numpy() - jx)
        assert err.max() <= 1.5e-2 and err.mean() < 1e-3, (err.max(),
                                                            err.mean())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('n_chan', [1, 3, 4])
def test_complex_branch_matches_jax_feature_fn(n_chan, dtype):
    """The port's window (kernel B2's plain version, held against JAX's
    kernel in test_torch_synth_flat.py) and labels from its own draws go
    through both feature chains, in JAX's 'tfc' layout and B2's dtype."""
    pb = build_banks(*_sources(), n_frame=N_FRAME, flat_dtype=dtype,
                     device='cpu')
    d = mixture.draw(torch.Generator().manual_seed(n_chan), pb, BATCH,
                     N_FRAME, snr=-5.0)
    flat, y = mixture.synthesize_complex(pb, d)
    assert flat.dtype == (torch.float32 if dtype == 'float32'
                          else torch.bfloat16)
    spec = flat.float().reshape(BATCH, N_FRAME, 4, 257).transpose(2, 3)
    spec = jnp.asarray(spec.numpy(), jnp.float32 if dtype == 'float32'
                       else jnp.bfloat16)
    jax_out = _jax_complex(n_chan, None, jax.random.PRNGKey(12),
                           batch=(spec, jnp.asarray(y.numpy())))
    _check(dtype, n_chan, *_port(n_chan, flat, y, jax_out), jax_out)


def test_complex_branch_end_to_end_on_jax_draws():
    """JAX's whole n_chan 3 chain, its kernel in interpret mode, against
    the port's fed JAX's draws, masks and factors."""
    from challenge_tpu.data.pipeline import build_banks as jax_build_banks
    jax_out = _jax_complex(3, jax_build_banks(*_sources(), n_frame=N_FRAME),
                           jax.random.PRNGKey(12))
    pb = build_banks(*_sources(), n_frame=N_FRAME, device='cpu')
    flat, y = mixture.synthesize_complex(pb, port_draws(jax_out))
    _check('float32', 3, *_port(3, flat, y, jax_out), jax_out)


def test_n_chan_1_features_keep_two_channels_and_training_raises():
    """JAX's n_chan 1 features have 2 channels, and its 1-channel model
    refuses them (flax's ScopeParamShapeError): the JAX package cannot
    train n_chan 1. The port computes the same features and raises a
    ValueError that names the quirk, in the model and through fit."""
    import flax
    cfg = Config(n_chan=1, **CFG)
    banks = build_banks(*_sources(), n_frame=N_FRAME, device='cpu')
    x, y = FeatureFn(cfg, device='cpu')(torch.Generator().manual_seed(1),
                                        banks)
    assert x.shape == (BATCH, N_MELS, N_FRAME, 2)
    jm = JVADModel(v=9, base_fsize=8, td_dim=32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, N_MELS, N_FRAME, 1)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jm.apply(variables, x.numpy(), training=True,
                 mutable=['batch_stats'])
    bundle = get_model(cfg, device='cpu')
    with pytest.raises(ValueError, match='mono_chan'):
        bundle.module(x)
    loop = TrainLoop(bundle)
    with pytest.raises(ValueError, match='mono_chan'):
        loop.fit(DevicePipeline(banks, cfg, device='cpu'), epochs=1,
                 steps_per_epoch=1)


# ------------------------------------------------------------- evaluate()
@pytest.fixture(scope='module')
def dev_set(tmp_path_factory):
    """3 two-channel 16 kHz WAVs of 4-8 s with a tone on channel 0, and
    answers of a few events each (as test_torch_eval.py's)."""
    d = tmp_path_factory.mktemp('dev')
    answers = {}
    for i, secs in enumerate((4.0, 6.5, 8.0)):
        write_wav(d / f'clip{i}.wav', seconds=secs, seed=10 + i,
                  tone_hz=300 + 200 * i)
        answers[f'clip{i}'] = [[i % 3, 0.5, 1.5], [(i + 1) % 3, 2.0, 3.5]]
    with open(d / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': answers}, f)
    return d


def _record_grids(monkeypatch, module):
    grids = []
    orig = module.get_start_end_frame

    def rec(grid):
        grids.append(np.asarray(grid))
        return orig(grid)
    monkeypatch.setattr(module, 'get_start_end_frame', rec)
    return grids


@pytest.mark.parametrize('n_chan', [1, 3, 4])
def test_evaluate_grids_and_ers_equal_jax(dev_set, monkeypatch, n_chan):
    """vad v3 at base 8 and td_dim 32 on 32 mels, bridged weights, windows
    of 64 frames every 32. For n_chan 4 the port is given JAX's merge
    factor of each clip, ``fold_in(PRNGKey(0), i)``."""
    from challenge_tpu.evaluate import infer as jinfer
    cfg = dict(model_type='vad', v=3, n_mels=N_MELS, n_frame=N_FRAME,
               n_chan=n_chan)
    shape = (N_MELS, N_FRAME, n_chan)
    jm = JVADModel(v=3, base_fsize=8, td_dim=32)
    variables = vad_variables(jm, shape, seed=5)
    jgrids = _record_grids(monkeypatch, jinfer)
    jers = jinfer.evaluate(JConfig(**cfg), JBundle(jm, shape, JConfig(**cfg)),
                           variables, overlap_hop=32, eval_dir=str(dev_set))
    pm = VADModel(v=3, base_fsize=8, td_dim=32, n_mels=N_MELS, n_chan=n_chan)
    pm.load_state_dict(flax_to_state_dict(variables))

    def jax_factor(gen, b, number):
        key = jax.random.fold_in(jax.random.PRNGKey(0), gen.initial_seed())
        f = jax.random.uniform(key, (1, 1, number - 2), minval=0.1,
                               maxval=0.9)
        return torch.from_numpy(np.asarray(f).reshape(b, number - 2))
    monkeypatch.setattr(infer, 'merge_factors', jax_factor)
    grids = _record_grids(monkeypatch, infer)
    ers = infer.evaluate(Config(**cfg), pm, overlap_hop=32,
                         eval_dir=str(dev_set))
    assert len(grids) == len(jgrids) == 3
    for g, jg in zip(grids, jgrids):
        assert g.shape == jg.shape and g.shape[1] == 3
        np.testing.assert_array_equal(g, jg)
    assert any(g.any() for g in grids) and not all(g.all() for g in grids)
    assert ers == jers and all(np.isfinite(ers))


def test_eval_merge_is_fresh_per_clip_and_deterministic():
    """The port's own n_chan > 3 eval merge: a factor per clip index from a
    CPU generator, the same on every call and device."""
    spec = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (257, 9, 4)).astype(np.float32))
    cfg = Config(n_chan=4)
    a, b = (infer.channel_map(cfg, spec, i) for i in (0, 1))
    assert a.shape == (257, 9, 8) and not torch.equal(a, b)
    assert torch.equal(a, infer.channel_map(cfg, spec, 0))
    f = augment.merge_factors(torch.Generator().manual_seed(1), 1, 4)[0]
    torch.testing.assert_close(b, augment.random_merge_aug(spec, f),
                               rtol=0, atol=0)
    assert torch.equal(infer.channel_map(Config(n_chan=1), spec, 0), spec)
    assert infer.channel_map(Config(n_chan=3), spec, 0).shape[-1] == 6


def test_sj_train_then_eval_cli_v9_n_chan_3(tmp_path, monkeypatch):
    """The CLIs take --v 9 and --n_chan 3 with int8 banks: 3 epochs of 2
    steps on the CPU write the checkpoint trio (the eval callback fires at
    epoch 2), and the eval CLI scores the dev clip."""
    import sys

    from _helpers import DATA_FLAGS, make_datafiles
    from challenge_tpu_torch.cli import eval as eval_cli
    from challenge_tpu_torch.cli import sj_train
    monkeypatch.chdir(tmp_path)
    # no tensorboard writer: its import pulls in TensorFlow, if installed
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    make_datafiles(tmp_path)
    write_wav(tmp_path / 'clip01.wav', seconds=4.0, seed=1, tone_hz=440)
    with open(tmp_path / 'sample_answer.json', 'w') as f:
        json.dump({'task2_answer': {'clip01': [[0, 1.0, 2.0]]}}, f)
    run = sj_train.main(
        ['--model_type', 'vad', '--v', '9', '--n_chan', '3', '--n_frame',
         '64', '--n_mels', str(N_MELS), '--batch_size', '2', '--epochs', '3',
         '--steps_per_epoch', '2', '--bank_dtype', 'int8', '--datapath',
         str(tmp_path), '--device', 'cpu'] + DATA_FLAGS)
    assert 'chan3' in run
    for suffix in ('.h5', '_SWA.h5', '_sample.h5', '.csv'):
        assert (tmp_path / f'{run}{suffix}').exists(), suffix
    ers = eval_cli.main(['--name', run, '--p', '--device', 'cpu'])
    assert len(ers) == 1 and np.isfinite(ers[0])
