"""The port's evaluation chain (challenge_tpu_torch/ops/dsp.py, ops/mel.py,
evaluate/infer.py, evaluate/events.py) against the JAX package.

Tolerances:
* WAV reading: exact (the same numpy decode);
* resampling and the STFT: max abs <= 1e-5 x the output's peak. Both are
  float32 sums of the same products (13 to 37 resampling taps, 512 DFT
  terms) in another order;
* the smoothing pools: the average pool at rtol 1e-6 (a float32 sum of 31
  terms over a count), the max pool exactly;
* events and ER: exact (a verbatim copy), with the reference's golden 1.2;
* ``evaluate()``: the 0/1 frame grids and the per-clip ERs identical to
  JAX's on the same WAVs with bridged weights. A frame flips only if its
  smoothed score lies within float32 noise of 0.5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _helpers import write_wav
from _torch_parity import N_FRAME, N_MELS, vad_variables
from challenge_tpu.config import Config as JConfig
from challenge_tpu.evaluate import events as jevents
from challenge_tpu.evaluate import infer as jinfer
from challenge_tpu.models.layers import avg_pool_same as jax_avg_pool_same
from challenge_tpu.models.registry import ModelBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu.ops import dsp as jdsp
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.evaluate import events, infer
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.layers import avg_pool_same
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.ops import dsp


def _peak_close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max()


@pytest.fixture(scope='module')
def wav48(tmp_path_factory):
    path = tmp_path_factory.mktemp('dsp') / 'x.wav'
    write_wav(path, seconds=1.0, sr=48000, seed=2, tone_hz=300)
    return str(path)


def test_read_wav_equals_jax(wav48):
    (a, ra), (b, rb) = dsp.read_wav(wav48), jdsp.read_wav(wav48)
    assert ra == rb == 48000
    np.testing.assert_array_equal(a, b)
    (a, _), (b, _) = dsp.read_wav_raw(wav48), jdsp.read_wav_raw(wav48)
    assert a.dtype == np.int16
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('orig', [16000, 48000])
def test_resample_matches_jax(wav48, orig):
    """48 kHz -> 16 kHz, and 16 kHz -> 16 kHz, which is not the identity
    (the 0.99-Nyquist lowpass)."""
    wav, _ = jdsp.read_wav(wav48)
    out = dsp.resample_waveform(torch.from_numpy(wav), orig, 16000)
    ref = jdsp.resample_waveform(wav, orig, 16000)
    assert out.shape[-1] == -(-wav.shape[-1] * 16000 // orig)
    _peak_close(out.numpy(), ref)
    if orig == 16000:
        assert np.abs(out.numpy() - wav).max() > 1e-3


def test_stft_and_wav_to_spec_match_jax(wav48):
    raw, rate = jdsp.read_wav_raw(wav48)
    wav = raw[:, :7000].astype(np.float32) / 32768.0
    re, im = dsp.stft(torch.from_numpy(wav))
    jre, jim = jdsp.stft(wav)
    assert re.shape == (2, 257, 7000 // 256 + 1)
    _peak_close(re.numpy(), jre)
    _peak_close(im.numpy(), jim)
    spec = dsp.wav_to_spec(torch.from_numpy(raw), rate)
    _peak_close(spec.numpy(), jdsp.wav_to_spec(jnp.asarray(raw), rate))
    assert spec.shape[-1] == 4


def test_get_er_golden_and_random_grids():
    """The reference's golden case gives 1.2, and the port's event chain
    equals JAX's on random grids."""
    gt = np.array([[0, 0, 10], [2, 0, 20], [1, 15, 30], [2, 31, 40],
                   [1, 32, 35]])
    predict = np.array([[1, 5], [1, 19], [2, 32], [2, 38], [0, 38]])
    assert events.get_er(gt, predict) == pytest.approx(1.2)
    rng = np.random.default_rng(3)
    to_metric = events.output_to_metric(256, 16000)
    jto_metric = jevents.output_to_metric(256, 16000)
    for _ in range(5):
        grid = (rng.random((600, 3)) < 0.01).cumsum(0) % 2
        gt = np.stack([rng.integers(0, 3, 6), rng.integers(0, 5, 6),
                       rng.integers(5, 10, 6)], axis=1)
        pred = to_metric(*events.get_start_end_frame(grid))
        np.testing.assert_array_equal(
            pred, jto_metric(*jevents.get_start_end_frame(grid)))
        assert events.get_er(gt, pred) == jevents.get_er(gt, pred)


def test_smoothing_pools_match_jax():
    x = np.random.default_rng(4).random((200, 3)).astype(np.float32)
    avg = avg_pool_same(torch.from_numpy(x)[None], 31, 1)[0]
    np.testing.assert_allclose(
        avg.numpy(), np.asarray(jax_avg_pool_same(x, (31,), (1,))),
        rtol=1e-6)
    mx = infer.max_pool_1d_same(avg, 124)
    np.testing.assert_array_equal(
        mx.numpy(), np.asarray(jinfer.max_pool_1d_same(avg.numpy(), 124)))


@pytest.mark.parametrize('t,length,step', [(10, 4, 3), (501, 64, 32),
                                           (7, 8, 16)])
def test_framing_and_overlap_add_match_jax(t, length, step):
    x = np.random.default_rng(t).standard_normal((5, t, 2)).astype(np.float32)
    fr = infer.frame_signal(torch.from_numpy(x), length, step, axis=-2)
    jfr = np.asarray(jinfer.frame_signal(x, length, step, axis=-2))
    np.testing.assert_array_equal(fr.numpy(), jfr)
    frames = fr.permute(0, 3, 1, 2)                     # [5, 2, W, length]
    np.testing.assert_array_equal(
        infer.overlap_and_add(frames, step).numpy(),
        np.asarray(jinfer.overlap_and_add(jfr.transpose(0, 3, 1, 2), step)))


# ------------------------------------------------------------- evaluate()
CFG = dict(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME, n_chan=2)


@pytest.fixture(scope='module')
def dev_set(tmp_path_factory):
    """3 two-channel 16 kHz WAVs of 4-8 s with a tone on channel 0, and
    answers of a few events each."""
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


def test_evaluate_grids_and_ers_equal_jax(dev_set, monkeypatch):
    """vad v8 at base 8 and td_dim 32 on 32 mels, bridged weights, windows
    of 64 frames every 32: the same grids and ERs as JAX's evaluate()."""
    jm = JVADModel(v=8, base_fsize=8, td_dim=32)
    variables = vad_variables(jm, (N_MELS, N_FRAME, 2), seed=5)
    jbundle = ModelBundle(jm, (N_MELS, N_FRAME, 2), JConfig(**CFG))
    jgrids = _record_grids(monkeypatch, jinfer)
    jers = jinfer.evaluate(JConfig(**CFG), jbundle, variables,
                           overlap_hop=32, eval_dir=str(dev_set))
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    pm.load_state_dict(flax_to_state_dict(variables))
    grids = _record_grids(monkeypatch, infer)
    ers = infer.evaluate(Config(**CFG), pm, overlap_hop=32,
                         eval_dir=str(dev_set))
    assert len(grids) == len(jgrids) == 3
    for g, jg in zip(grids, jgrids):
        assert g.shape == jg.shape and g.shape[1] == 3
        np.testing.assert_array_equal(g, jg)
    assert any(g.any() for g in grids) and not all(g.all() for g in grids)
    assert ers == jers
    assert all(np.isfinite(ers))
