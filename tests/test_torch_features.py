"""The port's feature chain (challenge_tpu_torch/data/pipeline.py FeatureFn,
ops/mel.py, ops/norms.py, ops/augment.py, data/labels.py) against JAX's
``make_feature_fn`` on its fused-magnitude ``variant='sj'`` branch.

Both sides get the same flat magnitude and per-voice labels (made with
numpy, in place of ``sample_batch``'s output) and the same SpecAugment
masks (JAX's, drawn from the chain's key). Tolerances: the pre-log mel is a
float32 GEMM over 257 non-negative terms whose reduction order differs
between the two BLAS libraries, so rtol 1e-5 (atol 1e-7 for the exact zeros
of masked frames). The log-mel is held by its MEAN abs error: after minmax
a bin next to the sample's minimum is a small difference of nearly equal
numbers, and the log turns its rounding into a large relative error
(NOTES.md:710-713). Labels are 0/1 pooling and thresholds: exact."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import BATCH, N_FRAME, N_MELS, jax_features, strip_flat
from challenge_tpu.config import Config as JConfig
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.labels import label_downsample, to_frame_labels
from challenge_tpu_torch.data.pipeline import FeatureFn
from challenge_tpu_torch.ops.augment import batch_mask_keep
from challenge_tpu_torch.ops.mel import mel_filterbank

CFG = dict(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
           batch_size=BATCH)


def _sample_batch_output(seed: int):
    """A ``sample_batch(..., magnitude='flat')`` output made with numpy:
    magnitudes of complex normal spectra in JAX's flat layout (two planes of
    257 rows padded to 288 with zeros) and per-voice labels, each voice one
    class over one contiguous run of frames."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((BATCH, N_FRAME, 2, 288), np.float32)
    planes[..., :257] = np.hypot(
        rng.standard_normal((BATCH, N_FRAME, 2, 257)),
        rng.standard_normal((BATCH, N_FRAME, 2, 257)))
    label = np.zeros((BATCH, 7, N_FRAME, 3), np.float32)
    for b in range(BATCH):
        for v in range(rng.integers(1, 7)):
            start = rng.integers(0, N_FRAME - 8)
            stop = start + rng.integers(8, N_FRAME - start + 1)
            label[b, v, start:stop, rng.integers(0, 3)] = 1.0
    return planes.reshape(BATCH, N_FRAME, 576), label


@pytest.fixture(scope='module')
def rec():
    mag, label = _sample_batch_output(1)
    out = jax_features(JConfig(**CFG), mag, label, jax.random.PRNGKey(5))
    return dict(out, mag=mag, label=label)


def _inputs(rec):
    mag = torch.from_numpy(strip_flat(rec['mag'], 2, 257))
    return (mag, torch.from_numpy(rec['label']),
            torch.from_numpy(rec['tmask']), torch.from_numpy(rec['fmask']))


def test_masks_are_drawn_and_cut(rec):
    """The recorded masks do cut the batch: time masks over n_frame, one
    frequency mask over the 257 true rows."""
    assert rec['tmask'].shape == (BATCH, N_FRAME)
    assert rec['fmask'].shape == (BATCH, 257)
    assert (rec['tmask'] == 0).any() and (rec['fmask'] == 0).any()


def test_pre_log_mel_matches_jax(rec):
    mag, _, tmask, fmask = _inputs(rec)
    fn = FeatureFn(Config(**CFG), device='cpu')
    mel = fn.mel(mag, tmask, fmask).numpy()
    assert mel.shape == rec['mel'].shape == (BATCH, N_MELS, N_FRAME, 2)
    np.testing.assert_allclose(mel, rec['mel'], rtol=1e-5, atol=1e-7)
    # 'nominmax' in the run name skips the minmax (pipeline.py:144)
    raw = FeatureFn(Config(name='nominmax', **CFG), device='cpu').mel(
        mag, tmask, fmask).numpy()
    np.testing.assert_allclose(raw, rec['mel_raw'], rtol=1e-5, atol=1e-7)


def test_log_mel_and_labels_match_jax(rec):
    mag, label, tmask, fmask = _inputs(rec)
    x, y = FeatureFn(Config(**CFG), device='cpu').features(
        mag, label, tmask, fmask)
    assert x.shape == rec['x'].shape and y.shape == rec['y'].shape
    assert y.shape == (BATCH, N_FRAME // 32, 3)
    err = np.abs(x.numpy() - rec['x'])
    assert err.mean() < 1e-5, err.mean()
    np.testing.assert_array_equal(y.numpy(), rec['y'])


def test_filter_zeroes_low_rows():
    """'filter' in the run name drops frequency rows 1..filter_num of both
    magnitude planes before the mel (sj_train.py:117)."""
    rng = np.random.default_rng(2)
    mag = torch.from_numpy(rng.random((2, 16, 514)).astype(np.float32))
    cfg = dict(CFG, n_frame=16, batch_size=2)
    filt = FeatureFn(Config(name='filter', **cfg), device='cpu').mel(mag)
    keep = np.ones(257, np.float32)
    keep[1:int(round(200 / (16000 / 256))) + 1] = 0.0
    cut = mag * torch.from_numpy(np.tile(keep, 2))
    plain = FeatureFn(Config(**cfg), device='cpu').mel(cut)
    torch.testing.assert_close(filt, plain, rtol=0, atol=0)


def test_mel_filterbank_equals_jax():
    from challenge_tpu.ops.mel import linear_to_mel_weight_matrix
    for n in (32, 80):
        np.testing.assert_array_equal(mel_filterbank(n),
                                      linear_to_mel_weight_matrix(n))


def test_label_maps_match_jax():
    from challenge_tpu.data import labels as jlabels
    rng = np.random.default_rng(3)
    y = (rng.random((3, 7, 70, 3)) < 0.3).astype(np.float32)
    _, ref = jlabels.to_frame_labels(None, y)
    out = to_frame_labels(torch.from_numpy(y))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    frames = (rng.random((3, 70, 3)) < 0.5).astype(np.float32)
    for res in (32, 7):
        _, ref = jlabels.label_downsample(res)(None, frames)
        out = label_downsample(torch.from_numpy(frames), res)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_port_mask_distribution():
    """The port's own masks: spans of size < max_mask_size at offsets that
    keep the span inside the axis, n_mask of them per sample."""
    gen = torch.Generator().manual_seed(4)
    m = batch_mask_keep(gen, 512, 80, max_mask_size=16, n_mask=1).numpy()
    cut = (m == 0).sum(1)
    assert cut.max() == 15 and cut.min() == 0
    for row in m[cut > 0]:
        idx = np.flatnonzero(row == 0)
        assert idx[-1] - idx[0] + 1 == len(idx)        # one contiguous span
    m6 = batch_mask_keep(gen, 64, N_FRAME, max_mask_size=24, n_mask=6)
    assert ((m6 == 0).sum(1) <= 6 * 23).all()
