"""The port's last helpers against the JAX package's, on the same numpy
inputs: context windows (utils/windows.py), prediction with test-time
augmentation (utils/predict.py), magnitude and phase and the phase vocoder
(ops/complexspec.py), and tracing and step timing (utils/profiling.py).

Tolerances: windows exact (the same gathers and float64 sums, in
another order only where numpy's add.at and index_add_ both add in
index order); predict and the magphase functions rtol 1e-6 (float32
transcendental functions of two libraries); the phase vocoder's output
length exactly, its magnitude within 1e-6 of the peak (a linear blend of
float32 magnitudes; measured 2.1e-7) and its complex output within 1e-2
of the peak (measured 5.3e-3 at rate 0.8): the phase is a float32
cumulative sum of angle increments near pi * k a frame, so bin 256 is
near 6.4e4 rad after 80 frames, where one float32 ulp is 3.9e-3 rad, and
the two libraries' angles and sums round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from challenge_tpu.ops import complexspec as jcs
from challenge_tpu.utils import profiling as jprof
from challenge_tpu.utils import windows as jwin
from challenge_tpu.utils.predict import predict as jax_predict
from challenge_tpu_torch import utils
from challenge_tpu_torch.ops import complexspec as cs
from challenge_tpu_torch.utils import profiling, windows
from challenge_tpu_torch.utils.predict import predict

GOLDEN_SEQ = np.array([1, 2, 3, 4, 5])
GOLDEN_OFFSETS = np.array([-3, -1, 0, 1, 3])


def test_utils_exports_what_jax_s_utils_exports():
    import challenge_tpu.utils as jutils
    names = {n for n in dir(jutils) if not n.startswith('_')
             and callable(getattr(jutils, n))}
    assert names <= set(utils.__all__)
    gen = utils.list_to_generator(([1, 2], ['a', 'b']))
    assert list(gen()) == list(jutils.list_to_generator(
        ([1, 2], ['a', 'b']))()) == [(1, 'a'), (2, 'b')]


@pytest.mark.parametrize('skip', [1, 2, 3])
@pytest.mark.parametrize('padding', [True, False])
def test_seq_to_windows_equals_jax_on_the_goldens(skip, padding):
    """The reference goldens of tests/test_windows.py; without padding,
    its raw-index case at strides 4, 8 and 12 (every window in range)."""
    if padding:
        seq, offsets, kw = GOLDEN_SEQ, GOLDEN_OFFSETS, dict(skip=skip)
    else:
        seq, offsets = np.arange(10, 30), np.array([0, 2])
        kw = dict(skip=4 * skip, padding=False)
    ref = jwin.seq_to_windows(seq, offsets, **kw)
    got = windows.seq_to_windows(torch.from_numpy(seq), offsets, **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    back = windows.windows_to_seq(got, offsets, skip=kw['skip'])
    assert back.dtype == torch.float64
    np.testing.assert_array_equal(
        back.numpy(), jwin.windows_to_seq(ref, offsets, skip=kw['skip']))


@pytest.mark.parametrize('skip', [1, 3])
@pytest.mark.parametrize('dtype', ['float32', 'complex64'])
def test_windows_equal_jax_on_random_multidim_sequences(skip, dtype):
    rng = np.random.default_rng(skip)
    seq = rng.standard_normal((23, 4, 2)).astype('f4')
    if dtype == 'complex64':
        seq = (seq + 1j * rng.standard_normal(seq.shape)).astype(dtype)
    seq = np.concatenate([seq, seq[:1]])          # 24 frames
    for offsets in ([-2, 0, 1, 4], [-5, 0, 5], [0, 1, 2]):
        offsets = np.array(offsets)
        ref = jwin.seq_to_windows(seq, offsets, skip=skip,
                                  constant_values=0.5)
        got = windows.seq_to_windows(seq, offsets, skip=skip,
                                     constant_values=0.5)
        np.testing.assert_array_equal(got.numpy(), ref)
        # without padding, windows past the sequence's end raise in both
        for n in (23, 24):
            try:
                ref = jwin.seq_to_windows(seq[:n], offsets, skip=skip,
                                          padding=False)
            except IndexError:
                with pytest.raises(IndexError):
                    windows.seq_to_windows(seq[:n], offsets, skip=skip,
                                           padding=False)
                continue
            np.testing.assert_array_equal(
                windows.seq_to_windows(seq[:n], offsets, skip=skip,
                                       padding=False).numpy(), ref)
        rec = windows.windows_to_seq(got, offsets, skip=skip)
        ref_rec = jwin.windows_to_seq(got.numpy(), offsets, skip=skip)
        assert rec.numpy().dtype == ref_rec.dtype
        np.testing.assert_array_equal(rec.numpy(), ref_rec)


def _model(xs, xp, width):
    """A stand-in model of ``width`` outputs (for the VAD gate: 30 degree
    scores, then the activity logit) that depends on the input's channel
    order."""
    w = np.linspace(-1.0, 1.0, width * 4).reshape(4, width).astype(
        np.float32)
    return xp.tanh(xs @ (w if xp is jnp else torch.from_numpy(w)))


@pytest.mark.parametrize('vad', [False, True])
@pytest.mark.parametrize('reverse_and_add', [False, True])
def test_predict_equals_jax(vad, reverse_and_add):
    xs = np.random.default_rng(1).standard_normal((3, 5, 4)).astype('f4')
    width = 31 if vad else 40
    ref = jax_predict(lambda x: _model(x, jnp, width), jnp.asarray(xs),
                      reverse_and_add=reverse_and_add, vad=vad)
    got = predict(lambda x: _model(x, torch, width), torch.from_numpy(xs),
                  reverse_and_add=reverse_and_add, vad=vad)
    assert got.shape == ref.shape == (3, 5, 30 if vad else 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_magphase_functions_equal_jax():
    rng = np.random.default_rng(2)
    spec = rng.standard_normal((3, 17, 9, 4)).astype('f4')
    labels = np.arange(3)
    got_mp, got_y = cs.complex_to_magphase(torch.from_numpy(spec), labels)
    ref_mp, ref_y = jcs.complex_to_magphase(jnp.asarray(spec), labels)
    assert got_y is labels and ref_y is labels
    pairs = [
        (got_mp, ref_mp),
        (cs.magphase_to_complex(got_mp), jcs.magphase_to_complex(ref_mp)),
        (cs.log_magphase(got_mp), jcs.log_magphase(ref_mp)),
        (cs.minmax_norm_magphase(got_mp), jcs.minmax_norm_magphase(ref_mp)),
        (cs.log_magphase(got_mp, labels, n_chan=2)[0],
         jcs.log_magphase(ref_mp, labels, n_chan=2)[0]),
        (cs.minmax_norm_magphase(got_mp, labels)[0],
         jcs.minmax_norm_magphase(ref_mp, labels)[0])]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(cs.magphase_to_complex(got_mp).numpy(), spec,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('rate', [0.8, 1.0, 1.3])
def test_phase_vocoder_equals_jax(rate):
    spec = np.random.default_rng(3).standard_normal((257, 64, 4)).astype(
        'f4')
    ref = np.asarray(jcs.phase_vocoder(jnp.asarray(spec), rate))
    got = cs.phase_vocoder(torch.from_numpy(spec), rate).numpy()
    assert got.shape == ref.shape == (257, int(np.ceil(64 / rate)), 4)
    if rate == 1.0:
        np.testing.assert_array_equal(got, spec)
        return
    mag = lambda s: np.hypot(s[..., :2], s[..., 2:])  # noqa: E731
    assert np.abs(mag(got) - mag(ref)).max() <= 1e-6 * mag(ref).max()
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


def test_step_timer_keeps_jax_s_summary_and_warmup_rule():
    times = [0.5, 0.01, 0.02, 0.03]
    got, ref = profiling.StepTimer(), jprof.StepTimer()
    got.times, ref.times = list(times), list(times)
    for skip in (0, 1, 4, 9):
        assert got.summary(skip) == ref.summary(skip)
    assert set(got.summary()) == {'steps', 'mean_ms', 'p50_ms', 'p95_ms'}
    t = profiling.StepTimer()
    for _ in range(3):
        with t:
            out = t.sync({'x': torch.ones(4) * 2, 'y': [torch.zeros(1)]})
    assert out['x'].sum() == 8 and t.summary()['steps'] == 3
    assert len(t.times) == 3 and min(t.times) >= 0


def test_trace_writes_a_trace_file_and_there_is_no_server(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.arange(16.0).sum()
    found = [p for p in tmp_path.rglob('*') if p.is_file()]
    assert found and all(p.stat().st_size > 0 for p in found)
    assert any(p.name.endswith('.pt.trace.json') for p in found)
    with pytest.raises(NotImplementedError, match='no live profiler'):
        profiling.start_server()
    assert callable(jax.profiler.start_server)
