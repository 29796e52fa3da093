"""The port's trained-ER demonstration (challenge_tpu_torch/scripts/
trained_er_demo.py) against JAX's (scripts/trained_er_demo.py), on the
CPU at a small size.

Tolerances:
* the corpus generators (``event_wav``, ``noise_wav``, ``write_dev_set``)
  and the pickles' labels: exact (the same numpy code on the same
  ``np.random.Generator``);
* the spectrograms of the pickles and the banks: max abs <= 1e-5 x the
  peak (``tests/test_torch_eval.py``'s bound on ``wav_to_spec``: float32
  sums of the same products in another order);
* ``debug_grid_stats``: within 1e-5 of the numbers JAX's computes, read
  from its own inside and outside arrays (it prints them to 3 decimals).
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_parity import strip_flat, vad_variables
from challenge_tpu.config import Config as JConfig
from challenge_tpu.data.pipeline import build_banks as jax_build_banks
from challenge_tpu.models.registry import ModelBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.scripts import trained_er_demo as demo

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
import trained_er_demo as jdemo  # noqa: E402

SMALL_FLAGS = ('--n_mels', '8', '--n_frame', '256', '--batch_size', '1')


def _peak_close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max()


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize('what', ['event0', 'event1', 'event2', 'noise'])
def test_corpus_waveforms_equal_jax(what):
    """The same samples from the same generator, and the generator left
    in the same state."""
    rngs = np.random.default_rng(0), np.random.default_rng(0)
    outs = []
    for mod, rng in zip((demo, jdemo), rngs):
        if what == 'noise':
            outs.append([mod.noise_wav(rng, 0.7), mod.noise_wav(rng, 1.3,
                                                                amp=0.15)])
        else:
            cls = int(what[-1])
            outs.append([mod.event_wav(rng, cls, d) for d in (0.5, 1.5)]
                        + [mod.event_wav(rng, cls, 1.0, amp=0.03)])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and a.shape[0] == 2
        np.testing.assert_array_equal(a, b)
    assert rngs[0].random() == rngs[1].random()
    assert (demo.SR, demo.HOP, demo.F0, demo.VOICE_DURS, demo.NOISE_DURS) \
        == (jdemo.SR, jdemo.HOP, jdemo.F0, jdemo.VOICE_DURS, jdemo.NOISE_DURS)


def test_dev_set_equals_jax(tmp_path):
    """2 clips of 5 s: the WAV bytes and sample_answer.json equal JAX's."""
    (tmp_path / 'p').mkdir()
    (tmp_path / 'j').mkdir()
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    demo.write_dev_set(rng, str(tmp_path / 'p'), n_clips=2, clip_s=5.0)
    jdemo.write_dev_set(jrng, str(tmp_path / 'j'), n_clips=2, clip_s=5.0)
    files, jfiles = _files(tmp_path / 'p'), _files(tmp_path / 'j')
    assert sorted(files) == ['clip00.wav', 'clip01.wav',
                             'sample_answer.json']
    assert files == jfiles
    assert rng.random() == jrng.random()


def test_training_pickles_match_jax(tmp_path):
    """The reference dataset format: the label files exact (the ``* 10``
    remap quirk included), every spectrogram of the five pickles within
    1e-5 of the peak of JAX's ``wav_to_spec``."""
    from challenge_tpu_torch.utils.io import load_data
    (tmp_path / 'p').mkdir()
    (tmp_path / 'j').mkdir()
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    demo.write_training_pickles(rng, str(tmp_path / 'p'), 64, device='cpu')
    jdemo.write_training_pickles(jrng, str(tmp_path / 'j'), 64)
    assert sorted(os.listdir(tmp_path / 'p')) == sorted(
        os.listdir(tmp_path / 'j'))
    for name in ('labels.npy', 'test_labels.npy'):
        a, b = (np.load(tmp_path / s / name) for s in 'pj')
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.load(tmp_path / 'p' / 'labels.npy'),
                                  np.repeat([0, 10, 20], 24))
    for name in ('bg.pickle', 'voice.pickle', 'noise.pickle',
                 'test_bg.pickle', 'test_voice.pickle'):
        specs, jspecs = (load_data(str(tmp_path / s / name)) for s in 'pj')
        assert len(specs) == len(jspecs) > 0
        for s, js in zip(specs, jspecs):
            assert s.dtype == np.float32 and s.shape[0] == 257
            _peak_close(s, js)
    assert rng.random() == jrng.random()


def test_training_banks_match_jax():
    """``build_training_banks``: the labels and lengths exact, the flat
    spectrograms within 1e-5 of the peak, JAX's lane padding dropped."""
    kw = dict(n_per_class=2, n_bg=2, n_noise=2)
    banks = demo.build_training_banks(np.random.default_rng(2), 64,
                                      device='cpu', **kw)
    jrng = np.random.default_rng(2)
    import challenge_tpu.data.pipeline as jpipe
    assert jdemo.build_banks is jpipe.build_banks is jax_build_banks
    jbanks = jdemo.build_training_banks(jrng, 64, **kw)
    np.testing.assert_array_equal(banks.voice_labels.numpy(),
                                  np.asarray(jbanks.voice_labels))
    for which in ('backgrounds', 'voices', 'noises'):
        pb, jb = getattr(banks, which), getattr(jbanks, which)
        np.testing.assert_array_equal(pb.lens.numpy(), np.asarray(jb.lens))
        rows = pb.flat.shape[1]
        _peak_close(pb.flat.numpy(),
                    strip_flat(np.asarray(jb.flat)[:, :rows], 4, 257))


def test_debug_grid_stats_match_jax(tmp_path, monkeypatch, capsys):
    """A small vad v8 (base 8, td_dim 32, 32 mels, 512-frame windows that
    cover the 5 s clips at the eval's hop of 512), JAX's weights carried
    across: the four numbers within 1e-5 of JAX's, and the same line."""
    rng = np.random.default_rng(0)
    demo.write_dev_set(rng, str(tmp_path), n_clips=2, clip_s=5.0)
    shape = (32, 512, 2)
    jm = JVADModel(v=8, base_fsize=8, td_dim=32)
    variables = vad_variables(jm, shape, seed=3)
    jcfg = JConfig(model_type='vad', v=8, n_mels=32, n_frame=512)
    seen = []

    class _Np:      # JAX's numpy, recording what it concatenates
        def __getattr__(self, name):
            return getattr(np, name)

        def concatenate(self, *a, **kw):
            seen.append(np.concatenate(*a, **kw))
            return seen[-1]

    monkeypatch.setattr(jdemo, 'np', _Np())
    jdemo.debug_grid_stats(jcfg, ModelBundle(jm, shape, jcfg), variables,
                           str(tmp_path), 'j')
    monkeypatch.undo()
    jline = capsys.readouterr().out.strip()
    ins, outs = seen
    want = {'p_inside': ins.mean(), 'p_outside': outs.mean(),
            'frac_inside': np.mean(ins > .5),
            'frac_outside': np.mean(outs > .5)}

    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=32)
    pm.load_state_dict(flax_to_state_dict(variables))
    got = demo.debug_grid_stats(
        Config(model_type='vad', v=8, n_mels=32, n_frame=512), pm,
        str(tmp_path), 'j')
    assert capsys.readouterr().out.strip() == jline
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-5, (k, got, want)
    # the weights make the grids neither empty nor full
    assert 0 < got['p_inside'] + got['p_outside'] < 2, got


def test_demo_hands_the_clis_jax_argv(tmp_path, monkeypatch, capsys):
    """The chain with only the fit replaced (the untrained weights saved
    as the best and the SWA checkpoints): ``sj_train`` gets JAX's argv
    (scripts/trained_er_demo.py) with the extra flags and ``--device``
    after it, and the rest runs as it is, the ``eval`` CLI on both
    checkpoints included, with JAX's lines and finite ERs."""
    from challenge_tpu_torch.cli import sj_train
    from challenge_tpu_torch.config import config_from_args
    from challenge_tpu_torch.models.registry import get_model
    from challenge_tpu_torch.train.checkpoint import save_weights
    seen = []

    def fit(argv):
        seen.append((list(argv), os.getcwd()))
        cfg = config_from_args(argv, extra=sj_train.DEVICE_FLAG)
        module = get_model(cfg, device='cpu').module
        for suffix in ('', '_SWA'):
            save_weights(f'{cfg.run_name()}{suffix}.h5', module.state_dict())
        return cfg.run_name()

    monkeypatch.setattr(sj_train, 'main', fit)
    out = demo.demo(str(tmp_path), 'cpu', epochs=4, steps=9,
                    bank_dtype='int8', n_clips=2, clip_s=4.0,
                    flags=SMALL_FLAGS)
    d = str(tmp_path)
    assert seen == [([
        '--name', 'erdemo', '--model_type', 'vad', '--v', '8',
        '--snr', '-6', '--epochs', '4', '--steps_per_epoch', '9',
        '--bank_dtype', 'int8', '--datapath', d,
        '--background_sounds', 'bg.pickle',
        '--voices', 'voice.pickle', '--labels', 'labels.npy',
        '--noises', 'noise.pickle',
        '--test_background_sounds', 'test_bg.pickle',
        '--test_voices', 'test_voice.pickle',
        '--test_labels', 'test_labels.npy', *SMALL_FLAGS,
        '--device', 'cpu'], d)]
    text = capsys.readouterr().out
    assert text.startswith(f'config: {out["run"]}\n')
    for line in ('untrained mean ER: ', '[untrained] p(inside)=',
                 'fit wall ', 'for 4x9 steps', 'trained mean ER (best): ',
                 '[trained_best] p(inside)=', 'trained mean ER (_SWA): ',
                 '[trained_SWA] p(inside)='):
        assert line in text, line
    # the untrained weights score the same through evaluate() and the CLI
    assert out['untrained'] == out['best'] == out['swa']
    assert np.isfinite(out['untrained']).all() and len(out['best']) == 2
    assert out['stats']['untrained'] == out['stats']['trained_best'] \
        == out['stats']['trained_SWA']
    assert os.getcwd() != d


@pytest.mark.slow
def test_demo_chain_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The whole chain at a small size (vad v8 on 8 mels x 256 frames,
    batch 1; 3 epochs of 1 step, so that SWA folds once and the eval
    callback fires at epoch 2; 2 clips of 4 s): JAX's lines, the trio
    and the CSV log, and finite ERs. ``slow``: 8-9 s on a CPU, over half
    of it the fixed cost of four full-width vad v8 models and the first
    optimizer step's import of ``torch._dynamo``."""
    # no tensorboard writer: its import pulls in TensorFlow here
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    out = demo.demo(str(tmp_path), 'cpu', epochs=3, steps=1, n_clips=2,
                    clip_s=4.0, flags=SMALL_FLAGS)
    text = capsys.readouterr().out
    run = out['run']
    assert run == ('erdemo_vad_v8_lr0.001_batch1_opt_adam_mel8_chan2_BCE_'
                   'framelen256')
    for line in (f'config: {run}', 'untrained mean ER: ',
                 '[untrained] p(inside)=', 'fit wall ',
                 'trained mean ER (best): ', '[trained_best] p(inside)=',
                 'trained mean ER (_SWA): ', '[trained_SWA] p(inside)='):
        assert line in text, line
    assert text.index('untrained mean ER') < text.index('fit wall') \
        < text.index('trained mean ER (best)') \
        < text.index('trained mean ER (_SWA)')
    for suffix in ('', '_SWA', '_sample'):
        assert (tmp_path / f'{run}{suffix}.h5').is_file(), suffix
    assert (tmp_path / f'{run}.csv').is_file()
    assert 'FINAL SCORE' in text[:text.index('fit wall')]  # the callback
    for key in ('untrained', 'best', 'swa'):
        assert len(out[key]) == 2 and np.isfinite(out[key]).all(), out
    assert set(out['stats']) == {'untrained', 'trained_best', 'trained_SWA'}
    assert all(np.isfinite(list(s.values())).all()
               for s in out['stats'].values())
    assert out['fit_s'] > 0


def test_demo_needs_a_card_or_the_cpu_flag(tmp_path, monkeypatch):
    """Without a GPU and without --device cpu, the demo raises before it
    writes anything."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(['1', '2'])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.demo(str(tmp_path))
    assert list(tmp_path.iterdir()) == []


def test_main_takes_jax_command_line(monkeypatch):
    """``[epochs] [steps_per_epoch] [bank_dtype]`` with JAX's defaults,
    plus ``--device``; the run gets a fresh directory."""
    calls = []
    monkeypatch.setattr(demo, 'demo', lambda *a: calls.append(a) or a)
    demo.main(['--device', 'cpu'])
    demo.main(['3', '7', 'int8', '--device', 'cpu'])
    (d0, dev0, *rest0), (d1, dev1, *rest1) = calls
    assert rest0 == [20, 100, 'float32'] and rest1 == [3, 7, 'int8']
    assert dev0 == dev1 == torch.device('cpu')
    assert d0 != d1 and not os.path.exists(d0)
