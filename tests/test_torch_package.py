"""The port as a package: it stands alone (no JAX, no challenge_tpu), its
Config is the JAX package's field for field, its entry points and CLIs
refuse to fall back to the CPU quietly, the README usage runs end to end on the CPU
when asked for it, and chip_smoke.py refuses to report without a card or
the repo."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import challenge_tpu_torch
from _torch_parity import BATCH, N_FRAME, N_MELS, small_sources
from challenge_tpu import config as jconfig
from challenge_tpu_torch import config as pconfig
from challenge_tpu_torch.data.pipeline import DevicePipeline, build_banks
from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.train.loop import TrainLoop

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh interpreter (this
    process has JAX loaded by conftest), leaves jax, flax, optax and
    challenge_tpu out of sys.modules."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import challenge_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(n for n in sys.modules if n.split(".")[0] in\n'
        '             ("jax", "jaxlib", "flax", "optax", "challenge_tpu"))\n'
        'print(len([n for n in sys.modules if n.startswith(p.__name__)]))\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module was loaded, the CLIs and the eval chain among them
    assert int(out.stdout.split()[-1]) >= 32


def test_config_equals_jax_config_field_for_field():
    """Same fields, defaults, flags and run names. Only the default
    ``datapath`` differs: JAX's is an absolute path on the reference
    authors' machines, which its CLI replaces by the working directory when
    absent; the port's is ''."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pconfig.Config)]
    assert [f[0] for f in pf] == [f[0] for f in jf]
    assert [f for f in pf if f[0] != 'datapath'] == \
        [f for f in jf if f[0] != 'datapath']
    assert pconfig.Config().datapath == ''
    argv = ['--model_type', 'vad', '--v', '8', '--lr', '0.002',
            '--name', 'filter_x', '--optimizer', 'adam', '--n_frame', '256',
            '--datapath', 'data']
    a, b = jconfig.config_from_args(argv), pconfig.config_from_args(argv)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.run_name() == b.run_name()
    assert dataclasses.asdict(pconfig.parse_run_name(
        pconfig.Config(datapath='data'), b.run_name())) == dataclasses.asdict(
            jconfig.parse_run_name(jconfig.Config(datapath='data'),
                                   a.run_name()))


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch):
    """Without a GPU, the default device is an error, not the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = challenge_tpu_torch.Config(model_type='vad', v=8)
    src = small_sources(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_banks(*src, n_frame=N_FRAME)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    banks = build_banks(*src, n_frame=N_FRAME, device='cpu')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePipeline(banks, cfg)


def test_clis_and_eval_do_not_fall_back_to_the_cpu(tmp_path, monkeypatch):
    """Without a GPU and without --device cpu, both CLIs and the WAV
    ingest of the eval chain raise before any work."""
    from _helpers import DATA_FLAGS, make_datafiles, write_wav
    from challenge_tpu_torch.cli import eval as eval_cli
    from challenge_tpu_torch.cli import sj_train
    from challenge_tpu_torch.ops.dsp import load_wav
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    write_wav(tmp_path / 'a.wav', seconds=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sj_train.main(['--model_type', 'vad', '--v', '8', '--bank_dtype',
                       'int8'] + DATA_FLAGS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_cli.main(['--name', 'vad_v8_lr0.001_batch12_opt_adam_mel80_'
                       'chan2_BCE_framelen512', '--p'])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_wav(str(tmp_path / 'a.wav'))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ['a.wav', 'bg.pickle', 'voice.pickle', 'labels.npy', 'noise.pickle',
         'test_bg.pickle', 'test_voice.pickle', 'test_labels.npy'])


def test_get_model_v8_is_full_width():
    """get_model builds vad v8 at the JAX registry's width (base 48,
    td_dim 1024): same parameter count as the flax module."""
    from challenge_tpu.config import Config as JConfig
    from challenge_tpu.models.registry import get_model as jax_get_model
    jb = jax_get_model(JConfig(model_type='vad', v=8))
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    bundle = get_model(challenge_tpu_torch.Config(model_type='vad', v=8),
                       device='cpu')
    assert bundle.input_shape == jb.input_shape == (80, 512, 2)
    assert bundle.module.blocks[0].convs[0].out_channels == 48
    assert sum(t.numel() for t in bundle.module.state_dict().values()) \
        == n_flax


def test_readme_usage_trains_on_the_cpu(capsys):
    """build_banks -> DevicePipeline -> TrainLoop.fit, the README's
    programmatic usage, at a small width on the CPU: two training steps and
    one validation step give finite logs."""
    cfg = challenge_tpu_torch.Config(model_type='vad', v=8, n_mels=N_MELS,
                                     n_frame=N_FRAME, batch_size=BATCH)
    banks = build_banks(*small_sources(3), n_frame=N_FRAME, device='cpu')
    module = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    loop = TrainLoop(ModelBundle(module, (N_MELS, N_FRAME, 2), cfg,
                                 torch.device('cpu')))
    hist = loop.fit(DevicePipeline(banks, cfg, device='cpu'), epochs=1,
                    steps_per_epoch=2,
                    validation_iter=DevicePipeline(banks, cfg, training=False,
                                                   device='cpu'),
                    validation_steps=1)
    logs = hist[0]
    for k in ('loss', 'cos_sim', 'er', 'f1_score', 'val_loss', 'val_er'):
        assert np.isfinite(logs[k]), (k, logs)
    assert loop.state.step == 2
    assert 'Epoch 1/1' in capsys.readouterr().out


@pytest.mark.parametrize('where', ['repo', 'alone'])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result line when no CUDA
    card is visible, and when it stands in a directory without the
    repo."""
    if where == 'alone':
        cwd = tmp_path
        (tmp_path / 'chip_smoke.py').write_text(
            (ROOT / 'chip_smoke.py').read_text())
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    else:
        cwd, env = ROOT, dict(os.environ, CUDA_VISIBLE_DEVICES='-1')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
