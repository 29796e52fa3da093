"""Serving artifacts and the one-program dev-set eval
(challenge_tpu_torch/interop/aot.py, evaluate/infer.py
``devset_infer_body``, cli/get_csv_data.py) against the module, the
per-clip path and the JAX package.

* ``export_infer``: the artifact, reloaded from its bytes after the module
  is deleted, gives the module's outputs exactly at batch 1, 2 and 5 (a
  symbolic batch), and at its one size when pinned. The CPU runs the same
  aten ops in both, so exactly.
* ``export_eval``: its grids are the batched chain's, which on each clip's
  valid rows are the per-clip path's, on 3 WAVs of unequal length, and
  JAX's ``devset_infer_body`` grids on the same PCM with bridged weights
  (the RMS and mel sums differ in float32 order, so a frame could flip
  only within float32 noise of 0.5). For n_chan 6 the merge seeds are the
  artifact's third input, and the per-clip path gives clip i seed i.
* ``cli.get_csv_data``: the port's ``result.csv`` is JAX's on the same run
  directory of Keras checkpoints.

The models are vad v8 and v9 at base 8 and td_dim 32 on 32 mels x 64
frames (tests/test_torch_eval.py), and eff v7's head on a shallow
backbone at 10 x 64.
"""

import csv
import gc
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    N_FRAME, N_MELS, shape_bundle, vad_variables, write_dev_set)
from challenge_tpu.config import Config as JConfig
from challenge_tpu.models.registry import ModelBundle as JModelBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.evaluate import infer
from challenge_tpu_torch.interop import aot
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.vad import VADModel

HOP = 64                     # the eval windows' overlap_hop
# eff v7's head on a shallow, narrow backbone (width 0.25, depth 0.5: 10
# blocks), entered in SCALING under its own number as in
# tests/test_torch_effnet.py: B0's export and reload take about 6 s here
SHALLOW = 8


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def dev_set(tmp_path_factory):
    """3 two-channel 16 kHz WAVs of 2.0, 2.7 and 3.3 s and their answers."""
    return write_dev_set(tmp_path_factory.mktemp('dev'),
                         seconds=(2.0, 2.7, 3.3))


def _jax_vad(v, n_chan=2, seed=5):
    """(JAX bundle, numpy variables, port module) of a small vad model
    whose last bias makes class 0 fire, class 1 vary and class 2 rest."""
    cfg = dict(model_type='vad', v=v, n_mels=N_MELS, n_frame=N_FRAME,
               n_chan=n_chan)
    jm = JVADModel(v=v, base_fsize=8, td_dim=32)
    shape = (N_MELS, N_FRAME, n_chan)
    variables = vad_variables(jm, shape, seed=seed)
    last = f'FullyConnectedLayer_{4 if v == 9 else 3}'
    variables['params'][last]['Dense_0']['bias'] = np.array(
        [1.5, 0.0, -1.5], np.float32)
    pm = VADModel(v=v, base_fsize=8, td_dim=32, n_mels=N_MELS, n_chan=n_chan)
    pm.load_state_dict(flax_to_state_dict(variables))
    return JModelBundle(jm, shape, JConfig(**cfg)), variables, pm.eval()


def _model(name, monkeypatch):
    if name == 'eff_v7':
        from challenge_tpu_torch.models import effnet
        monkeypatch.setitem(effnet.SCALING, SHALLOW, (0.25, 0.5))
        cfg = Config(model_type='eff', model=SHALLOW, v=7, n_mels=10,
                     n_frame=64, n_chan=2)
        return get_model(cfg, device='cpu', seed=3).module.eval(), cfg
    v = int(name[1:])
    return _jax_vad(v)[2], Config(model_type='vad', v=v, n_mels=N_MELS,
                                  n_frame=N_FRAME, n_chan=2)


@pytest.mark.parametrize('name', ['v8', 'v9', 'eff_v7'])
def test_export_infer_serves_any_batch_without_the_module(name,
                                                          monkeypatch):
    """A symbolic batch: one artifact, reloaded from bytes with the module
    gone, equals the module at batch 1, 2 and 5."""
    module, cfg = _model(name, monkeypatch)
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal(
        (b, cfg.n_mels, cfg.n_frame, 2)).astype(np.float32))
        for b in (1, 2, 5)]
    with torch.no_grad():
        want = [module(x) for x in xs]
    data = aot.export_infer(module, cfg)
    del module
    gc.collect()
    fn = aot.load_infer(bytes(data))
    for x, w in zip(xs, want):
        got = fn(x)
        assert got.shape == w.shape and torch.equal(got, w)


@pytest.mark.parametrize('name', ['v8', 'v9'])
def test_export_infer_pinned_batch(name, tmp_path, monkeypatch):
    """``batch_size=2`` pins the program: it serves 2 and refuses 3; the
    artifact also goes to ``path``."""
    module, cfg = _model(name, monkeypatch)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, cfg.n_mels, cfg.n_frame, 2)).astype(np.float32))
    with torch.no_grad():
        want = module(x)
    path = str(tmp_path / 'serve.pt2')
    data = aot.export_infer(module, cfg, path=path, batch_size=2)
    assert open(path, 'rb').read() == data
    del module
    fn = aot.load_infer(path)
    assert torch.equal(fn(x), want)
    with pytest.raises(Exception):
        fn(torch.zeros((3, cfg.n_mels, cfg.n_frame, 2)))


def _pcm(dev_set):
    paths = sorted(str(p) for p in dev_set.glob('*.wav'))
    pcm, lens = infer._prepare_batched_pcm(paths)
    return paths, pcm, lens


def test_export_eval_grids_are_batched_and_per_clip(dev_set):
    """vad v8, n_chan 2: the artifact's grids = the batched chain's, for 3
    clips and for 2; on each clip's valid rows they are the per-clip
    path's, and rows past them are 0."""
    _, _, pm = _jax_vad(8)
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 n_chan=2)
    paths, pcm, lens = _pcm(dev_set)
    assert len(set(lens)) == 3
    args = (torch.from_numpy(pcm), torch.from_numpy(lens))
    batched = infer.make_devset_infer_fn(cfg, pm, HOP)(*args)
    fn = aot.load_infer(aot.export_eval(pm, cfg, s_max=pcm.shape[-1],
                                        overlap_hop=HOP))
    assert torch.equal(fn(*args), batched)
    assert torch.equal(fn(*(a[:2] for a in args)), batched[:2])
    for i, path in enumerate(paths):
        valid = int(lens[i]) // 256 + 1
        clip = (infer.clip_scores(cfg, pm, path, HOP, i) >= 0.5).float()
        assert clip.shape[0] == valid
        np.testing.assert_array_equal(batched[i, :valid].numpy(),
                                      clip.numpy())
        assert not batched[i, valid:].any()
    assert 0 < batched.sum() < batched[..., :2].numel()


def test_batched_grids_equal_jax_devset_body(dev_set):
    """The batched chain's grids, all rows, are JAX's
    ``devset_infer_body`` grids on the same PCM with bridged weights."""
    from challenge_tpu.evaluate.infer import devset_infer_body as jbody
    jb, variables, pm = _jax_vad(8)
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 n_chan=2)
    _, pcm, lens = _pcm(dev_set)
    batched = infer.make_devset_infer_fn(cfg, pm, HOP)(
        torch.from_numpy(pcm), torch.from_numpy(lens))
    body, takes_seed = jbody(jb, jb.config, HOP)
    assert not takes_seed
    jgrids = np.asarray(jax.jit(body)(variables, pcm, lens,
                                      np.zeros(3, np.int32)))
    np.testing.assert_array_equal(jgrids, batched.numpy())
    assert 0 < jgrids.sum() < jgrids[..., :2].size


def test_export_eval_n_chan_6_takes_the_seeds(dev_set):
    """vad v8, n_chan 6: the artifact takes seeds [N]; with seeds i it
    gives the batched grids and, on the valid rows, the per-clip path's
    (clip i merged by seed i); other seeds give the batched chain's under
    those seeds, and another merge."""
    _, _, pm = _jax_vad(8, n_chan=6)
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 n_chan=6)
    paths, pcm, lens = _pcm(dev_set)
    args = (torch.from_numpy(pcm), torch.from_numpy(lens))
    seeds = torch.arange(3, dtype=torch.int32)
    fn = aot.load_infer(aot.export_eval(pm, cfg, s_max=pcm.shape[-1],
                                        overlap_hop=HOP))
    live = infer.make_devset_infer_fn(cfg, pm, HOP)
    got = fn(*args, seeds)
    assert torch.equal(got, live(*args, seeds))
    assert torch.equal(got, live(*args))           # default seeds 0, 1, 2
    for i, path in enumerate(paths):
        valid = int(lens[i]) // 256 + 1
        clip = (infer.clip_scores(cfg, pm, path, HOP, i) >= 0.5).float()
        np.testing.assert_array_equal(got[i, :valid].numpy(), clip.numpy())
    assert torch.equal(fn(*args, seeds + 7), live(*args, seeds + 7))
    spec = torch.randn(2, 257, 9, 4)
    a, b = (infer.channel_map(cfg, spec, torch.tensor(s)) for s in
            ([0, 1], [7, 8]))
    assert a.shape[-1] == 12 and not torch.equal(a, b)


def test_merge_factors_from_seed():
    """The seed hash: U[0.1, 0.9) float32, the same for a seed on every
    call, columns and seeds apart, and int32 seeds as int64 ones."""
    from challenge_tpu_torch.ops.augment import merge_factors_from_seed
    f = merge_factors_from_seed(torch.arange(4096), 6)
    assert f.shape == (4096, 4) and f.dtype == torch.float32
    assert 0.1 <= float(f.min()) and float(f.max()) < 0.9
    assert abs(float(f.mean()) - 0.5) < 0.01
    assert len(torch.unique(f)) > 16000
    assert torch.equal(f[5:9], merge_factors_from_seed(
        torch.arange(5, 9, dtype=torch.int32), 6))


@pytest.mark.parametrize('model,v', [('eff', 5), ('vad', 1)])
def test_batched_eval_falls_back_where_outputs_are_coarse(dev_set, model,
                                                          v, monkeypatch):
    """eff v5's head and vad v1 (no label upsampling) do not cover every
    frame: the batched chain raises ``BatchedEvalIneligible``, and
    ``evaluate`` scores clip by clip, as JAX does."""
    cfg = Config(model_type=model, model=0, v=v, n_mels=N_MELS,
                 n_frame=N_FRAME, n_chan=2)
    module = (get_model(cfg, device='cpu').module if model == 'eff' else
              VADModel(v=1, base_fsize=8, td_dim=32, n_mels=N_MELS)).eval()
    _, pcm, lens = _pcm(dev_set)
    with pytest.raises(infer.BatchedEvalIneligible):
        infer.make_devset_infer_fn(cfg, module, HOP)(
            torch.from_numpy(pcm[:2]), torch.from_numpy(lens[:2]))
    assert infer.batched_grids(cfg, module, sorted(
        str(p) for p in dev_set.glob('*.wav')), HOP) is None
    ers = infer.evaluate(cfg, module, HOP, eval_dir=str(dev_set))
    assert ers == infer.evaluate(cfg, module, HOP, eval_dir=str(dev_set),
                                 batched=False)


def test_batched_eval_in_chunks(dev_set):
    """A corpus over the PCM cap runs as equal chunks, the last padded with
    dummy clips: the same grids as one chunk; a corpus of mixed sample
    rates takes the per-clip path."""
    from _helpers import write_wav
    _, _, pm = _jax_vad(8)
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 n_chan=2)
    paths, _, lens = _pcm(dev_set)
    one = infer.batched_grids(cfg, pm, paths, HOP)
    clip_bytes = 2 * 2 * int(lens.max())       # the longest, 3.3 s
    assert infer._chunk_plan(paths, 2 * clip_bytes)[1:] == (2, lens.max())
    chunked = infer.batched_grids(cfg, pm, paths, HOP, cap=2 * clip_bytes)
    assert len(one) == len(chunked) == 3
    for a, b in zip(one, chunked):
        np.testing.assert_array_equal(a, b)
    odd = dev_set.parent / 'mixed'
    odd.mkdir()
    write_wav(odd / 'a.wav', seconds=1.0, seed=1)
    write_wav(odd / 'b.wav', seconds=1.0, sr=8000, seed=2)
    mixed = sorted(str(p) for p in odd.glob('*.wav'))
    assert infer._wav_headers(mixed) is None
    assert infer.batched_grids(cfg, pm, mixed, HOP) is None


def _write_run(d, run, pb, seeds):
    """A run directory: an 8-line CSV log (one line an epoch) and the
    checkpoint trio as Keras files, each of other weights."""
    from challenge_tpu_torch.interop.keras_h5 import save_keras_h5_state_dict
    keys = ['cos_sim', 'er', 'f1_score', 'loss', 'val_cos_sim', 'val_er',
            'val_f1_score', 'val_loss']
    with open(d / f'{run}.csv', 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['epoch'] + keys)
        for e in range(8):
            w.writerow([e] + [round(0.1 * e + 0.01 * k, 4)
                              for k in range(len(keys))])
    for suffix, seed in zip(('', '_SWA', '_sample'), seeds):
        _, variables, _ = _jax_vad(8, seed=seed)
        save_keras_h5_state_dict(pb, flax_to_state_dict(variables),
                                 str(d / f'{run}{suffix}.h5'))


def test_get_csv_data_result_equals_jax(dev_set, tmp_path, monkeypatch):
    """``cli.get_csv_data`` on a run directory of Keras checkpoints (the
    reference's format) writes JAX's ``result.csv``: the header, the
    parsed fields, the output shape, the log line ``--patience`` before
    the last, and the three re-evaluated ERs. A stray CSV is skipped, as
    in JAX. Both packages' ``get_model`` build the small v8."""
    import shutil

    from challenge_tpu.cli import get_csv_data as jgcd
    from challenge_tpu_torch.cli import get_csv_data as gcd
    for p in dev_set.iterdir():
        shutil.copy(p, tmp_path)
    monkeypatch.chdir(tmp_path)
    run = f'vad_v8_lr0.001_batch2_opt_adam_mel{N_MELS}_chan2_BCE_framelen64'
    shape = (N_MELS, N_FRAME, 2)
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 n_chan=2)
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    _write_run(tmp_path, run, ModelBundle(pm, shape, cfg,
                                          torch.device('cpu')), (5, 6, 7))
    (tmp_path / 'notes.csv').write_text('a,b\n1,2\n')
    monkeypatch.setattr(gcd, 'get_model', lambda c, device=None: ModelBundle(
        VADModel(v=c.v, base_fsize=8, td_dim=32, n_mels=c.n_mels),
        (c.n_mels, c.n_frame, c.n_chan), c, torch.device('cpu')))
    monkeypatch.setattr(jgcd, 'get_model', lambda c: shape_bundle(
        JModelBundle(JVADModel(v=c.v, base_fsize=8, td_dim=32),
                     (c.n_mels, c.n_frame, c.n_chan), c)))
    argv = ['--path', str(tmp_path), '--patience', '1']
    rows = gcd.main(argv=argv + ['--device', 'cpu'])
    with open('result.csv') as f:
        ours = list(csv.reader(f))
    jgcd.main(argv=argv)
    with open('result.csv') as f:
        ref = list(csv.reader(f))
    assert ours == ref and len(ours) == 2 and ours[0] == gcd.CATEGORY
    assert ours[1][:10] == ['vad_v8_lr0.001_batch2_opt_adam_mel32_chan2_BCE'
                            '_framelen64', 'vad', '8', '2', '0.001', 'adam',
                            'BCE', '(32, 64)', '2', '(2, 3)']
    ers = [float(x) for x in ours[1][-3:]]
    assert all(np.isfinite(ers)) and len(set(ers)) > 1
    assert len(rows) == 2 and rows[1][-3:] == [float(e) for e in ers]
    with open('sample_answer.json') as f:
        assert json.load(f)['task2_answer']
