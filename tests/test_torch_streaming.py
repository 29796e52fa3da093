"""Bank rotation of ``challenge_tpu_torch`` (data/streaming.py, the
``--stream_chunks`` and ``--chunk_steps`` flags, ``TrainLoop`` on a
rotation) against ``challenge_tpu/data/streaming.py``, on the CPU.

* Dealing: each chunk's items, lengths, energy masks, flat rows (without
  JAX's lane padding), int8 scales, labels, item count and
  ``contig_exact_frames`` equal JAX's ``build_streaming_banks`` for the same
  sources and seed, in 2-4 chunks and each bank dtype; every chunk has
  the same shapes.
* Cursor: ``current_chunk`` and ``dispatches`` over a run of
  ``next_banks()`` calls, and after ``restore_cursor(d)`` for every d,
  equal JAX's ``StreamingBanks``; the one slot ``next_banks()`` returns
  holds the current chunk after every swap.
* One chunk: a one-chunk rotation's features equal resident banks', bit
  for bit (tests/test_streaming.py:104).
* The loop and the CLIs take the rotation as JAX's do.

The slot's copies run on the CPU here; on the card they are the side
stream's uploads and the swap's device copy (chip_smoke.py phase 5i).
"""

import sys

import numpy as np
import pytest
import torch

from _helpers import DATA_FLAGS, make_datafiles
from _torch_parity import N_FRAME, N_MELS, small_sources, strip_flat
from challenge_tpu.data.streaming import (
    build_streaming_banks as jax_build_streaming_banks)
from challenge_tpu_torch.cli import sj_train, trainer
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.mixture import Banks
from challenge_tpu_torch.data.pipeline import FeatureFn, build_banks
from challenge_tpu_torch.data.specset import build_bank, remap_labels
from challenge_tpu_torch.data.streaming import (
    StreamingBanks, bank_tensors, build_streaming_banks)
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.train.loop import TrainLoop


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """As tests/test_torch_fused.py: on every core, each of the suite's
    workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sources(n_bg, n_vo, n_no, seed):
    """Random [257, T, 4] float32 sources: one background shorter than
    N_FRAME (so the background chunks wrap) and ragged clips."""
    rng = np.random.default_rng(seed)

    def specs(n, lo, hi):
        return [rng.standard_normal((257, int(t), 4)).astype(np.float32)
                for t in rng.integers(lo, hi, size=n)]
    bgs = specs(n_bg - 1, 70, 110) + specs(1, 40, 50)
    return bgs, specs(n_vo, 20, 50), rng.integers(0, 30, size=n_vo), \
        specs(n_no, 10, 25)


def _f32(flat):
    return (flat.float().numpy() if torch.is_tensor(flat)
            else np.asarray(flat, np.float32))


def _own_rows(bank, t_pad, wrap):
    """The rows a chunk's bank holds before the padding that makes the
    chunks' shapes equal (specset.build_bank's sizing)."""
    lens = bank.lens.numpy()
    if wrap is None or lens.min() >= wrap:
        return t_pad
    max_off = max(-(-wrap // max(int(t), 1)) * max(int(t), 1) - wrap
                  for t in lens)
    return max(t_pad, max_off + wrap)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('n_chunks,counts', [(2, (3, 5, 2)),
                                             (3, (7, 4, 3)),
                                             (4, (5, 11, 3))])
def test_chunks_equal_jax_dealing(n_chunks, counts, dtype):
    src = _sources(*counts, seed=n_chunks)
    jsb = jax_build_streaming_banks(*src, n_chunks=n_chunks,
                                    n_frame=N_FRAME, flat_dtype=dtype,
                                    seed=3, chunk_steps=1)
    psb = build_streaming_banks(*src, n_chunks=n_chunks, n_frame=N_FRAME,
                                flat_dtype=dtype, seed=3, chunk_steps=1,
                                device='cpu')
    assert psb.n_chunks == jsb.n_chunks == n_chunks
    shapes = [[(t.shape, t.dtype) for t in bank_tensors(c)]
              for c in psb.chunks]
    assert all(s == shapes[0] for s in shapes[1:])
    for jc, pc in zip(jsb.chunks, psb.chunks):
        np.testing.assert_array_equal(pc.voice_labels.numpy(),
                                      np.asarray(jc.voice_labels))
        for role, wrap in (('backgrounds', N_FRAME), ('voices', None),
                           ('noises', None)):
            jb, pb = getattr(jc, role), getattr(pc, role)
            assert pb.n == jb.lens.shape[0]
            np.testing.assert_array_equal(pb.lens.numpy(),
                                          np.asarray(jb.lens))
            np.testing.assert_array_equal(pb.pos_mask.numpy(),
                                          np.asarray(jb.pos_mask))
            assert pb.contig_exact_frames == jb.contig_exact_frames
            rows = _own_rows(pb, pb.pos_mask.shape[1], wrap)
            assert rows <= jb.flat.shape[1]
            np.testing.assert_array_equal(
                _f32(pb.flat[:, :rows]),
                strip_flat(_f32(jb.flat)[:, :rows], 4, 257))
            assert not pb.flat[:, rows:].any()       # shape padding only
            if dtype == 'int8':
                np.testing.assert_array_equal(pb.flat_scale.numpy(),
                                              np.asarray(jb.flat_scale))
            else:
                assert pb.flat_scale is None
    assert psb.chunks[0].backgrounds.contig_exact_frames == N_FRAME


@pytest.mark.parametrize('n_chunks,chunk_steps', [(2, 1), (3, 2), (4, 3)])
def test_cursor_equals_jax_and_the_slot_holds_the_current_chunk(
        n_chunks, chunk_steps):
    src = _sources(5, 6, 3, seed=7)
    kw = dict(n_chunks=n_chunks, n_frame=N_FRAME, chunk_steps=chunk_steps)
    jsb = jax_build_streaming_banks(*src, **kw)
    psb = build_streaming_banks(*src, **kw, device='cpu')
    seq, slots = [], set()
    for _ in range(3 * n_chunks * chunk_steps + 2):
        assert (psb.current_chunk, psb.dispatches) == \
            (jsb.current_chunk, jsb.dispatches)
        seq.append(psb.current_chunk)
        banks = psb.next_banks()
        jsb.next_banks()
        slots.add(id(banks))
        want = psb.chunks[seq[-1]]
        assert all(torch.equal(a, b) for a, b in
                   zip(bank_tensors(banks), bank_tensors(want)))
    assert len(slots) == 1 and set(seq) == set(range(n_chunks))
    for d in range(len(seq)):
        for sb in (jax_build_streaming_banks(*src, **kw),
                   build_streaming_banks(*src, **kw, device='cpu')):
            sb.restore_cursor(d)
            assert (sb.current_chunk, sb.dispatches) == (seq[d], d)
    # a restored cursor loads its chunk at the next use
    psb.restore_cursor(1)
    assert all(torch.equal(a, b) for a, b in zip(
        bank_tensors(psb.peek()), bank_tensors(psb.chunks[seq[1]])))


def test_one_chunk_rotation_synthesizes_as_resident_banks():
    """Bit for bit, for the same generator state."""
    bgs, vos, labels, nos = small_sources(4)
    resident = build_banks(bgs, vos, labels, nos, n_frame=N_FRAME,
                           device='cpu')
    host = Banks(build_bank(bgs, wrap_frames=N_FRAME, device='cpu'),
                 build_bank(vos, device='cpu'),
                 torch.from_numpy(remap_labels(labels, 3)),
                 build_bank(nos, device='cpu'))
    sb = StreamingBanks([host], device='cpu')
    cfg = Config(model_type='vad', v=3, n_frame=N_FRAME, batch_size=4)
    fn = FeatureFn(cfg, True, 'cpu')
    x1, y1 = fn(torch.Generator().manual_seed(9), sb.next_banks())
    x2, y2 = fn(torch.Generator().manual_seed(9), resident)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert sb.current_chunk == 0 and sb.dispatches == 1


def test_builder_guards():
    src = _sources(3, 4, 2, seed=1)
    with pytest.raises(ValueError, match='n_chunks >= 2'):
        build_streaming_banks(*src, n_chunks=1, n_frame=N_FRAME,
                              device='cpu')
    with pytest.raises(ValueError, match='no chunks'):
        StreamingBanks([], device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        build_streaming_banks(*src, n_chunks=2, n_frame=N_FRAME)


def _vad_loop(banks, val_banks=None, **kw):
    cfg = Config(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
                 batch_size=2, **kw)
    bundle = ModelBundle(VADModel(v=8, base_fsize=8, td_dim=32,
                                  n_mels=N_MELS), (N_MELS, N_FRAME, 2), cfg,
                         torch.device('cpu'))
    return TrainLoop(bundle, banks=banks, val_banks=val_banks)


def test_loop_streams_with_grad_accum_and_steps_per_call():
    """tests/test_streaming.py:165: each call of 2 steps of 2 microbatches
    draws from the chunk current at its dispatch; 3 steps an epoch round up
    to 2 calls, so 2 epochs make 4 dispatches over 2 chunks."""
    sb = build_streaming_banks(*small_sources(1), n_chunks=2,
                               n_frame=N_FRAME, chunk_steps=1, device='cpu')
    loop = _vad_loop(sb, grad_accum=2, steps_per_call=2)
    hist = loop.fit(epochs=2, steps_per_epoch=3, validation_steps=1,
                    verbose=0)
    assert len(hist) == 2 and np.isfinite(hist[-1]['loss'])
    assert 'val_loss' not in hist[-1]       # validation needs val_banks
    assert loop.state.step == 2 * loop.steps_per_fused_epoch(3) == 8
    assert sb.dispatches == 4 and sb.current_chunk == 0


def test_loop_validates_on_val_banks_else_the_current_chunk():
    sb = build_streaming_banks(*small_sources(1), n_chunks=2,
                               n_frame=N_FRAME, chunk_steps=1, device='cpu')
    val = build_banks(*small_sources(2), n_frame=N_FRAME, device='cpu')
    assert _vad_loop(sb, val)._val_banks() is val
    loop = _vad_loop(sb)
    assert loop.streaming and loop._val_banks() is sb.peek()
    assert sb.dispatches == 0
    hist = _vad_loop(sb, val).fit(epochs=1, steps_per_epoch=2,
                                  validation_steps=1, verbose=0)
    assert np.isfinite(hist[0]['val_loss'])


def _capture_loops(monkeypatch):
    loops = []
    init = TrainLoop.__init__
    monkeypatch.setattr(TrainLoop, '__init__', lambda self, *a, **kw: (
        init(self, *a, **kw), loops.append(self))[0])
    return loops


@pytest.mark.parametrize('bank_dtype', ['float32', 'int8'])
def test_sj_train_streams_the_training_set(tmp_path, monkeypatch,
                                           bank_dtype):
    """tests/test_streaming.py:223: ``--stream_chunks 2 --chunk_steps 2``
    trains on the rotation and validates on resident test banks."""
    monkeypatch.chdir(tmp_path)
    # no tensorboard writer: its import pulls in TensorFlow here
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    make_datafiles(tmp_path)
    loops = _capture_loops(monkeypatch)
    run = sj_train.main(['--model_type', 'vad', '--v', '3', '--n_mels',
                         str(N_MELS), '--n_frame', str(N_FRAME),
                         '--batch_size', '2', '--epochs', '1',
                         '--steps_per_epoch', '4', '--stream_chunks', '2',
                         '--chunk_steps', '2', '--bank_dtype', bank_dtype,
                         '--datapath', str(tmp_path), '--device', 'cpu']
                        + DATA_FLAGS)
    (loop,) = loops
    assert loop.streaming and loop.banks.n_chunks == 2
    assert loop.banks.chunk_steps == 2 and loop.banks.dispatches == 4
    assert loop.banks.chunks[0].voices.flat.dtype == {
        'float32': torch.float32, 'int8': torch.int8}[bank_dtype]
    assert isinstance(loop.val_banks, Banks)
    assert (tmp_path / f'{run}.csv').exists()


@pytest.mark.parametrize('stream_chunks', [2, 1])
def test_trainer_streams_in_banks_mode(tmp_path, monkeypatch,
                                       stream_chunks):
    """``--stream_chunks 2`` trains the density model in banks mode on the
    rotation (cli/trainer.py:175-181); ``--stream_chunks 1`` keeps the
    iterator mode, as JAX's does."""
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    loops = _capture_loops(monkeypatch)
    trainer.main(['--name', 'dens', '--model', 'EfficientNetB0', '--n_chan',
                  '2', '--n_mels', str(N_MELS), '--n_frame', str(N_FRAME),
                  '--batch_size', '2', '--epochs', '2', '--steps_per_epoch',
                  '1', '--stream_chunks', str(stream_chunks),
                  '--datapath', str(tmp_path), '--device', 'cpu']
                 + DATA_FLAGS)
    (loop,) = loops
    assert loop.fused == loop.streaming == (stream_chunks == 2)
    assert loop.state.step == 2
    if loop.streaming:
        assert loop.train_step.features.density
        assert loop.banks.dispatches == 2
    assert (tmp_path / 'dens_SWA.h5').exists()
