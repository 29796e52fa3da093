"""The checks of tests/test_torch_mesh.py on CPU meshes of 3 and 4 ranks,
where a rank's share is not half the batch: the global batches are 24
(8 or 6 a rank), the fused step's 24 with grad_accum 2 and
steps_per_call 2, ``--bank_shard`` pads the 5 voices cyclically to 6 or 8
(2 a rank), AGC's clipped gradients go to 2 or 3 receivers, and
``evaluate(mesh=)`` scores 3 clips over 3 ranks, or over 4 with a dummy
clip. Each mesh's ranks are pinned to one torch thread. At 3 ranks the
float64 step held these bounds only once each rank differentiated its
share's loss over the mesh size (ROADMAP C17).

On the 3-rank mesh two more runs: one float32 fused step of full-width
se v9 pretrain on a global batch of 3 (one sample a rank, so each of the
U-Net's cross-replica BatchNorms sums three one-sample shares) against
the one-process step on the same three samples, loss within rel 1e-5
(float32: the BN statistics' reduction order differs; measured: the
loss equal, its speech and noise parts 2.4e-7 and 1.4e-7 apart); and
``TrainLoop.fit`` over a 2-chunk rotation (``build_streaming_banks``)
in float64 against the one-process fit on the global batches the ranks
draw from the same chunks, at tests/test_torch_mesh.py's bounds
(measured: the state 1.6e-13 of its peaks apart). The
one-process runs draw each rank's share with that rank's generator
(``_torch_mesh.Shares``). The ranks are held equal bit for bit.
"""

import numpy as np
import pytest
import torch

import _torch_mesh as tm
from test_torch_mesh import (
    _assert_jax, _rel, check_eval, check_fused, check_identical_ranks,
    check_per_replica, check_sharded_step, jax_mesh_run, make_inputs,
    one_process_run, run_ranks)

SIZES = (3, 4)
BATCH = 24
SE_CFG = dict(model_type='se', v=9, n_frame=tm.N_FRAME, n_chan=2,
              batch_size=3, pretrain=True)
STREAM_CFG = dict(model_type='vad', v=3, n_mels=tm.N_MELS,
                  n_frame=tm.N_FRAME, batch_size=BATCH, stream_chunks=2,
                  chunk_steps=1)
STREAM_FIT = (2, 2)          # epochs, steps an epoch
RUNS = ('sharded', 'fused_f32', 'fused_int8')
_meshes = {}


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(size: int, tmp_path_factory) -> dict:
    """The inputs, the ranks' results and the one-process runs of the
    ``size``-rank mesh, computed once."""
    if size not in _meshes:
        inputs = make_inputs(tmp_path_factory, BATCH, BATCH)
        if size == 3:
            inputs.update(se_cfg=SE_CFG, stream_cfg=STREAM_CFG,
                          stream_fit=STREAM_FIT)
        _meshes[size] = dict(
            size=size, inputs=inputs,
            ranks=run_ranks(inputs, size, tmp_path_factory.mktemp('mesh')),
            one=one_process_run(inputs))
    return _meshes[size]


@pytest.fixture(scope='module', params=SIZES, ids=lambda w: f'{w}_ranks')
def mesh(request, tmp_path_factory):
    return _mesh(request.param, tmp_path_factory)


@pytest.fixture(scope='module')
def mesh3(tmp_path_factory):
    return _mesh(3, tmp_path_factory)


def test_the_ranks_are_a_gloo_mesh_that_keeps_them_identical(mesh):
    check_identical_ranks(mesh['ranks'], mesh['size'],
                          RUNS + (('stream',) if mesh['size'] == 3 else ()))


def test_sharded_step_equals_the_one_process_step(mesh):
    check_sharded_step(mesh['inputs'], mesh['ranks'][0]['sharded'],
                       mesh['one'][0])


def test_per_replica_statistics_fail_that_bound(mesh):
    check_per_replica(mesh['ranks'], mesh['one'][0])


def test_sharded_step_matches_jax_make_sharded_train_step(mesh):
    ref = jax_mesh_run(mesh['inputs'], mesh['size'])
    for r in mesh['ranks']:
        _assert_jax(r['sharded'], ref)


def test_fused_mesh_step_accumulates_and_pads_the_voices(mesh):
    check_fused(mesh['ranks'], mesh['size'])


def test_evaluate_over_the_mesh_equals_one_process(mesh):
    check_eval(mesh['ranks'], mesh['one'][1])


def test_se_v9_fused_step_over_three_ranks_equals_one_process(mesh3):
    """One sample a rank: the loss and its parts within rel 1e-5 of the
    one-process step on the same 3 samples; the ranks' weights, BN
    statistics and metrics equal bit for bit after the step."""
    ranks = mesh3['ranks']
    got = ranks[0]['se']
    assert got['step'] == 1
    assert len({r['se']['digest'] for r in ranks}) == 1
    for r in ranks[1:]:
        assert all(np.array_equal(r['se']['logs'][0][k], got['logs'][0][k])
                   for k in got['logs'][0])
    ref = tm.se_step(SE_CFG, mesh3['inputs']['sources'], ranks=3)
    for k in ('loss', 'class_loss', 'speech_loss', 'noise_loss'):
        assert _rel(got['logs'][0][k], ref['logs'][0][k]) <= 1e-5, k


def test_bank_rotation_fit_over_three_ranks_equals_one_process(mesh3):
    """Two epochs of two steps over a 2-chunk rotation, float64: the
    rotation's cursor, the logs, the weights, BN statistics and Adam
    moments of the mesh's fit equal the one-process fit's on the same
    chunks and global batches (float64 within 1e-10 of each tensor's
    peak, the loss within 1e-10, the other metrics within 1e-6)."""
    got = mesh3['ranks'][0]['stream']
    ref = tm.stream_fit(STREAM_CFG, mesh3['inputs']['sources'], *STREAM_FIT,
                        ranks=3)
    assert (got['chunk'], got['dispatches']) == (ref['chunk'],
                                                 ref['dispatches']) == (0, 4)
    assert got['step'] == ref['step'] == 4
    assert len(got['logs']) == len(ref['logs']) == STREAM_FIT[0]
    for lg, lr in zip(got['logs'], ref['logs']):
        assert lg.keys() == lr.keys()
        assert _rel(lg['loss'], lr['loss']) <= 1e-10
        for k in lg:
            assert _rel(lg[k], lr[k]) <= 1e-6, k
    for part in ('sd', 'm', 'v'):
        assert got[part].keys() == ref[part].keys()
        for k in ref[part]:
            assert _rel(got[part][k], ref[part][k]) <= 1e-10, (part, k)
