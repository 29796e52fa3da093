"""The se cell (``se_v9.fit``, kind ``fit_se``) end to end on the CPU at
``small.py``'s size: the program agrees with the se reference at the
cell's limits, and with the program broken underneath (half of the batch
left out of the loss, the head left unfrozen) it reads ``correct`` false.
A traced run counts the se triple's work of every batch of its window; on
the card it yields the cell's two new U-Net metrics and the synthesis
kernels' roofline share (``synth_roofline_pct.fit``) over the se triple. The U-Net readers
(``metrics/unet.py`` and its two metrics) are read on synthetic traces, as
``test_h100_bench_phases.py`` reads the phase readers."""

from __future__ import annotations

import pytest
import torch

import challenge_tpu_torch.train.losses as losses
from challenge_tpu_torch.models.registry import ModelBundle
from h100_bench.harness import metric_reader
from h100_bench.kinds import fit_se
from h100_bench.metrics.unet import MARKS
from h100_bench.run import run_cell
from h100_bench.tests.small import small_cell
from h100_bench.trace import Trace

CELL = 'se_v9.fit'
NEW = ('unet_forward_ms.fit_se', 'unet_backward_ms.fit_se',
       'synth_roofline_pct.fit')
U = 1_000_000
FORWARD = metric_reader('unet_forward_ms.fit_se')
BACKWARD = metric_reader('unet_backward_ms.fit_se')


def test_program_agrees_with_reference():
    cell = small_cell(CELL)
    result = run_cell(cell)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert result['checks']['frozen_change']['value'] == 0.0
    assert set(result['checks']) == set(cell.limits)
    assert set(result['metrics']) == {m['name'] for m in cell.end_to_end}


def _half_batch(monkeypatch):
    """The composite loss over the first half of the batch only."""
    make = losses.make_se_loss

    def half(cls_loss):
        loss = make(cls_loss)

        def _loss(y, p):
            b = p[0].shape[0] // 2
            return loss(tuple(t[:b] for t in y), tuple(t[:b] for t in p))
        return _loss
    monkeypatch.setattr(losses, 'make_se_loss', half)


def _unfrozen_head(monkeypatch):
    """The freeze mask lets every gradient through."""
    monkeypatch.setattr(ModelBundle, 'trainable_mask',
                        lambda self: [True] * len(list(
                            self.module.parameters())))


@pytest.mark.parametrize('fault, over', [(_half_batch, 'grad_gap'),
                                         (_unfrozen_head, 'frozen_change')],
                         ids=['half_batch', 'unfrozen_head'])
def test_fault_reads_not_correct(monkeypatch, fault, over):
    """Each fault reads ``correct`` false, over the limit it must break
    among others: the unfrozen head over ``frozen_change``'s 0.0."""
    fault(monkeypatch)
    result = run_cell(small_cell(CELL))
    assert not result['correct'], result['checks']
    check = result['checks'][over]
    assert check['value'] > check['limit'], check


def test_traced_run_counts_the_windows_se_work():
    """A traced run counts the se triple's work of every training and
    validation batch of its window, and its roofline's bound."""
    cell = small_cell(CELL)
    cell.trace = True
    out = fit_se.run(cell)
    info, t = out['info'], cell.traffic
    assert info['synth_draws_counted'] == info['epochs'] * (
        t['steps_per_epoch'] + t['validation_steps'])
    assert out['ctx']['synth_bound_s'] > 0
    assert out['ctx']['fwd_flops'] > 0


@pytest.mark.cuda
def test_traced_run_yields_the_new_metrics(cuda_device):
    cell = small_cell(CELL, device=cuda_device)
    cell.trace = True
    result = run_cell(cell)
    assert result['correct'], result['checks']
    got = result['metrics']
    assert set(NEW) <= set(got), got
    assert 0 < got['synth_roofline_pct.fit']['value'] <= 100
    assert got['unet_forward_ms.fit_se']['value'] \
        <= got['step_forward_ms.fit']['value']
    assert result['info']['launches_a_step']['synth_se_f32'] == 1.0


def _mark(name, t):
    return (name, t * U, (t + 1) * U)


def _op(t0, t1, name='kernel'):
    return (name, t0 * U, t1 * U)


def train_step(t):
    """One training step from ``t``, 100 units long: a forward of 30 busy
    units, 20 of them inside the U-Net's marks; a backward of 50, 35 of
    them after the U-Net backward's mark; an update of 8."""
    return [
        _mark('mark_forward_begin', t), _op(t + 1, t + 6),
        _mark('mark_unet_begin', t + 6), _op(t + 7, t + 27),
        _mark('mark_unet_end', t + 27), _op(t + 28, t + 33),
        _mark('mark_forward_end', t + 33),
        _mark('mark_backward_begin', t + 34), _op(t + 35, t + 50),
        _mark('mark_unet_backward_begin', t + 50), _op(t + 51, t + 86),
        _mark('mark_backward_end', t + 86),
        _mark('mark_update_begin', t + 88), _op(t + 89, t + 97),
        _mark('mark_update_end', t + 98)]


def val_step(t):
    """One validation step from ``t``: its U-Net counts in no training
    forward."""
    return [
        _mark('mark_val_forward_begin', t), _mark('mark_unet_begin', t + 1),
        _op(t + 2, t + 22), _mark('mark_unet_end', t + 22),
        _mark('mark_val_forward_end', t + 24)]


def readings(trace):
    ctx = {'kind': 'fit', 'trace': trace}
    return FORWARD(ctx), BACKWARD(ctx)


def test_unet_readers_read_their_marks_a_training_step():
    """Two training steps and a validation step: the U-Net's forward is
    its busy time inside the training forwards, its backward the busy time
    from its mark to the backward's end, each over the two steps; the
    marks themselves are not busy time."""
    ops = train_step(0) + val_step(100) + train_step(130)
    assert readings(Trace(ops, [], (0, 240 * U))) == (20.0, 35.0)


def test_a_trace_without_unet_marks_reads_nothing():
    ops = [op for op in train_step(0) if 'unet' not in op[0]]
    assert readings(Trace(ops, [], (0, 100 * U))) == (None, None)
    assert readings(None) == (None, None)


def test_the_readers_share_one_read_of_the_window(monkeypatch):
    import h100_bench.metrics.unet as unet
    calls = []
    read = unet._read
    monkeypatch.setattr(unet, '_read',
                        lambda trace: calls.append(1) or read(trace))
    ctx = {'kind': 'fit', 'trace': Trace(train_step(0), [], (0, 100 * U))}
    assert (FORWARD(ctx), BACKWARD(ctx)) == (20.0, 35.0) and len(calls) == 1


@pytest.mark.parametrize('name', MARKS)
def test_unet_marks_carry_no_synthesis_substring(name):
    """The roofline readers find the synthesis kernels by ``synth_``; a
    mark must not be one of them."""
    assert 'synth_' not in name
    trace = Trace([_mark(name, 0)], [], (0, 10 * U))
    assert trace.op_seconds('synth_') == []


def test_se_work_counts_each_byte_once():
    """The se triple's bytes: the background window, the active clip rows
    inside the window and the three written windows, 4 bytes each, and the
    slot tables; its operations 3 a clip element."""
    from h100_bench.metrics.work_se import se_work
    from h100_bench.reference.data import Draws
    d = Draws(n_frame=8, bidx=torch.zeros(1, dtype=torch.int32),
              boff=torch.zeros(1, dtype=torch.int32),
              vidx=torch.zeros((1, 2), dtype=torch.int32),
              vshift=torch.tensor([[2, -3]]), vw=torch.tensor([[1.0, 0.0]]),
              vlens=torch.tensor([[4, 9]]),
              nidx=torch.zeros((1, 1), dtype=torch.int32),
              nshift=torch.tensor([[6]]), nw=torch.tensor([[0.5]]),
              nlens=torch.tensor([[5]]))
    rows = 4 + 2                     # voice 0 whole, the noise's 2 rows
    width = 10
    table = 2 * 4 + 4 * 2 * 4 + 4 * 1 * 4
    assert se_work(d, width) == (4 * (8 * width + rows * width
                                      + 3 * 8 * width) + table,
                                 3 * rows * width)
