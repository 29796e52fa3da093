"""Each cell end to end on the CPU at a small size (``small.py``): the
run's entry and kinds drive the program, and the reference agrees with it
at the cell's limits; then the same run with the program broken
underneath, once for each fault the cell can have, reads ``correct``
false; and a traced run reads what its per-layer metrics need. The
harness's look for a card is skipped (``run_cell`` is what ``main`` calls
after it)."""

from __future__ import annotations

import pytest
import torch

import challenge_tpu_torch.parallel.train as fused
import challenge_tpu_torch.train.losses as losses
import challenge_tpu_torch.train.state as state
from h100_bench.run import run_cell
from h100_bench.tests.small import small_cell

CELLS = ['vad_v8.fit', 'density_b4.fit']


@pytest.mark.parametrize('name', CELLS)
def test_program_agrees_with_reference(name):
    result = run_cell(small_cell(name))
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert set(result['metrics']) == {m['name'] for m in
                                      small_cell(name).end_to_end}


def _patch_update(monkeypatch, wrap):
    """Every step's update is ``wrap(update_fn)`` of the program's."""
    def grad_update(*args, **kwargs):
        grad_fn, update_fn = make(*args, **kwargs)
        return grad_fn, wrap(update_fn)
    make = state.make_grad_update
    monkeypatch.setattr(fused, 'make_grad_update', grad_update)
    monkeypatch.setattr(state, 'make_grad_update', grad_update)


def _unchanged_state(monkeypatch):
    """Every step returns its state unchanged: the update does nothing."""
    def wrap(update_fn):
        def unchanged(st, grads):
            st.step += 1
        return unchanged
    _patch_update(monkeypatch, wrap)


def _one_leaf_doubled(monkeypatch):
    """The largest parameter moves double in every step, the others as
    they should (the optimizer or AGC wrong on one layer)."""
    def wrap(update_fn):
        def doubled(st, grads):
            p = max(st.module.parameters(), key=lambda t: t.numel())
            before = p.detach().clone()
            update_fn(st, grads)
            with torch.no_grad():
                p.add_(p - before)
        return doubled
    _patch_update(monkeypatch, wrap)


def _half_batch(monkeypatch):
    """The loss is the mean over the first half of the batch only."""
    bce = losses.binary_crossentropy
    monkeypatch.setitem(losses.CLASS_LOSSES, 'BCE',
                        lambda y, p: bce(y[:y.shape[0] // 2],
                                         p[:p.shape[0] // 2]))
    dens = losses.density_loss

    def density_loss(**kw):
        loss = dens(**kw)
        return lambda y, p: loss(y[:y.shape[0] // 2], p[:p.shape[0] // 2])
    monkeypatch.setattr(losses, 'density_loss', density_loss)
    import challenge_tpu_torch.cli.trainer as trainer
    monkeypatch.setattr(trainer, 'density_loss', density_loss)


@pytest.mark.parametrize('name, fault', [
    ('vad_v8.fit', _unchanged_state), ('vad_v8.fit', _half_batch),
    ('vad_v8.fit', _one_leaf_doubled),
    ('density_b4.fit', _unchanged_state), ('density_b4.fit', _half_batch),
    ('density_b4.fit', _one_leaf_doubled)],
    ids=lambda x: x if isinstance(x, str) else x.__name__.strip('_'))
def test_fault_reads_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = run_cell(small_cell(name))
    assert not result['correct'], result['checks']


def test_step1_change_catches_one_leaf_moved_double(monkeypatch):
    """vad v8 compares the first step's change leaf by leaf: one leaf
    moved double reads over its limit there."""
    _one_leaf_doubled(monkeypatch)
    check = run_cell(small_cell('vad_v8.fit'))['checks']['change_gap_step1']
    assert check['value'] > check['limit'], check


@pytest.mark.parametrize('name', CELLS)
def test_traced_run_counts_the_windows_draws(name):
    """A traced run counts the synthesis work of every training and
    validation batch of its window's epochs."""
    cell = small_cell(name)
    cell.trace = True
    result = run_cell(cell)
    assert result['correct'], result['checks']
    info, t = result['info'], cell.traffic
    assert info['synth_draws_counted'] == info['epochs'] * (
        t['steps_per_epoch'] + t['validation_steps'])
    assert 'step_mfu_pct.fit' in result['metrics']


def test_no_card_no_result(capsys):
    """Without a CUDA device the run exits non-zero and prints no
    result."""
    from h100_bench.run import main
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is visible')
    assert main(['--workload', 'vad_v8.fit', '--seed', '1', '--seconds',
                 '1']) != 0
    assert capsys.readouterr().out == ''


def test_forbidden_modules_compared_by_whole_name(monkeypatch):
    import sys
    from h100_bench.run import forbidden_modules
    assert 'challenge_tpu_torch' in sys.modules
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'challenge_tpu.config', object())
    assert forbidden_modules() == ['challenge_tpu']
