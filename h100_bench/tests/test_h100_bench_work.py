"""The frozen work counts: the configurations' forward FLOPs, the MFU's
count of a step (3 forwards, never the flop counter's backward), and the
synthesis work of a batch's draws."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench.harness import cell_files, load_manifest, metric_reader
from h100_bench.metrics.work import forward_flops, synth_bound_s, synth_work

MANIFEST = load_manifest()


def config(name: str) -> dict:
    cell = next(w['name'] for w in MANIFEST['workloads']
                if w['config'] == name)
    return cell_files(MANIFEST, cell).config


def build(cfg):
    return importlib.import_module(
        f"h100_bench.reference.{cfg['reference']}").build


@pytest.mark.parametrize('name, gflop, params', [
    ('vad_v8', 226.1, 20_320_547), ('density_b4', 125.7, 17_564_315)])
def test_forward_flops_at_batch_12(name, gflop, params):
    cfg = config(name)
    assert cfg['model']['batch_size'] == 12
    assert round(forward_flops(build(cfg), cfg) / 1e9, 1) == gflop
    with torch.device('meta'):
        module = build(cfg)(cfg)
    assert sum(p.numel() for p in module.parameters()) == params
    assert cfg['model']['parameters'] == params


def test_mfu_counts_three_forwards_not_the_counters_backward():
    """The flop counter's backward of the B4's depthwise convolutions is
    far above twice the forward; the MFU reads 3 forwards a training step
    and one a validation step, whatever the counter says."""
    cfg = config('density_b4')
    cfg = {**cfg, 'model': {**cfg['model'], 'batch_size': 2,
                            'n_frame': 64}}
    fwd = forward_flops(build(cfg), cfg)
    with torch.device('meta'):
        module = build(cfg)(cfg).eval()
        x = torch.empty(2, 80, 64, 2, requires_grad=True)
    counter = FlopCounterMode(display=False)
    with counter:
        module(x).sum().backward()
    assert counter.get_total_flops() > 10 * fwd
    read = metric_reader('step_mfu_pct.fit')
    ctx = {'kind': 'fit', 'window_s': 2.0, 'train_steps': 10,
           'val_steps': 4, 'fwd_flops': fwd, 'peak_flops': 1e12}
    assert read(ctx) == pytest.approx(100 * fwd * 34 / 2.0 / 1e12)


def test_synth_work_counts_each_byte_once():
    d = SimpleNamespace(
        n_frame=4, bidx=torch.zeros(2, dtype=torch.int32),
        vshift=torch.tensor([[1], [-2]]), vw=torch.tensor([[0.5], [0.0]]),
        vlens=torch.tensor([[3], [3]]), nshift=None, nw=None, nlens=None)
    nbytes, flops = synth_work(d, width=6)
    rows = 3                    # sample 0: rows 1..3 of its voice; 1: none
    window, out = 2 * 4 * 6, 2 * 4 * 3
    assert nbytes == 4 * (window + rows * 6) + 4 * out + 2 * 2 * 4 + 4 * 2 * 4
    assert flops == 2 * rows * 6 + 4 * out
    assert synth_bound_s([(3.35e12, 0.0)]) == pytest.approx(1.0)
