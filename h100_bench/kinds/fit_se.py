"""The se fit cells: whole training epochs of ``TrainLoop.fit`` on the se
v9 cascade, as ``kinds/fit.py`` runs the other fit cells (its
``_program``: set-up's ``CHECK_STEPS`` checked epochs of one training and
one validation step, then the window), in banks mode, against the se
reference (``reference/se.py``, ``se_data.py``, ``se_train.py``).

The comparison is ``fit.compare``'s over the trained leaves only (the
U-Net's in pretrain): the reference hands its optimizer those leaves, so
its gradients and changes are theirs. One more check, ``frozen_change``:
the largest change of any element of the frozen half's parameters and
BatchNorm buffers (``vad.*`` in pretrain) in the program after the
checked steps, read from the program's live module; frozen means
untouched, so its limit is 0.0. ``fwd_flops`` is the se reference's
forward at the se input shape (``work_se.forward_flops``), and a traced
run counts the se triple's work of every batch of the window, from the
seeds (``work_se.se_work``), as ``synth_bound_s`` for
``synth_roofline_pct.fit``.
"""

from __future__ import annotations

import gc
import importlib
import math
import time

import torch

from h100_bench import gen
from h100_bench.harness import Cell
from h100_bench.kinds.fit import (
    CHECK_STEPS, _generator, _merged, _norm, _phase_seed, _program, compare,
    program_seed)
from h100_bench.metrics.work import PEAK_FLOPS, synth_bound_s
from h100_bench.metrics.work_se import forward_flops, se_work
from h100_bench.reference import data as ref_data
from h100_bench.reference import se as ref_se
from h100_bench.reference import se_data
from h100_bench.reference import se_train
from h100_bench.reference import train as ref_train
from h100_bench.trace import Tracer


def frozen_keys(module, pretrain: bool):
    """The state dict's keys of the frozen half."""
    prefix = 'vad.' if pretrain else 'se.'
    return [k for k in module.state_dict() if k.startswith(prefix)]


def largest_change(state: dict, start: dict, keys) -> float:
    """The largest |state[k] - start[k]| over the elements of ``keys``."""
    return max(float((state[k] - start[k]).abs().max()) for k in keys)


class _FrozenWatch:
    """The configuration's entry as ``fit._program`` is handed it: its
    ``build_fit``, with each ``fit`` call of the loop followed by a read of
    the frozen half's largest change from ``weights`` (``changes``, one a
    call: the first checked step, the other checked steps, the window)."""

    def __init__(self, entry, weights: dict, pretrain: bool):
        self.entry, self.weights, self.pretrain = entry, weights, pretrain
        self.changes = []

    def build_fit(self, *args, **kwargs):
        prog = self.entry.build_fit(*args, **kwargs)
        loop, fit = prog.loop, prog.loop.fit
        keys = frozen_keys(loop.state.module, self.pretrain)

        def watched(*a, **kw):
            logs = fit(*a, **kw)
            state = loop.state.module.state_dict()
            self.changes.append(largest_change(state, self.weights, keys))
            return logs
        loop.fit = watched
        return prog


def run(cell: Cell) -> dict:
    cfg, traffic = cell.config, cell.traffic
    if traffic['mode'] != 'banks':
        raise ValueError(f"fit_se runs banks mode, not {traffic['mode']!r}")
    dev = torch.device(cell.device)
    tracer = Tracer(cell.trace)
    seed = program_seed(cell.seed)
    entry = importlib.import_module(f"h100_bench.entries.{cfg['entry']}")
    with torch.device('meta'):
        shapes = ref_se.build(cfg)
    train_src, test_src = gen.fit_sources(seed, traffic)
    weights = gen.draw_weights(shapes, seed, dev)
    watch = _FrozenWatch(entry, weights, cfg['train']['pretrain'])

    prog = _program(cell, watch, weights, seed, train_src, test_src, tracer)
    trace = tracer.result()
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    steps, val_steps = traffic['steps_per_epoch'], traffic['validation_steps']
    epochs = len(prog['ends'])
    window_s = prog['ends'][-1] - prog['begins'][0]
    bad_epochs = sum(1 for x in prog['losses'] if not math.isfinite(x))
    prog['frozen_change'] = watch.changes[1]
    # the yardstick's own count, after the window: no step needs it, so
    # it stays out of setup_s
    fwd_flops = forward_flops(ref_se.build, cfg)

    ref = reference(cfg, weights, train_src, test_src, seed, dev,
                    window=(epochs, steps, val_steps) if cell.trace else None)
    readings, left_out = readings_of(prog, ref)
    width = train_src[0][0].shape[0] * train_src[0][0].shape[2]
    works = [se_work(d, width) for d in ref['window_draws']]
    ctx = {
        'kind': 'fit', 'trace': trace, 'window_s': window_s,
        'train_steps': epochs * steps, 'val_steps': epochs * val_steps,
        'fwd_flops': fwd_flops,
        'peak_flops': PEAK_FLOPS[cfg['compute_dtype']],
        'synth_bound_s': synth_bound_s(works) if works else None,
    }
    samples = epochs * steps * cfg['model']['batch_size']
    return {
        'e2e': {'setup_s': prog['setup_s'],
                'fit_samples_per_s': samples / window_s,
                'peak_gib': prog['peak'] / 2 ** 30},
        'attempted': epochs * steps, 'failed': bad_epochs * steps,
        'checks': {k: readings[k] for k in cell.limits},
        'ctx': ctx, 'memory_peak_bytes': prog['peak'],
        'info': {'epochs': epochs, 'window_start_unix': prog['start_unix'],
                 'epoch_s': [e - b for b, e in zip(prog['begins'],
                                                   prog['ends'])],
                 'leaves_left_out': left_out, 'readings': readings,
                 'frozen_change_after_window': watch.changes[-1],
                 # the program's kernel launches a step (training and
                 # validation), replays included: synth_se_f32's is 1.0
                 'launches_a_step': {
                     k: v / (epochs * (steps + val_steps))
                     for k, v in prog['launches'].items()},
                 'synth_draws_counted': len(works),
                 'synth_launches_traced': (len(trace.op_seconds('synth_'))
                                           if trace is not None else None),
                 'reference_s': ref['seconds'],
                 'trace_read_s': tracer.read_s},
    }


def readings_of(prog: dict, ref: dict):
    """``fit.compare``'s readings over the reference's leaves, with
    ``frozen_change``, and the leaves left out of the change's gaps."""
    readings, left_out = compare(prog, ref)
    readings['frozen_change'] = prog['frozen_change']
    return readings, left_out


def reference(cfg: dict, weights: dict, train_src, test_src, seed: int,
              dev, tf32: bool = False, window=None) -> dict:
    """The se reference's three steps from ``weights`` on the same
    batches, as ``fit.reference`` runs the others in banks mode: per-step
    losses and validation losses, the first step's clipped gradient norms
    and the change norms after the first step and after the three, of the
    trained leaves (by name); the frozen half's largest change after the
    three (``frozen_change``); with ``window`` = (epochs, steps,
    validation steps), the draws of every batch of the window's epochs.
    ``tf32`` computes it with TF32 matrix products and convolutions: the
    control."""
    t0 = time.perf_counter()
    mc = _merged(cfg)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = False
    try:
        module = ref_se.build(cfg).to(dev)
        module.load_state_dict(weights)
        n_classes, n_frame = mc['n_classes'], mc['n_frame']
        banks = ref_data.build_banks(*train_src, n_frame, n_classes, dev)
        val_banks = ref_data.build_banks(*test_src, n_frame, n_classes, dev)
        names, params, transposed = se_train.trained(module)
        start = {n: p.detach().clone() for n, p in zip(names, params)}
        opt = ref_train.Optimizer(params, cfg['train'])

        def changes():
            return {n: _norm(p.detach() - start[n])
                    for n, p in zip(names, params)}
        losses, vals, first, change1 = [], [], None, None
        for epoch in range(CHECK_STEPS):
            tgen = _generator(dev, _phase_seed(seed, epoch, True))
            vgen = _generator(dev, _phase_seed(seed, epoch, False))
            x, y = se_data.batch(tgen, banks, mc)
            loss, grads = se_train.train_step(module, opt, transposed, x, y)
            losses.append(float(loss))
            if first is None:
                first = {n: _norm(g) for n, g in zip(names, grads)}
                change1 = changes()
            xv, yv = se_data.batch(vgen, val_banks, mc)
            vals.append(float(se_train.val_loss(module, xv, yv)))
        change = changes()
        frozen = largest_change(
            module.state_dict(), weights,
            frozen_keys(module, cfg['train']['pretrain']))
        draws = []
        n_epochs, steps, val_steps = window or (0, 0, 0)
        for epoch in range(CHECK_STEPS, CHECK_STEPS + n_epochs):
            tgen = _generator(dev, _phase_seed(seed, epoch, True))
            vgen = _generator(dev, _phase_seed(seed, epoch, False))
            draws += [se_data.batch_draws(tgen, banks, mc)
                      for _ in range(steps)]
            draws += [se_data.batch_draws(vgen, val_banks, mc)
                      for _ in range(val_steps)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved
    return {'loss': losses, 'val': vals, 'first_grad': first,
            'change1': change1, 'change': change, 'frozen_change': frozen,
            'window_draws': draws, 'seconds': time.perf_counter() - t0}
