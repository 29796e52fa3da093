"""The fit cells: whole training epochs of ``TrainLoop.fit``, as the
configuration's CLI runs them, closed loop.

Set-up draws the sources and the weights from the seed, builds the
program (``entries/<entry>.py``), loads the weights and drives the loop
through ``CHECK_STEPS`` epochs of one training and one validation step
each, by the window's own call (``fit``) and feed: the first of them
captures the CUDA graphs, and the three steps are what the reference
follows. The window then runs ``fit`` on the same loop, epochs of the
traffic's steps, and ends with the first epoch that finishes after
``--seconds``. ``fit_samples_per_s`` is the training samples of those
epochs over their wall time, validation included. A traced run also
counts the synthesis work of every batch the window drew, from the seeds.

Once the window has closed and the peak memory is read, the program is
freed and the reference (``reference/``) draws the same three batches from
the same seeds, steps its copy of the model from the same weights and
compares: each step's loss, the first step's gradient as the optimizer got
it (the program's from its first moment, m / (1 - beta_1)), each
parameter's change after the first step and after the three, and each
step's validation loss.
"""

from __future__ import annotations

import gc
import importlib
import math
import time

import numpy as np
import torch

from h100_bench import gen
from h100_bench.harness import Cell, leaf_gaps, process_seconds, rel_gap
from h100_bench.metrics.work import (
    PEAK_FLOPS, forward_flops, synth_bound_s, synth_work)
from h100_bench.reference import data as ref_data
from h100_bench.reference import train as ref_train
from h100_bench.trace import Tracer

CHECK_STEPS = 3
MAX_EPOCHS = 100000
BETA_1 = 0.9
# leaves whose first reference gradient is under this share of the median
# leaf's move by round-off alone and are left out of the change's gap
STILL_LEAF = 1e-3


class _Window:
    """The ``fit`` callback of the window: times each epoch and stops the
    loop after the first epoch that ends ``seconds`` after the window's
    start."""

    def __init__(self, seconds: float, tracer: Tracer):
        self.seconds, self.tracer = seconds, tracer
        self.loop, self.start, self.begins, self.ends = None, None, [], []
        self.losses, self._span = [], None

    def set_loop(self, loop):
        self.loop = loop

    def on_train_begin(self):
        self.start = time.perf_counter()

    def on_epoch_begin(self, epoch):
        self.begins.append(time.perf_counter())
        self._span = self.tracer.span('fit.epoch')
        self._span.__enter__()

    def on_epoch_end(self, epoch, logs):
        self._span.__exit__(None, None, None)
        self.ends.append(time.perf_counter())
        self.losses.append(logs['loss'])
        if self.ends[-1] - self.start >= self.seconds:
            self.loop.stop_training = True

    def on_train_end(self, logs=None):
        pass


class _SpannedIter:
    """The training iterator handed to ``fit`` in iterator mode: each
    ``next()`` of the program's pipeline in the span ``pipeline.next``."""

    def __init__(self, inner, tracer: Tracer):
        self.inner, self.tracer = inner, tracer

    def __iter__(self):
        it = iter(self.inner)
        while True:
            with self.tracer.span('pipeline.next'):
                batch = next(it)
            yield batch


def _merged(cfg: dict) -> dict:
    return {**cfg['model'], **cfg['train']}


def _phase_seed(seed: int, epoch: int, training: bool) -> int:
    """The program's banks-mode generator seed of (seed, epoch, phase)."""
    return int(np.random.SeedSequence([seed, epoch, int(training)])
               .generate_state(1)[0])


def _dropout_seed(seed: int, epoch: int) -> int:
    """The program's stochastic-depth generator seed of an epoch."""
    return int(np.random.SeedSequence([seed, epoch], spawn_key=(1,))
               .generate_state(1)[0])


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _norm(t) -> float:
    """The L2 norm, summed in float64: a float32 sum over a million
    clipped, equal gradient elements rounds at 1e-3."""
    return float(t.double().norm())


def program_seed(seed: int) -> int:
    """The seed the program's CLI is given: the run's seed as a
    non-negative 63-bit integer."""
    return seed % (1 << 63)


def _program(cell: Cell, entry, weights: dict, seed: int, train_src,
             test_src, tracer: Tracer) -> dict:
    """Set-up's checked steps and the window, on the program; returns
    plain numbers, so that the program is freed when it returns."""
    from challenge_tpu_torch.ops import cuda as port_cuda
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(cell.device)
    prog = entry.build_fit(cfg, seed, dev, train_src, test_src)
    loop = prog.loop
    loop.set_weights(weights)
    names = [n for n, _ in loop.state.module.named_parameters()]
    params = dict(loop.state.module.named_parameters())
    train_iter = (None if prog.train_iter is None
                  else _SpannedIter(prog.train_iter, tracer))

    def fit(**kw):
        return loop.fit(train_iter, validation_iter=prog.val_iter,
                        verbose=0, **kw)

    # the checked steps, through the window's own call and feed
    logs = fit(epochs=1, steps_per_epoch=1, validation_steps=1)
    # a parameter the optimizer never stepped has no first moment: 0
    moments = loop.state.optimizer.state
    first_grad = {n: _norm(moments[params[n]]['m']) / (1 - BETA_1)
                  if 'm' in moments.get(params[n], {}) else 0.0
                  for n in names}
    change1 = {n: _norm(params[n].detach() - weights[n]) for n in names}
    logs += fit(epochs=CHECK_STEPS, initial_epoch=1, steps_per_epoch=1,
                validation_steps=1)
    change = {n: _norm(params[n].detach() - weights[n]) for n in names}
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    setup_s = process_seconds()

    # the window
    window = _Window(cell.seconds, tracer)
    run_epoch = loop.run_epoch

    def spanned(data_iter, n, training, epoch=0):
        with tracer.span('fit.train' if training else 'fit.val'):
            return run_epoch(data_iter, n, training, epoch)
    loop.run_epoch = spanned
    port_cuda.reset_launch_counts()
    start_unix = time.time()
    with tracer.window():
        fit(epochs=CHECK_STEPS + MAX_EPOCHS, initial_epoch=CHECK_STEPS,
            steps_per_epoch=traffic['steps_per_epoch'],
            validation_steps=traffic['validation_steps'],
            callbacks=[window])
    return {
        'names': names, 'first_grad': first_grad, 'change': change,
        'change1': change1,
        'loss': [h['loss'] for h in logs],
        'val': [h['val_loss'] for h in logs], 'setup_s': setup_s,
        'start_unix': start_unix,
        'begins': window.begins, 'ends': window.ends,
        'losses': window.losses,
        'launches': dict(port_cuda.LAUNCHES),
        'peak': (torch.cuda.max_memory_allocated(dev)
                 if dev.type == 'cuda' else 0),
    }


def run(cell: Cell) -> dict:
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(cell.device)
    tracer = Tracer(cell.trace)
    seed = program_seed(cell.seed)
    entry = importlib.import_module(f"h100_bench.entries.{cfg['entry']}")
    ref_model = importlib.import_module(
        f"h100_bench.reference.{cfg['reference']}")
    with torch.device('meta'):
        shapes = ref_model.build(cfg)
    fwd_flops = forward_flops(ref_model.build, cfg)
    train_src, test_src = gen.fit_sources(seed, traffic)
    weights = gen.draw_weights(shapes, seed, dev)

    prog = _program(cell, entry, weights, seed, train_src, test_src, tracer)
    trace = tracer.result()
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    steps, val_steps = traffic['steps_per_epoch'], traffic['validation_steps']
    epochs = len(prog['ends'])
    window_s = prog['ends'][-1] - prog['begins'][0]
    bad_epochs = sum(1 for x in prog['losses'] if not math.isfinite(x))

    ref = reference(cfg, ref_model, weights, train_src, test_src, seed, dev,
                    iterator=traffic['mode'] == 'iterator',
                    window=(epochs, steps, val_steps) if cell.trace else None)
    readings, left_out = compare(prog, ref)
    width = train_src[0][0].shape[0] * train_src[0][0].shape[2]
    works = [synth_work(d, width) for d in ref['window_draws']]
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
                 # the program's kernel launches a step (training and
                 # validation), replays included: the synthesis kernel's
                 # is 1.0 where the cell's path ran it
                 'launches_a_step': {
                     k: v / (epochs * (steps + val_steps))
                     for k, v in prog['launches'].items()},
                 'synth_draws_counted': len(works),
                 'synth_launches_traced': (len(trace.op_seconds('synth_'))
                                           if trace is not None else None),
                 'reference_s': ref['seconds'],
                 'trace_read_s': tracer.read_s},
    }


def compare(prog: dict, ref: dict):
    """(every number the fit cells may compare, the leaves left out of the
    change's gaps) for the program's (or the control's) ``loss``, ``val``,
    ``first_grad``, ``change1`` and ``change`` against the reference's. A
    cell's limits file names the numbers it compares; the others are
    reported."""
    med = float(np.median(list(ref['first_grad'].values())))
    keep = {n for n in ref['first_grad']
            if ref['first_grad'][n] >= STILL_LEAF * med}
    loss = [rel_gap(p, r) for p, r in zip(prog['loss'], ref['loss'])]
    val = [rel_gap(p, r) for p, r in zip(prog['val'], ref['val'])]
    grads = leaf_gaps(prog['first_grad'], ref['first_grad'])
    change = leaf_gaps(prog['change'], ref['change'], keep)
    change1 = leaf_gaps(prog['change1'], ref['change1'], keep)
    return {
        'loss_gap': max(loss), 'loss_gap_step1': loss[0],
        'grad_gap': max(grads), 'grad_gap_median': float(np.median(grads)),
        'change_gap_step1': max(change1), 'change_gap': max(change),
        'change_gap_median': float(np.median(change)),
        'val_loss_gap': max(val), 'val_loss_gap_step1': val[0],
    }, sorted(set(ref['first_grad']) - keep)


def reference(cfg: dict, ref_model, weights: dict, train_src, test_src,
              seed: int, dev, iterator: bool, tf32: bool = False,
              window=None) -> dict:
    """The reference's three steps from ``weights`` on the same batches:
    per-step losses and validation losses, the first step's clipped
    gradient norms, the parameters' change norms after the first step and
    after the three (by name). With ``window`` = (epochs, steps,
    validation steps), also the draws of every training and validation
    batch of the window's epochs, from the same seeds (else none).
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
        module = ref_model.build(cfg).to(dev)
        module.load_state_dict(weights)
        n_classes = cfg['model']['n_classes']
        n_frame = cfg['model']['n_frame']
        banks = ref_data.build_banks(*train_src, n_frame, n_classes, dev)
        val_banks = ref_data.build_banks(*test_src, n_frame, n_classes, dev)
        melm = torch.from_numpy(ref_data.mel_filterbank(
            cfg['model']['n_mels'])).to(dev)
        names = [n for n, _ in module.named_parameters()]
        start = {n: p.detach().clone() for n, p in module.named_parameters()}
        opt = ref_train.Optimizer(list(module.parameters()), cfg['train'])
        if iterator:        # one pipeline generator a phase, seed + phase
            tgen, vgen = _generator(dev, seed), _generator(dev, seed + 1)
        losses, vals, first, change1 = [], [], None, None
        for epoch in range(CHECK_STEPS):
            if not iterator:
                tgen = _generator(dev, _phase_seed(seed, epoch, True))
                vgen = _generator(dev, _phase_seed(seed, epoch, False))
            dgen = _generator(dev, _dropout_seed(seed, epoch))
            x, y = ref_data.batch(tgen, banks, mc, melm, True)
            loss, grads = ref_train.train_step(module, opt, cfg['train'], x,
                                               y, dgen)
            losses.append(float(loss))
            if first is None:
                first = {n: _norm(g) for n, g in zip(names, grads)}
                change1 = {n: _norm(p.detach() - start[n])
                           for n, p in module.named_parameters()}
            xv, yv = ref_data.batch(vgen, val_banks, mc, melm, False)
            vals.append(float(ref_train.val_loss(module, cfg['train'], xv,
                                                 yv)))
        change = {n: _norm(p.detach() - start[n])
                  for n, p in module.named_parameters()}
        draws = []
        n_epochs, steps, val_steps = window or (0, 0, 0)
        for epoch in range(CHECK_STEPS, CHECK_STEPS + n_epochs):
            if not iterator:
                tgen = _generator(dev, _phase_seed(seed, epoch, True))
                vgen = _generator(dev, _phase_seed(seed, epoch, False))
            draws += [ref_data.batch_draws(tgen, banks, mc, True)
                      for _ in range(steps)]
            draws += [ref_data.batch_draws(vgen, val_banks, mc, False)
                      for _ in range(val_steps)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved
    return {'loss': losses, 'val': vals, 'first_grad': first,
            'change1': change1, 'change': change, 'window_draws': draws,
            'seconds': time.perf_counter() - t0}
