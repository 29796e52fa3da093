"""The readings that a cell's limits are set from; the benchmark's runs do
not run this.

    python3 -m h100_bench.control --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--deterministic] [--out <file.json>]

For each of ``--seeds``, the program's readings: the cell's set-up and
checked steps at the cell's own size, with a window of one epoch of one
step, then the comparison with the reference; every number the cell may
compare, not only those its limits name. For each of ``--control-seeds``,
the control's: the reference computed with TF32 matrix products and
convolutions (the nearest precision below the configuration's float32) in
the program's place; and the fault of half of the batch left out of the
loss (the mean taken over the rest), planted in the reference put in the
program's place. ``--deterministic`` runs the program and the reference
on cuDNN's deterministic algorithms, chosen by its heuristics in place of
the program's timed search, so that both run the same convolution
algorithms. Prints one JSON line a reading and writes them all to
``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import sys

import torch

from h100_bench import gen
from h100_bench.harness import cell_files, load_manifest
from h100_bench.kinds import fit as fit_kind
from h100_bench.reference import train as ref_train


@contextlib.contextmanager
def half_batch_loss():
    """The reference's loss over the first half of the batch only."""
    whole = ref_train.loss_of

    def half(train_cfg, module, y, out):
        b = y.shape[0] // 2
        return whole(train_cfg, module, y[:b], out[:b])
    ref_train.loss_of = half
    try:
        yield
    finally:
        ref_train.loss_of = whole


@contextlib.contextmanager
def deterministic_cudnn(cell):
    """cuDNN's deterministic algorithms by its heuristics, for the program
    (its build turns the timed search on; this turns it off after the
    build) and for the reference."""
    entry = importlib.import_module(
        f"h100_bench.entries.{cell.config['entry']}")
    build = entry.build_fit

    def build_fit(*args, **kwargs):
        prog = build(*args, **kwargs)
        torch.backends.cudnn.benchmark = False
        return prog
    entry.build_fit = build_fit
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        entry.build_fit = build
        torch.backends.cudnn.deterministic = False


def program_readings(cell, seed: int) -> dict:
    cell = dataclasses.replace(cell, seed=seed, seconds=0.0, trace=False)
    cell.traffic = dict(cell.traffic, steps_per_epoch=1, validation_steps=1)
    return fit_kind.run(cell)['info']['readings']


def control_readings(cell, seed: int) -> dict:
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(cell.device)
    seed = fit_kind.program_seed(seed)
    ref_model = importlib.import_module(
        f"h100_bench.reference.{cfg['reference']}")
    with torch.device('meta'):
        shapes = ref_model.build(cfg)
    weights = gen.draw_weights(shapes, seed, dev)
    srcs = gen.fit_sources(seed, traffic)
    it = traffic['mode'] == 'iterator'

    def ref(tf32=False):
        return fit_kind.reference(cfg, ref_model, weights, *srcs, seed, dev,
                                  iterator=it, tf32=tf32)
    base = ref()
    out = {'control': fit_kind.compare(ref(tf32=True), base)[0]}
    with half_batch_loss():
        out['half_batch'] = fit_kind.compare(ref(), base)[0]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--device', default='cuda')
    p.add_argument('--deterministic', action='store_true')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    cell = cell_files(load_manifest(), args.workload)
    cell.device = args.device
    rows = []
    with (deterministic_cudnn(cell) if args.deterministic
          else contextlib.nullcontext()):
        for s in args.seeds:
            rows.append({'seed': s, 'program': program_readings(cell, s)})
            print(json.dumps(rows[-1]), flush=True)
        for s in args.control_seeds:
            rows.append({'seed': s, **control_readings(cell, s)})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'workload': args.workload, 'rows': rows}, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
