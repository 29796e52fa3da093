"""The readings that the se cells' limits are set from; the benchmark's
runs do not run this. ``control.py``'s procedure on the se kind
(``kinds/fit_se.py``).

    python3 -m h100_bench.control_se --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--out <file.json>]

For each of ``--seeds``, the program's readings: the cell's set-up and
checked steps at the cell's own size, with a window of one epoch of one
step, then the comparison with the reference; every number the cell may
compare, not only those its limits name. For each of ``--control-seeds``,
the control's: the reference computed with TF32 matrix products and
convolutions (the nearest precision below the configuration's float32) in
the program's place; and two faults planted in the reference put in the
program's place: half of the batch left out of the loss (the mean taken
over the rest), and the head left unfrozen (trained with the U-Net, its
BatchNorms in training mode). Prints one JSON line a reading and writes
them all to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import torch

from h100_bench import gen
from h100_bench.harness import cell_files, load_manifest
from h100_bench.kinds import fit_se
from h100_bench.reference import se as ref_se
from h100_bench.reference import se_train


@contextlib.contextmanager
def half_batch_loss():
    """The reference's loss over the first half of the batch only."""
    whole = se_train.loss_parts

    def half(y, out):
        b = out[0].shape[0] // 2
        return whole(tuple(t[:b] for t in y), tuple(t[:b] for t in out))
    se_train.loss_parts = half
    try:
        yield
    finally:
        se_train.loss_parts = whole


@contextlib.contextmanager
def unfrozen_head():
    """The reference's head trained with the U-Net: every leaf handed to
    the optimizer, every BatchNorm in training mode."""
    trained, train = se_train.trained, ref_se.SECascade.train
    se_train.trained = lambda module: se_train.leaves(module, '')
    ref_se.SECascade.train = torch.nn.Module.train
    try:
        yield
    finally:
        se_train.trained, ref_se.SECascade.train = trained, train


def program_readings(cell, seed: int) -> dict:
    cell = dataclasses.replace(cell, seed=seed, seconds=0.0, trace=False)
    cell.traffic = dict(cell.traffic, steps_per_epoch=1, validation_steps=1)
    return fit_se.run(cell)['info']['readings']


def control_readings(cell, seed: int) -> dict:
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(cell.device)
    seed = fit_se.program_seed(seed)
    with torch.device('meta'):
        shapes = ref_se.build(cfg)
    weights = gen.draw_weights(shapes, seed, dev)
    srcs = gen.fit_sources(seed, traffic)

    def ref(tf32=False):
        return fit_se.reference(cfg, weights, *srcs, seed, dev, tf32=tf32)

    def readings(other):
        return fit_se.readings_of(other, base)[0]
    base = ref()
    out = {'control': readings(ref(tf32=True))}
    with half_batch_loss():
        out['half_batch'] = readings(ref())
    with unfrozen_head():
        out['unfrozen_head'] = readings(ref())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--device', default='cuda')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    cell = cell_files(load_manifest(), args.workload)
    cell.device = args.device
    rows = []
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
