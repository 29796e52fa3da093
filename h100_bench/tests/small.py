"""Cells of the manifest at a size a CPU test run holds: vad v8 and the
density B4 at 80 mels x 64 frames, batch 2, on a few short sources. Only
sizes change; the code paths are the cells'."""

from __future__ import annotations

import copy

from h100_bench.harness import cell_files, load_manifest

SMALL_ARGV = ['--n_frame', '64', '--batch_size', '2']
TRAIN = [3, 100, 8, [10, 40], 4, [8, 20]]
TEST = [2, 100, 4, [10, 40], 0, 1]


def small_cell(name: str, seed: int = 5, device: str = 'cpu'):
    cell = cell_files(load_manifest(), name)
    cell.config = copy.deepcopy(cell.config)
    cell.config['argv'] = cell.config['argv'] + SMALL_ARGV
    cell.config['model'].update(n_frame=64, batch_size=2)
    cell.traffic = dict(cell.traffic, train_sources=TRAIN, test_sources=TEST,
                        steps_per_epoch=2, validation_steps=1)
    cell.seed, cell.seconds, cell.device = seed, 0.0, device
    return cell
