"""The control on the card: the reference computed with TF32 products and
convolutions, in the program's place, reads not correct against the cell's
limits, at the small size of ``small.py``. The cells' own sizes are read
by ``python3 -m h100_bench.control`` (PERF.md has the readings)."""

from __future__ import annotations

import pytest

from h100_bench.control import control_readings
from h100_bench.tests.small import small_cell


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['vad_v8.fit', 'density_b4.fit'])
@pytest.mark.parametrize('seed', [31, 32, 33])
def test_control_reads_not_correct(cuda_device, name, seed):
    cell = small_cell(name, seed=seed, device=cuda_device)
    readings = control_readings(cell, seed)['control']
    over = {k: readings[k] for k, v in cell.limits.items()
            if readings[k] > v['limit']}
    assert over, readings
