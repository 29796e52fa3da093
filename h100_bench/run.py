"""Run one cell of the benchmark once and print its result.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``challenge_tpu_torch``. The cell's
configuration, traffic, limits and metrics are found from
``BENCHMARK.json`` by name (``harness.py``). The run sets up, measures for
``--seconds`` (whole epochs: the window ends with the first that ends
after them), then checks what the window's program produced against the
reference. With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics; with ``--trace 1`` a profiler traces the window and
they are its per-layer metrics, with the device's busy and window seconds
and a breakdown.

The last line of standard output is the result, one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error and the result's last key, ``checks``. With no CUDA device, with
fewer than the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

from h100_bench.harness import (
    ROOT, cell_files, kind_module, load_manifest, metric_reader)

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'challenge_tpu')


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's, flax's, optax's or
    the JAX package's, compared whole (``challenge_tpu_torch`` is not
    ``challenge_tpu``)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'not read'


def run_cell(cell) -> dict:
    """The cell's run and its result (everything but the device's name);
    the caller has set ``cell``'s seed, seconds, trace and device."""
    out = kind_module(cell).run(cell)
    checks = {}
    for name, value in out['checks'].items():
        limit = cell.limits[name]['limit']
        checks[name] = {'value': float(value), 'limit': limit}
    correct = all(math.isfinite(c['value']) and c['value'] <= c['limit']
                  for c in checks.values())
    metrics = {}
    if cell.trace:
        ctx = out['ctx']
        for m in cell.per_layer:
            value = metric_reader(m['name'])(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': out['e2e'][m['name']],
                                  'unit': m['unit']}
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics,
              'device': {'memory_peak_bytes': out['memory_peak_bytes']}}
    trace = out['ctx'].get('trace')
    if trace is not None:
        result['device'].update(busy_s=trace.busy_s(),
                                window_s=trace.window_s)
        result['breakdown'] = {'device_ops': trace.top_ops(),
                               'idle_gaps': trace.idle_gaps()}
    result['info'] = out['info']
    result['checks'] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    manifest = load_manifest()
    chips = {w['name']: w['chips'] for w in manifest['workloads']}
    cell = cell_files(manifest, args.workload)

    import torch
    if not torch.cuda.is_available():
        print('no CUDA device: the benchmark measures the card and does not '
              'run on the CPU', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        print(f'{args.workload} needs {chips[args.workload]} CUDA devices, '
              f'{torch.cuda.device_count()} are visible', file=sys.stderr)
        return 2
    cell.seed, cell.seconds = args.seed, args.seconds
    cell.trace, cell.device = bool(args.trace), 'cuda'
    result = run_cell(cell)
    bad = forbidden_modules()
    if bad:
        print(f'loaded in this process: {bad}; the benchmark and the port '
              'may load none of them', file=sys.stderr)
        return 3
    result['device'] = {'platform': 'gpu',
                        'kind': torch.cuda.get_device_name(0),
                        'count': chips[args.workload],
                        **result['device']}
    result['info']['card'] = power_limit()
    result['checks'] = result.pop('checks')         # the last key
    for name, c in result['checks'].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    os.chdir(ROOT)
    sys.exit(main())
