"""What every cell shares: the manifest and a cell's files, the process's
age, the comparison's arithmetic and the record of a run.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) is found by name:
its configuration is the file its ``configs`` entry names; its traffic is
``traffic/<traffic>.json``, whose ``kind`` names the runner
``kinds/<kind>.py``; its limits are ``limits/<cell>.json``; each
per-layer metric it reports is ``metrics/<metric>.py``. A later cell adds
files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_seconds() -> float:
    """Seconds since this process started, from /proc."""
    with open('/proc/self/stat') as f:
        start = int(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf('SC_CLK_TCK')


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / 'BENCHMARK.json') as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = 'cuda'


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or every
    cell for an end-to-end metric that lists none (a per-layer metric
    always lists its cells)."""
    return cell in metric.get('workloads', [cell])


def cell_files(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics, read from their files."""
    cells = {w['name']: w for w in manifest['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    w = cells[name]
    configs = {c['name']: c for c in manifest['configs']}
    with open(root / configs[w['config']]['file']) as f:
        config = json.load(f)
    with open(HERE / 'traffic' / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / 'limits' / f'{name}.json') as f:
        limits = json.load(f)
    e2e = [m for m in manifest['end_to_end'] if reports(m, name)]
    per_layer = [m for m in manifest['per_layer'] if reports(m, name)]
    return Cell(name, config, traffic, limits, e2e, per_layer)


def kind_module(cell: Cell):
    return importlib.import_module(f"h100_bench.kinds.{cell.traffic['kind']}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx) -> float | None``."""
    path = HERE / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'h100_bench.metrics._{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ comparisons
def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|, inf where either is not finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[set] = None) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's, for
    the leaves ``keep`` (default all); inf for a norm that is not
    finite."""
    med = statistics.median(ref.values())
    out = []
    for k in ref:
        if keep is not None and k not in keep:
            continue
        p, r = prog[k], ref[k]
        out.append(abs(p - r) / max(r, med, 1e-30)
                   if math.isfinite(p) and math.isfinite(r) else math.inf)
    return out

