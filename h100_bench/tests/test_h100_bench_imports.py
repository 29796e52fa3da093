"""What the benchmark's modules load, by whole top-level module name: no
JAX, jaxlib, flax, optax or the JAX package (``challenge_tpu``; the port,
``challenge_tpu_torch``, is another name); and the reference loads nothing
of the port either. Each check runs in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

from h100_bench.harness import HERE, ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'challenge_tpu'}


def modules_of():
    """Every module of the benchmark but its tests, by import name; the
    metric files (``<name>.py`` with a dot in the name) load from their
    paths (``harness.metric_reader``)."""
    names = []
    for path in sorted(HERE.rglob('*.py')):
        rel = path.relative_to(ROOT).with_suffix('')
        if 'tests' in rel.parts or '.' in rel.name:
            continue
        names.append('.'.join(p for p in rel.parts if p != '__init__'))
    return names


def loaded_after_import(names, load_metrics: bool = False):
    code = (
        'import importlib, json, sys\n'
        f'for n in {names!r}: importlib.import_module(n)\n'
        'from h100_bench.harness import load_manifest, metric_reader\n'
        f'if {load_metrics!r}:\n'
        '    for m in load_manifest()["per_layer"]: '
        'metric_reader(m["name"])\n'
        'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    names = modules_of()
    assert 'h100_bench.run' in names and 'h100_bench.kinds.fit' in names
    loaded = loaded_after_import(names, load_metrics=True)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = [n for n in modules_of()
             if n.startswith('h100_bench.reference')]
    assert 'h100_bench.reference.vad' in names
    loaded = loaded_after_import(names)
    assert not loaded & (FORBIDDEN | {'challenge_tpu_torch'})
