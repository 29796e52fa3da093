"""BENCHMARK.json against the benchmark's contract: names, units and
limits of its fields, the per-layer metrics' ``moves``, and every file a
cell needs."""

from __future__ import annotations

import json
import re

import pytest

from h100_bench.harness import HERE, ROOT, cell_files, load_manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}

MANIFEST = load_manifest()
CELLS = [w['name'] for w in MANIFEST['workloads']]
METRICS = MANIFEST['end_to_end'] + MANIFEST['per_layer']


def test_top_level_keys_and_sizes():
    m = MANIFEST
    assert set(m) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert 1 <= len(m['command']) <= 32
    assert all(1 <= len(w) <= 200 and '\n' not in w and '\t' not in w
               for w in m['command'])
    assert 1 <= len(m['paths']) <= 16
    for p in m['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert not p.endswith('_torch')
    assert isinstance(m['run_seconds'], int) and 1 <= m['run_seconds'] <= 51
    assert 1 <= len(m['configs']) <= 24
    assert 1 <= len(m['workloads']) <= 24
    assert 1 <= len(m['end_to_end']) <= 16
    assert 1 <= len(m['per_layer']) <= 128


@pytest.mark.parametrize('entry', MANIFEST['configs'],
                         ids=[c['name'] for c in MANIFEST['configs']])
def test_config_entry(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(entry['name'])
    assert entry['source'].startswith('https://')
    assert entry['file'].startswith('h100_bench/')
    assert len(entry['reduced']) <= 16
    assert all(NAME.match(k) for k in entry['reduced'])
    assert any(c['config'] == entry['name'] for c in MANIFEST['workloads'])
    with open(ROOT / entry['file']) as f:
        cfg = json.load(f)
    assert cfg['name'] == entry['name']
    assert cfg['reduced'] == entry['reduced']
    assert (HERE / 'reference' / f"{cfg['reference']}.py").exists()
    assert (HERE / 'entries' / f"{cfg['entry']}.py").exists()
    files = [c['file'] for c in MANIFEST['configs']]
    assert files.count(entry['file']) == 1


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files_and_metrics(cell):
    w = {x['name']: x for x in MANIFEST['workloads']}[cell]
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(w['name']) and NAME.match(w['traffic'])
    assert w['chips'] in (1, 4) and 1 <= len(w['why']) <= 200
    c = cell_files(MANIFEST, cell)
    assert (HERE / 'kinds' / f"{c.traffic['kind']}.py").exists()
    e2e = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert c.per_layer, 'a cell reports at least one per-layer metric'
    for m in c.per_layer:
        assert (HERE / 'metrics' / f"{m['name']}.py").exists()
        assert m['moves'] in e2e
    assert c.limits and all('limit' in v for v in c.limits.values())


@pytest.mark.parametrize('metric', METRICS, ids=[m['name'] for m in METRICS])
def test_metric_fields(metric):
    assert NAME.match(metric['name'])
    assert UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    assert metric['source'] in SOURCES
    for cell in metric.get('workloads', []):
        assert cell in CELLS


def test_metric_names_unique_and_bounds():
    names = [m['name'] for m in METRICS]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w['config'], w['traffic']) for w in MANIFEST['workloads']]
    assert len(pairs) == len(set(pairs))
    for m in MANIFEST['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
    assert {m['name']: m['bound'] for m in MANIFEST['end_to_end']}[
        'setup_s'] <= 0.25
    for m in MANIFEST['per_layer']:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}, 'a per-layer metric lists ' \
            'its cells'
        assert m['workloads']
        assert 'bound' not in m and 1 <= len(m['layer']) <= 200
        e2e = {x['name'] for x in MANIFEST['end_to_end']}
        assert m['moves'] in e2e


def test_per_layer_moves_reported_by_its_cells():
    """Each per-layer metric's cells report the end-to-end metric it
    moves."""
    for m in MANIFEST['per_layer']:
        for cell in m['workloads']:
            e2e = {x['name'] for x in cell_files(MANIFEST, cell).end_to_end}
            assert m['moves'] in e2e, (m['name'], cell)
    layers = {}
    for m in MANIFEST['per_layer']:
        layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


def test_four_chip_cells_within_share():
    four = sum(1 for w in MANIFEST['workloads'] if w['chips'] == 4)
    assert four <= max(1, len(CELLS) // 4)
