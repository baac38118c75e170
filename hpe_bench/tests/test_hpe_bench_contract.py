"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re

import pytest

from hpe_bench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SPEC = harness.benchmark_spec()
CELLS = [w['name'] for w in SPEC['workloads']]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                         'end_to_end', 'per_layer'}
    assert 1 <= SPEC['run_seconds'] <= 51 and isinstance(SPEC['run_seconds'], int)
    assert all(re.match(r'^[A-Za-z0-9_./-]{1,200}$', p) and not p.startswith('/')
               and '..' not in p for p in SPEC['paths'])
    assert len(SPEC['command']) <= 32 and all(one_line(w) for w in SPEC['command'])
    assert len((harness.ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    four = sum(w['chips'] == 4 for w in SPEC['workloads'])
    assert four <= max(1, len(SPEC['workloads']) // 4)


def test_names_units_and_entries():
    seen = set()
    for group, keys in (('configs', {'name', 'source', 'file', 'reduced', 'why'}),
                        ('workloads', {'name', 'config', 'traffic', 'chips', 'why'})):
        for e in SPEC[group]:
            assert set(e) == keys, e
            assert NAME.match(e['name']) and one_line(e['why'])
            assert e['name'] not in seen
            seen.add(e['name'])
    for e in SPEC['end_to_end'] + SPEC['per_layer']:
        base = {'name', 'unit', 'better', 'source'}
        if e in SPEC['end_to_end']:
            assert set(e) - {'workloads'} == base | {'bound'}
            assert 0 < e['bound'] <= 0.25 and e['source'] in ('host_clock', 'device_trace')
        else:
            assert set(e) - {'workloads'} == base | {'layer', 'moves'}
            assert one_line(e['layer'])
            assert e['moves'] in {m['name'] for m in SPEC['end_to_end']}
        assert NAME.match(e['name']) and UNIT.match(e['unit']) and e['better'] in ('lower', 'higher')
        assert e['name'] not in seen
        seen.add(e['name'])
    assert 'setup_s' in {m['name'] for m in SPEC['end_to_end']}


@pytest.mark.parametrize('cell', CELLS)
def test_every_cell_resolves_to_its_files(cell):
    entry = next(w for w in SPEC['workloads'] if w['name'] == cell)
    c = harness.load_cell(cell)
    assert (c['config'], c['traffic'], c['chips']) == (entry['config'], entry['traffic'],
                                                       entry['chips'])
    assert (harness.BENCH_DIR / 'entries' / f"{c['entry']}.py").is_file()
    conf = next(x for x in SPEC['configs'] if x['name'] == c['config'])
    assert conf['file'] == f"hpe_bench/configs/{c['config']}.json"
    assert conf['source'] == c['cfg']['source'] and conf['reduced'] == c['cfg']['reduced']
    e2e = harness.metrics_of(cell, SPEC, False)
    assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2
    layer = harness.metrics_of(cell, SPEC, True)
    assert layer
    for m in layer:
        assert hasattr(harness.metric_reader(m['name']), 'read')
        assert m['moves'] in {x['name'] for x in e2e}
    assert set(c['limits']) and all(v > 0 for v in c['limits'].values())


def test_every_configuration_is_used():
    used = {w['config'] for w in SPEC['workloads']}
    assert used == {c['name'] for c in SPEC['configs']}
