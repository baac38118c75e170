"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, and a new configuration joining as new files alone."""

import filecmp
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from hpe_bench import harness, kernels

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


def test_no_end_to_end_metric_is_named_after_a_configuration():
    tags = {c['name'] for c in SPEC['configs']} | {c['name'].split('-')[0] for c in SPEC['configs']}
    for m in SPEC['end_to_end']:
        assert not tags & set(m['name'].split('.')), m['name']


@pytest.mark.parametrize('cell', CELLS)
def test_every_train_cell_reports_train_img_s(cell):
    if harness.load_cell(cell)['entry'] != 'train':
        pytest.skip(f'{cell} is no train cell')
    assert {'setup_s', 'train_img_s'} <= {m['name'] for m in harness.metrics_of(cell, SPEC, False)}


@pytest.mark.parametrize('config', [c['name'] for c in SPEC['configs']])
def test_the_programs_model_and_the_reference_read_one_configuration(config):
    """What `model` passes to the program agrees with the keys of the same
    name that the reference and the pipeline read, and `reference` names a
    module file under the benchmark with a `build`."""
    cfg = harness.read_json(harness.BENCH_DIR / 'configs' / f'{config}.json')
    for k, v in cfg['model'].items():
        assert cfg.get(k, v) == v, k
    assert not {'num_stacks', 'num_classes', 'dtype'} & set(cfg['model'])
    assert cfg['reference'].startswith('hpe_bench/reference/')
    assert 'def build(' in (harness.ROOT / cfg['reference']).read_text()


# what a new configuration brings: files of its own, and entries appended at
# the ends of BENCHMARK.json's lists
NEW_FILES = {
    'configs/tinyhg-mpii.json': {
        'source': 'https://arxiv.org/abs/1603.06937', 'reference': 'hpe_bench/reference/tinyhg.py',
        'arch': 'hg', 'model': {'num_blocks': 1, 'mobile': False, 'skip_mode': 'sum',
                                'num_feats': 8, 'fuse_block': False, 'fuse_upsample': False},
        'num_stacks': 1, 'num_feats': 8, 'num_classes': 16, 'inp_res': 128, 'out_res': 32,
        'compute_dtype': 'float32', 'param_dtype': 'float32', 'reduced': []},
    'workloads/tinyhg-train-b64.json': {
        'config': 'tinyhg-mpii', 'traffic': 'train-pool-b64', 'entry': 'train', 'chips': 1,
        'why': 'a configuration that joins as files', 'limits': {'grad_gap': 0.0075}},
    'reference/tinyhg.py': (
        '"""A new architecture\'s reference: here a narrow stacked hourglass."""\n\n'
        'from hpe_bench.reference.hourglass import HourglassNet\n\n\n'
        'def build(cfg, checkpointed=False):\n'
        '    return HourglassNet(cfg["num_stacks"], cfg["num_feats"], cfg["num_classes"],\n'
        '                        checkpointed=checkpointed)\n'),
    'roofline/hpe.made_up_op.py': (
        '"""hpe::made_up_op: x [N] bf16 read and written."""\n\n'
        'from hpe_bench.kernels import BF16, numel\n\n'
        'SYMBOL = "made_up_kernel"\n\n\n'
        'def cost(shapes, ctx):\n'
        '    return numel(shapes[0]), 2 * numel(shapes[0]) * BF16\n'),
}
APPENDS = {
    'configs': {'name': 'tinyhg-mpii', 'source': 'https://arxiv.org/abs/1603.06937',
                'file': 'hpe_bench/configs/tinyhg-mpii.json', 'reduced': [],
                'why': 'a configuration that joins as files'},
    'workloads': {'name': 'tinyhg-train-b64', 'config': 'tinyhg-mpii',
                  'traffic': 'train-pool-b64', 'chips': 1, 'why': 'a cell that joins as files'},
    'per_layer': {'name': 'train.step_mfu.tinyhg', 'unit': '%', 'better': 'higher',
                  'source': 'host_clock', 'layer': 'models forward and backward, the whole train step',
                  'moves': 'train_img_s', 'workloads': ['tinyhg-train-b64']},
}
IN_THE_COPY = """
import json, torch
from hpe_bench import flops, harness, kernels, program
from hpe_bench.reference import train
spec = harness.benchmark_spec()
cell = harness.load_cell("tinyhg-train-b64")
model, w = program.build_model(cell["cfg"], 5, "cpu")
ref = train.build(cell["cfg"], "cpu")
ref.load_state_dict(w, strict=True)
x = torch.randn(2, 128, 128, 3)
with torch.no_grad():
    a, b = model(x), ref(x)
print(json.dumps({
    "e2e": [m["name"] for m in harness.metrics_of("tinyhg-train-b64", spec, False)],
    "layer": [m["name"] for m in harness.metrics_of("tinyhg-train-b64", spec, True)],
    "readers": [hasattr(harness.metric_reader(m["name"]), "read") for m in spec["per_layer"]],
    "kernel": [kernels.KERNELS["hpe::made_up_op"][0],
               kernels.KERNELS["hpe::made_up_op"][1]([[4, 8]], {})],
    "ops": len(kernels.KERNELS), "shape": list(b.shape), "flops": flops.forward_flops(cell["cfg"]),
    "gap": float((a - b).abs().max() / b.abs().max()) if a.shape == b.shape else None}))
"""


def _only_added(old, new) -> list:
    """Files of directory `old` that directory `new` lacks or holds changed."""
    cmp = filecmp.dircmp(old, new, ignore=['__pycache__'])
    out = [f'{old}/{f}' for f in cmp.left_only + cmp.diff_files + cmp.funny_files]
    for sub in cmp.common_dirs:
        out += _only_added(os.path.join(old, sub), os.path.join(new, sub))
    return out


def _only_appended(old: dict, new: dict) -> list:
    """Keys of BENCHMARK.json whose values `new` changes other than by
    entries appended at the end of a list."""
    return [k for k in set(old) | set(new)
            if not (k in old and k in new and (new[k] == old[k] or (
                isinstance(old[k], list) and new[k][:len(old[k])] == old[k])))]


def test_a_new_configuration_is_only_new_files(tmp_path):
    """A configuration with a reference module of its own, a cell on the
    train entry, a kernel's cost and a per-layer metric of its own: files
    added and entries appended, nothing edited; and the copy finds them
    all by name, the program and the reference build the model, and the
    cell reports setup_s and train_img_s. The program's model and the
    new reference agree (f32, eval mode)."""
    bench = tmp_path / 'hpe_bench'
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns('__pycache__'))
    for rel, body in NEW_FILES.items():
        (bench / rel).write_text(body if isinstance(body, str) else json.dumps(body, indent=1))
    spec = json.loads(json.dumps(SPEC))
    for key, entry in APPENDS.items():
        spec[key].append(entry)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec, indent=1))

    assert _only_added(harness.BENCH_DIR, bench) == []
    assert _only_appended(SPEC, spec) == []

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(harness.ROOT)]))
    out = subprocess.run([sys.executable, '-c', IN_THE_COPY], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(got['e2e']) == {'setup_s', 'train_img_s'}
    assert got['layer'] == ['train.step_mfu.tinyhg'] and all(got['readers'])
    assert got['kernel'] == ['made_up_kernel', [32, 128]]
    assert got['ops'] == len(kernels.KERNELS) + 1
    assert got['shape'] == [1, 2, 32, 32, 16] and got['gap'] < 1e-5, got
    assert got['flops'] > 0
