"""The HRNet-W48 cell (`hrnet48-train-b384`) on the CPU at a tiny size: its
configuration read by the program and the reference alike, its files and
readers found by name, a sound run correct, and the control and the train
faults not (the checks `test_hpe_bench_faults.py` and
`test_hpe_bench_control.py` make of every cell, whose `tiny_cell` sets two
stacks). The tiny cell keeps HRNet's one output (`num_stacks` 1, which its
factory requires) and cuts the width to 8, one BasicBlock a branch, 128^2
in, batch 4."""

import pytest
import torch

from hpe_bench import calibrate, harness, program
from hpe_bench.reference import train as reference
from test_hpe_bench_faults import FAULTS

CELL = 'hrnet48-train-b384'
SPEC = harness.benchmark_spec()
TINY = dict(width=8, branch_blocks=1, inp_res=128, out_res=32, compute_dtype='float32')


def tiny_hrnet_cell():
    cell = harness.load_cell(CELL)
    for k, v in TINY.items():
        cell['cfg'][k] = v
        if k in cell['cfg']['model']:
            cell['cfg']['model'][k] = v
    cell['mix'].update(batch=4, pool_batches=3, trace_steps=1)
    return cell


def test_the_configuration_is_the_programs_and_the_references():
    cfg = harness.load_cell(CELL)['cfg']
    assert cfg['arch'] == 'hrnet' and cfg['num_stacks'] == 1 and cfg['reduced'] == []
    assert cfg['reference'] == 'hpe_bench/reference/hrnet.py'
    with torch.device('meta'):
        ref = reference.build(cfg, 'meta')
    assert sum(p.numel() for p in ref.parameters()) == cfg['parameters']


@pytest.mark.parametrize('train', [False, True])
def test_the_program_matches_the_reference(train):
    """f32 at the tiny size: read 1e-6 (eval) and 1e-5 (train) of the
    largest output (the BatchNorms' one-pass and two-pass variances)."""
    cfg = tiny_hrnet_cell()['cfg']
    model, weights = program.build_model(cfg, 2 ** 33 + 3, 'cpu')
    ref = reference.build(cfg, 'cpu')
    ref.load_state_dict(weights, strict=True)
    x = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = model(x, train=train), ref(x, train=train)
    assert a.shape == b.shape == (1, 2, 32, 32, 16)
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


def test_the_cell_lists_readers_that_exist():
    names = [m['name'] for m in harness.metrics_of(CELL, SPEC, True)]
    assert 'train.exchange_ms.hrnet48' in names and 'train.kernel_roofline.hrnet48' in names
    for name in names:
        assert hasattr(harness.metric_reader(name), 'read')
    assert {m['name'] for m in harness.metrics_of(CELL, SPEC, False)} == {'setup_s',
                                                                           'train_img_s'}


def test_a_sound_tiny_run_is_correct(cpu_run):
    res = cpu_run(tiny_hrnet_cell())
    assert res['correct'], res['checks']
    assert set(res['metrics']) == {'setup_s', 'train_img_s'}


def test_the_control_fails_a_limit():
    cell = tiny_hrnet_cell()
    got = calibrate.train_readings(cell, 2 ** 35 + 1, ['control'], 'cpu')['control']
    assert any(got[k] > v for k, v in cell['limits'].items()), (got, cell['limits'])


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_a_broken_train_step_is_not_correct(cpu_run, fault):
    with FAULTS[fault]():
        res = cpu_run(tiny_hrnet_cell())
    assert not res['correct'], res['checks']
