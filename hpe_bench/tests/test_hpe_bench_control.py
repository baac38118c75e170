"""The control comes out not correct: the reference put in the program's
place with its convolutions in fp8 (the precision below the
configurations' bf16) fails at least one of the cell's limits. On the CPU at
a tiny size; on the card at the cell's own size (marked `cuda`)."""

import pytest
import torch

from conftest import tiny_cell
from hpe_bench import calibrate, harness

CELLS = [w['name'] for w in harness.benchmark_spec()['workloads']]


def readings(cell, device, seed):
    return calibrate.train_readings(cell, seed, ['control'], device)['control']


@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_a_limit(name):
    cell = tiny_cell(name)
    got = readings(cell, 'cpu', 2 ** 35 + 1)
    assert any(got[k] > v for k, v in cell['limits'].items()), (got, cell['limits'])


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_a_limit_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cell = harness.load_cell(name)
    got = readings(cell, 'cuda:0', 2 ** 35 + 2)
    assert any(got[k] > v for k, v in cell['limits'].items()), (got, cell['limits'])
