"""The plain reference against the program on the CPU at tiny sizes: the
same seeded weights load into both by name, and the forwards, the input
pipeline and the draws agree."""

import pytest
import torch

from conftest import tiny_cell
from hpe_bench import program
from hpe_bench.entries import train as train_entry
from hpe_bench.reference import pipeline, train


@pytest.mark.parametrize('name', ['hg8-train-b256', 'mspn2-train-b384'])
@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_reference_forward_matches_the_port(name, mode):
    """f32 in eval mode; f64 in train mode, where a BatchNorm over a tiny
    map's few values amplifies f32 rounding past any useful tolerance. The
    program returns its maps in f32 either way, so both are held to f32's
    rounding of the output."""
    dt = 'float64' if mode == 'train' else 'float32'
    cfg = tiny_cell(name, compute_dtype=dt)['cfg']
    model, w = program.build_model(cfg, 77, 'cpu')
    ref = train.build(cfg, 'cpu')
    ref.load_state_dict(w, strict=True)
    x = torch.randn(4, cfg['inp_res'], cfg['inp_res'], 3, generator=torch.Generator().manual_seed(1))
    if dt == 'float64':
        model, ref, x = model.double(), ref.double(), x.double()
    with torch.no_grad():
        a, b = model(x, train=mode == 'train'), ref(x, train=mode == 'train')
    assert a.shape == b.shape
    assert float((a - b).abs().max() / b.abs().max()) < 1e-5


def test_reference_pipeline_is_the_programs_bit_for_bit():
    from hourglass_pose_estimation_torch.data.pipeline import PipelineSpec, augment_batch
    from hourglass_pose_estimation_torch.runner.train_state import _global_draws
    cell = tiny_cell('hg8-train-b256')
    cfg, mix = cell['cfg'], cell['mix']
    spec = train_entry.spec_of(cfg, mix)
    pool = train_entry.make_pool(cfg, mix, 2 ** 40 + 3, 'cpu', 2, 6)
    for step in range(2):
        d = _global_draws(PipelineSpec(**spec), 2 ** 40 + 3, step, pool[step]['scale'], None)
        d_ref = pipeline.draws(2 ** 40 + 3, step, pool[step]['scale'], spec['scale_factor'],
                               spec['rot_factor'])
        assert all(torch.equal(a, b) for a, b in zip(d, d_ref))
        out = augment_batch(pool[step], d, PipelineSpec(**spec), True)
        img, target, w = pipeline.augment(pool[step], d_ref, spec)
        assert torch.equal(img, out['image']) and torch.equal(target, out['target'])
        assert torch.equal(w, out['target_weight'])
