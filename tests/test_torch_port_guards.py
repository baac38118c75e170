"""Guards of the port's boundaries: it never imports JAX or the JAX
package, its entry points refuse to fall back to the CPU, and its model
has the reference parameter counts."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hourglass_pose_estimation_torch.export import make_inference_fn
from hourglass_pose_estimation_torch.models import HourglassNet, get_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / 'hourglass_pose_estimation_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hourglass_pose_estimation_tpu')
# files that import no cv2 at all, not even where they run
NO_CV2 = ('chip_smoke.py', 'interop.py', 'mspn.py', 'resize.py')

# the reference torch model's counts (num_blocks=1, num_classes=16, sum)
REFERENCE_COUNTS = {
    (1, False): 3_586_960, (2, False): 6_730_912, (8, False): 25_594_624,
    (1, True): 1_209_808, (2, True): 2_305_504, (8, True): 8_879_680,
}


def _port_modules():
    return sorted('.'.join(p.relative_to(REPO).with_suffix('').parts)
                  .replace('.__init__', '') for p in PKG.rglob('*.py'))


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        'import importlib, sys\n'
        f'for m in {_port_modules()!r}:\n'
        '    importlib.import_module(m)\n'
        f'bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})\n'
        'print(len(sys.modules), bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_the_port_loads_no_cv2():
    """The card machine has no cv2: importing every module of the port,
    `interop` and the MSPN model included, must not load it (the host
    preprocess and the `estimate` CLI import it where they run)."""
    code = (
        'import importlib, sys\n'
        f'for m in {_port_modules()!r}:\n'
        '    importlib.import_module(m)\n'
        'sys.exit(1 if "cv2" in sys.modules else 0)\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert {'hourglass_pose_estimation_torch.interop',
            'hourglass_pose_estimation_torch.models.mspn'} <= set(_port_modules())


def test_port_sources_import_no_jax():
    files = list(PKG.rglob('*.py')) + [REPO / 'chip_smoke.py']
    assert len(files) > 15
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f'{f.name}: {n}' for n in names
                    if n.split('.')[0] in FORBIDDEN
                    or (n.split('.')[0] == 'cv2' and f.name in NO_CV2)]
    assert not bad, bad


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    kw = dict(num_stacks=1, num_classes=4, num_feats=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model('hg', **kw)
    model = get_model('hg', device='cpu', **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_inference_fn(model, None)
    assert make_inference_fn(model, None, device='cpu')(
        np.zeros((1, 64, 64, 3), np.float32)).shape == (1, 16, 16, 4)
    from hourglass_pose_estimation_torch import serve_http
    cfg = tmp_path / 'c.yaml'
    cfg.write_text('MODEL:\n  num_stacks: 1\n')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_http.main([str(cfg), str(tmp_path / 'w.pt')])


def test_trainer_and_cli_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """The Trainer and `train_and_evaluate` refuse to start without a GPU
    (before any dataset is built) unless the CPU is asked for."""
    from hourglass_pose_estimation_torch import train_and_evaluate
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.runner import Trainer
    from hourglass_pose_estimation_torch.runner import trainer as trainer_mod
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    built = []
    monkeypatch.setattr(trainer_mod, 'get_dataset',
                        lambda *a, **k: built.append(a) or pytest.fail('dataset built'))
    cfg_path = tmp_path / 'c.yaml'
    cfg_path.write_text('MODEL:\n  num_stacks: 1\nDATASET:\n  inp_res: 64\n  out_res: 16\n')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(load_config(str(cfg_path)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_and_evaluate.main([str(cfg_path)])
    assert not built
    monkeypatch.undo()
    t = Trainer(load_config(str(cfg_path), overrides=['DATASET.num_samples=4']),
                verbose=False, device='cpu')
    assert next(t.model.parameters()).device.type == 'cpu'


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    """A CUDA tensor never reaches the plain version: the checks before a
    launch raise on layouts the kernels do not take (tested here on meta
    tensors, which carry shape, dtype and strides but no data)."""
    from hourglass_pose_estimation_torch.ops.hopper import bottleneck as bk
    x = torch.empty(2, 16, 16, 256, device='meta', dtype=torch.bfloat16)
    C, P = 256, 128
    vec = lambda n: torch.empty(n, device='meta')
    w = lambda *s: bk._n_major(torch.empty(*s, device='meta', dtype=torch.bfloat16))
    p = bk.BottleneckParams(vec(C), vec(C), w(C, P), vec(P), vec(P), vec(P),
                            w(3, 3, P, P), vec(P), vec(P), vec(P), w(P, C), vec(C))
    bk._check_cuda(x, p)                                   # accepted
    with pytest.raises(ValueError, match='contiguous NHWC bf16'):
        bk._check_cuda(x.permute(0, 3, 1, 2), p)
    with pytest.raises(ValueError, match='output-channel-major'):
        bk._check_cuda(x, p._replace(w2=p.w2.contiguous()))
    with pytest.raises(ValueError, match='P=128'):
        bk._check_cuda(x[..., :64].contiguous(), p)


def test_training_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    """The upsample-backward, pool and render wrappers raise before a launch
    on a non-CPU tensor the kernel cannot take (meta tensors here)."""
    from hourglass_pose_estimation_torch.ops.hopper import (
        maxpool2x2, maxpool2x2_bwd, maxpool2x2_bwd_first, maxpool2x2_fwd,
        render_gaussian, upsample2x_add_bwd)
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, device='meta', dtype=dt)
    cases = [
        (upsample2x_add_bwd, (meta(2, 8, 8, 12),), 'multiple of 16'),
        (upsample2x_add_bwd, (meta(2, 8, 8, 64, dt=torch.float16),), 'dtype'),
        (upsample2x_add_bwd, (meta(2, 9, 8, 64),), 'odd'),
        (upsample2x_add_bwd, (meta(2, 8, 64, 8).transpose(2, 3),), 'contiguous'),
        (maxpool2x2_fwd, (meta(2, 8, 8, 4),), 'multiple of 16'),
        (maxpool2x2_fwd, (meta(2, 7, 8, 64),), 'even'),
        (maxpool2x2_fwd, (meta(2, 8, 8, 64, dt=torch.float64),), 'dtype'),
        (maxpool2x2, (meta(2, 8, 64, 8).transpose(2, 3),), 'contiguous'),
        (maxpool2x2_bwd, (meta(2, 8, 8, 64), meta(2, 4, 4, 32)), 'g '),
        (maxpool2x2_bwd, (meta(2, 8, 8, 64), meta(2, 4, 4, 64, dt=torch.float32)), 'maxpool2x2_bwd'),
        (maxpool2x2_bwd_first, (meta(2, 8, 8, 64), meta(2, 4, 4, 32)), 'g '),
        (maxpool2x2_bwd_first, (meta(2, 6, 8, 4), meta(2, 3, 4, 4)), 'multiple of 16'),
        (maxpool2x2_bwd_first, (meta(2, 8, 8, 64), meta(2, 4, 4, 64, dt=torch.float32)),
         'maxpool2x2_bwd_first'),
        (maxpool2x2, (meta(2, 8, 8, 64), 'all'), 'ties'),
        (render_gaussian, (meta(2, 16, 2, dt=torch.int64), meta(2, 16, dt=torch.float32),
                           (16, 16), 1), 'int32'),
        (render_gaussian, (meta(2, 16, 2, dt=torch.int32), meta(2, 16, dt=torch.bfloat16),
                           (16, 16), 1), 'int32'),
    ]
    for fn, args, match in cases:
        with pytest.raises(ValueError, match=match):
            fn(*args)


@pytest.mark.parametrize('stacks,mobile', sorted(REFERENCE_COUNTS))
def test_param_counts_match_reference(stacks, mobile):
    model = HourglassNet(num_stacks=stacks, num_blocks=1, num_classes=16,
                         mobile=mobile, skip_mode='sum')
    n = sum(p.numel() for p in model.parameters())
    assert n == REFERENCE_COUNTS[(stacks, mobile)]
