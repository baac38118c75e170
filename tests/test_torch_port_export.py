"""Export and the serving tools of the port, on the CPU: the Hopper kernels
as `torch.library` ops (schema and fake against the CPU kernel), the
served function saved as a `torch.export` program and loaded back, held to
the JAX package's StableHLO artifacts (hg heatmaps; hg and MSPN with the
preprocess and the quarter decode), the bf16 program's graph (the kernels'
nodes, no fold arithmetic), the export CLI, `serve_http` serving a program
over HTTP, `serving_demo`'s three modes, and `step_cost` / `profile_step`.

1 stack (MSPN: 1 stage, decoder width 64) at 64^2 -> 16^2, f32 unless
stated. Weights: the port's seeded init with random BatchNorm affines and
statistics, carried to flax by `weights.to_jax_variables`; the port's
programs take that JAX tree through `load_jax_variables`. A program takes
seconds to trace, save and read here, so each is made once and shared."""

import collections
import io
import json
import os
import signal
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from hourglass_pose_estimation_tpu.export import export_stablehlo, load_stablehlo
from hourglass_pose_estimation_tpu.models import MSPN as JaxMSPN
from hourglass_pose_estimation_tpu.models import HourglassNet as JaxHourglassNet

from hourglass_pose_estimation_torch import serve_http, serving_demo
from hourglass_pose_estimation_torch.config import load_config
from hourglass_pose_estimation_torch.export import (
    InferenceModule, export_program, load_program)
from hourglass_pose_estimation_torch.export.__main__ import main as export_main
from hourglass_pose_estimation_torch.models import HourglassNet, MSPN, model_from_config
from hourglass_pose_estimation_torch.models.modules import Bottleneck
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.ops.hopper import KERNEL_WRAPPERS
from hourglass_pose_estimation_torch.ops.hopper import bottleneck as bk
from hourglass_pose_estimation_torch.runner import checkpoint
from hourglass_pose_estimation_torch.runner.checkpoint import restore_params
from hourglass_pose_estimation_torch.runner.train_state import init_state, make_optimizer
from hourglass_pose_estimation_torch.serving import load_serving_artifact
from hourglass_pose_estimation_torch.utils.summary import profile_step, step_cost
from hourglass_pose_estimation_torch.weights import to_jax_variables

torch.set_num_threads(1)

MEANSTD = ((0.406822, 0.444257, 0.466048), (0.228944, 0.232618, 0.236498))
JOINTS = 4
FRAME = (1, 96, 128, 3)
# the JAX package's own bound for its StableHLO round trip (f32 noise of
# another program over the same math)
TOL_HEATMAPS = dict(rtol=1e-4, atol=2e-5)
# keypoint programs: maxvals within 1e-4 (relative to the map's scale for
# MSPN, whose untrained activations reach O(100)); the keypoints equal
# except on maps whose two highest values lie within NEAR_TIE of each
# other, where the two programs' f32 noise can move the argmax
TOL_MAXVALS = 1e-4
NEAR_TIE = 1e-4


@pytest.fixture(scope='module', autouse=True)
def one_read_per_program():
    """`torch.export.load` turns a program's JSON graph into dataclasses
    for seconds here; every reader of one file in this module shares one
    read (`read_program` moves it and builds a new module each time)."""
    real, cache = torch.export.load, {}

    def load(path, *args, **kwargs):
        key = (os.fspath(path), os.path.getmtime(path))
        if key not in cache:
            cache[key] = real(path, *args, **kwargs)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.export, 'load', load)
        yield


def _seeded(model, seed):
    """The model with random BatchNorm affines and statistics from `seed`,
    and its weights as a JAX variable tree."""
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.from_numpy(1 + 0.1 * r.normal(size=n)))
                m.bias.copy_(torch.from_numpy(0.1 * r.normal(size=n)))
                m.running_mean.copy_(torch.from_numpy(0.1 * r.normal(size=n)))
                m.running_var.copy_(torch.from_numpy(0.5 + r.uniform(size=n)))
    return model, to_jax_variables(model)


@pytest.fixture(scope='module')
def hg():
    torch.manual_seed(0)
    return _seeded(HourglassNet(num_stacks=1, num_blocks=1, num_classes=JOINTS,
                                dtype=torch.float32), 1)


@pytest.fixture(scope='module')
def heatmap_program(hg, tmp_path_factory):
    """(path, loaded callable) of the hg heatmap program at [1, 64, 64, 3]."""
    path = str(tmp_path_factory.mktemp('hm') / 'model.pt2')
    export_program(hg[0], hg[1], (1, 64, 64, 3), path, device='cpu')
    return path, load_program(path, device='cpu')


def _near_ties(hm: np.ndarray) -> np.ndarray:
    """[B, J]: maps [B, H, W, J] whose two highest values lie within NEAR_TIE."""
    flat = np.sort(hm.reshape(hm.shape[0], -1, hm.shape[-1]), axis=1)
    return flat[:, -1] - flat[:, -2] <= NEAR_TIE


def _keypoint_programs(model, jax_model, variables, path, frame):
    """The port's and the JAX package's preprocess + quarter-decode
    programs (fold_bn) on one uint8 frame -> (port (kps, maxv), JAX (kps,
    maxv), the port's heatmaps), as numpy."""
    kw = dict(decode='quarter', fold_bn=True, preprocess=MEANSTD, input_res=64)
    export_program(model, variables, frame.shape, path, device='cpu', **kw)
    got = [t.numpy() for t in load_program(path, device='cpu')(frame)]
    jax_path = export_stablehlo(jax_model, variables, frame.shape, path + '.stablehlo', **kw)
    ref = [np.asarray(t) for t in load_stablehlo(jax_path)(jnp.asarray(frame))]
    kw.pop('decode')
    with torch.inference_mode():
        hm = InferenceModule(model, variables, device='cpu', **kw)(torch.from_numpy(frame))
    return got, ref, hm.numpy()


def _hold_keypoints(got, ref, hm, maxv_scale=1.0):
    kps, maxv = got
    jkps, jmaxv = ref[0], ref[1].reshape(maxv.shape)
    assert kps.shape == jkps.shape == (1, hm.shape[-1], 2)
    np.testing.assert_allclose(maxv, jmaxv, rtol=0, atol=TOL_MAXVALS * maxv_scale)
    ties = _near_ties(hm)
    moved = (kps != jkps).any(-1)
    print(f'{int(ties.sum())} of {ties.size} maps near a tie; {int(moved.sum())} moved')
    assert not (moved & ~ties).any(), (kps, jkps)


# --- the kernels as ops ---------------------------------------------------

def _op_cases():
    r = np.random.RandomState(0)
    t = lambda *s, dt=torch.float32: torch.from_numpy(r.normal(size=s)).to(dt)
    C, P = 2 * bk.PLANES, bk.PLANES
    w = lambda *s: bk._n_major(t(*s, dt=torch.bfloat16) * 0.05)
    params = bk.BottleneckParams(t(C), t(C), w(C, P), t(P), t(P), t(P), w(3, 3, P, P),
                                 t(P), t(P), t(P), w(P, C), t(C))
    xb = t(1, 4, 4, C, dt=torch.bfloat16)
    mu = torch.from_numpy(r.randint(-3, 20, size=(2, JOINTS, 2))).to(torch.int32)
    return {
        'fused_bottleneck_chunked': (xb, *params),
        'fused_bottleneck_image': (xb, *params),
        'upsample2x_add': (t(2, 4, 4, 16), t(2, 8, 8, 16)),
        'upsample2x_add_bwd': (t(2, 8, 8, 16),),
        'maxpool2x2_fwd': (t(2, 8, 8, 16),),
        'maxpool2x2_bwd': (t(2, 8, 8, 16), t(2, 4, 4, 16)),
        'maxpool2x2_bwd_first': (t(2, 8, 8, 16), t(2, 4, 4, 16)),
        'render_gaussian': (mu, torch.ones(2, JOINTS), 16, 12, 1.0),
        'decode_peaks': (t(2, 8, 8, JOINTS),),
        **_batch_norm_cases(t),
    }


def _batch_norm_cases(t):
    """The fused train-mode BatchNorm's four ops on channels-last
    [2, 16, 4, 4] activations: the sampled statistics, the apply with the
    ReLU, a bf16 output and the running buffers moved, and the backward's
    two ops on a bf16 output gradient."""
    cl = torch.channels_last
    x = t(2, 16, 4, 4).contiguous(memory_format=cl)
    g = t(2, 16, 4, 4, dt=torch.bfloat16).contiguous(memory_format=cl)
    w, b, m = t(16).abs() + 0.5, t(16), t(2, 16).abs()
    return {
        'batch_norm_train_stats': (x, 1, 16.0),
        'batch_norm_train_fwd': (x, m, w, b, t(16), t(16).abs(), 1.0, 0.9, 1e-5, True,
                                 torch.bfloat16),
        'batch_norm_train_bwd_reduce': (g, x, m, w, b, 1.0, 1e-5, True),
        'batch_norm_train_bwd': (g, x, m, w, b, t(2, 16), 1, 16.0, 1.0, 1e-5, True),
    }


@pytest.mark.parametrize('name', sorted(w.__name__ for w in KERNEL_WRAPPERS))
def test_kernel_op_schema_and_fake(name):
    """Each kernel is an `hpe::` op whose schema, fake and CPU kernel (the
    plain version) agree."""
    torch.library.opcheck(getattr(torch.ops.hpe, name).default, _op_cases()[name])


# --- programs against the JAX package's artifacts -------------------------

def test_heatmap_program_matches_jax_stablehlo(hg, heatmap_program, tmp_path):
    model, variables = hg
    x = np.random.RandomState(2).normal(size=(1, 64, 64, 3)).astype(np.float32)
    got = heatmap_program[1](x).numpy()
    jax_model = JaxHourglassNet(num_stacks=1, num_blocks=1, num_classes=JOINTS,
                                dtype=jnp.float32)
    path = export_stablehlo(jax_model, variables, x.shape, str(tmp_path / 'hm.stablehlo'))
    ref = np.asarray(load_stablehlo(path)(jnp.asarray(x)))
    assert got.shape == ref.shape == (1, 16, 16, JOINTS)
    np.testing.assert_allclose(got, ref, **TOL_HEATMAPS)


def test_keypoint_program_matches_jax_stablehlo(hg, tmp_path):
    """uint8 frames of another size -> /255, resize, normalize, the folded
    model and the quarter decode, in one program."""
    frame = np.random.RandomState(3).randint(0, 256, FRAME).astype(np.uint8)
    jax_model = JaxHourglassNet(num_stacks=1, num_blocks=1, num_classes=JOINTS,
                                dtype=jnp.float32)
    got, ref, hm = _keypoint_programs(hg[0], jax_model, hg[1], str(tmp_path / 'kp.pt2'),
                                      frame)
    _hold_keypoints(got, ref, hm)
    assert float(got[0].max()) <= 64.5           # network-input pixels


def test_mspn_keypoint_program_matches_jax_stablehlo(tmp_path):
    torch.manual_seed(4)
    kw = dict(num_stacks=1, num_classes=JOINTS, out_res=16, up_channel_num=64)
    model, variables = _seeded(MSPN(dtype=torch.float32, **kw), 5)
    frame = np.random.RandomState(6).randint(0, 256, FRAME).astype(np.uint8)
    got, ref, hm = _keypoint_programs(model, JaxMSPN(dtype=jnp.float32, **kw), variables,
                                      str(tmp_path / 'mspn.pt2'), frame)
    _hold_keypoints(got, ref, hm, maxv_scale=max(1.0, float(np.abs(hm).max())))


# --- the export CLI, the bf16 program, serving --------------------------

@pytest.fixture(scope='module')
def cli_program(tmp_path_factory):
    """The export CLI on a tiny config and a port checkpoint (1 stack,
    64^2, 16 joints, bf16, MODEL.fuse_block at its default, on):
    -> (config, checkpoint, program path, load_serving_artifact's result)."""
    tmp = tmp_path_factory.mktemp('cli')
    cfg_path = tmp / 'cfg.yaml'
    ckpt = str(tmp / 'ckpt')
    cfg_path.write_text(
        'DATASET:\n  name: mpii\n  inp_res: 64\n  out_res: 16\n'
        'MODEL:\n  arch: hg\n  num_stacks: 1\n  num_blocks: 1\n  num_classes: 16\n'
        f'COMMON:\n  checkpoint_dir: {tmp}\n  resume: {ckpt}\n')
    cfg = load_config(str(cfg_path))
    torch.manual_seed(7)
    model, _ = _seeded(model_from_config(cfg.model, num_classes=16, out_res=16,
                                         device='cpu'), 8)
    checkpoint.save(ckpt, init_state(model, make_optimizer(2.5e-4, [2], 0.1, 3)),
                    epoch=1, best_acc=0.0)
    overrides = ['EVAL.export_keypoints=true', 'EVAL.export_preprocess=true',
                 'EVAL.export_batch=3', 'EVAL.export_bf16_weights=true']
    assert export_main([str(cfg_path), *overrides, '--device', 'cpu']) == 0
    path = str(tmp / 'export' / 'model.pt2')
    return (load_config(str(cfg_path), overrides=overrides), ckpt, path,
            load_serving_artifact(path, device='cpu'))


def test_export_cli_writes_a_serving_program(cli_program, capsys):
    fn, batch, frame_shape, dtype = cli_program[3]
    assert (batch, frame_shape, dtype) == (3, (64, 64, 3), np.uint8)
    kps, maxv = fn(np.random.RandomState(9).randint(0, 256, (3, 64, 64, 3)).astype(np.uint8))
    assert kps.shape == (3, 16, 2) and maxv.shape == (3, 16)
    assert bool(torch.isfinite(kps).all() and torch.isfinite(maxv).all())
    cfg_path = os.path.join(os.path.dirname(cli_program[1]), 'cfg.yaml')
    with pytest.raises(FileNotFoundError, match="Checkpoint doesn't exist"):
        export_main([cfg_path, 'COMMON.resume=/nonexistent', '--device', 'cpu'])


class _CountOps(TorchDispatchMode):
    """Counts the `hpe::` ops an eager call runs."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == 'hpe':
            self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_bf16_program_keeps_the_kernels_and_no_fold(cli_program):
    """The CLI's bf16 program (fused blocks on) holds one `hpe::` node for
    each kernel call of the eager forward, its bottleneck nodes read the
    frozen folds as constants (no fold arithmetic in the graph), and it
    gives the eager module's bits."""
    cfg, ckpt, path, (fn, *_) = cli_program
    module = InferenceModule(
        model_from_config(cfg.model, num_classes=16, out_res=16, device='cpu'),
        restore_params(ckpt), decode='quarter', fold_bn=True, weights_dtype=torch.bfloat16,
        preprocess=MEANSTD, input_res=64, device='cpu')
    frames = torch.from_numpy(np.random.RandomState(10).randint(
        0, 256, (3, 64, 64, 3)).astype(np.uint8))
    with torch.inference_mode(), _CountOps() as eager:
        want = module(frames)
    assert eager.counts['hpe.fused_bottleneck_chunked'] == 3     # the 16^2 blocks
    assert eager.counts['hpe.maxpool2x2_fwd'] == 5 and eager.counts['hpe.decode_peaks'] == 1

    program = torch.export.load(path)
    nodes = [n for n in program.graph.nodes if n.op == 'call_function'
             and getattr(n.target, 'namespace', None) == 'hpe']
    assert collections.Counter(str(n.target.overloadpacket) for n in nodes) == eager.counts
    buffers = program.graph_signature.inputs_to_buffers
    for n in nodes:
        if 'bottleneck' in str(n.target):
            folds = [buffers.get(a.name, '') for a in n.args[1:]]
            assert all(a.op == 'placeholder' for a in n.args[1:])
            assert [f.rsplit('.', 1)[-1] for f in folds] == [
                f'fold_{k}' for k in bk.BottleneckParams._fields]
    got = fn(frames)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_frozen_fold_refuses_to_train():
    torch.manual_seed(11)
    block = Bottleneck(256, 128, fuse_block=True).eval()
    x = torch.randn(1, 256, 16, 16)
    with torch.no_grad():
        live = block(x)
        block.freeze_fold()
        assert torch.equal(block(x), live)
    with pytest.raises(RuntimeError, match='frozen'):
        block(x)
    with torch.no_grad(), pytest.raises(RuntimeError, match='frozen'):
        block(x, train=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_serve_http_serves_a_program(cli_program, monkeypatch, capsys):
    """`serve_http <model.pt2>` over an HTTP round trip: each reply equals the
    program's own answer for that frame; SIGTERM drains."""
    fn = cli_program[3][0]
    handlers = {}
    monkeypatch.setattr(signal, 'signal', lambda sig, h: handlers.__setitem__(sig, h))
    port = _free_port()
    server = threading.Thread(target=serve_http.main, args=(
        [cli_program[2], '--device', 'cpu', '--port', str(port), '--max-wait-ms', '50'],))
    server.start()
    base = f'http://127.0.0.1:{port}'
    for _ in range(600):
        try:
            urllib.request.urlopen(base + '/healthz', timeout=5).read()
            break
        except OSError:
            time.sleep(0.1)
    frames = np.random.RandomState(12).randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    try:
        replies = []
        for f in frames:
            buf = io.BytesIO()
            np.save(buf, f)
            req = urllib.request.Request(base + '/keypoints', data=buf.getvalue(),
                                         headers={'Content-Type': 'application/x-npy'})
            with urllib.request.urlopen(req, timeout=120) as r:
                replies.append(json.loads(r.read()))
        stats = json.loads(urllib.request.urlopen(base + '/stats', timeout=5).read())
    finally:
        handlers[signal.SIGTERM]()
        server.join(60)
    assert not server.is_alive()
    assert stats['frames'] == 3 and stats['batch_size'] == 3
    for i, r in enumerate(replies):
        kps, maxv = fn(np.stack([frames[i]] * 3))
        assert r['keypoints'] == kps[0].double().tolist()
        assert r['scores'] == maxv[0].double().tolist()
    out = capsys.readouterr().out
    assert 'model.pt2' in out and 'drained; bye' in out


def test_serving_demo_modes(heatmap_program, tmp_path, capsys):
    """sync (with --skeleton, --out and --profile), async over a directory and
    sustained, on three seeded JPEGs through the heatmap program."""
    import cv2
    frames = tmp_path / 'frames'
    frames.mkdir()
    r = np.random.RandomState(13)
    for i in range(3):
        cv2.imwrite(str(frames / f'{i}.jpg'), r.randint(0, 256, (96, 128, 3)).astype(np.uint8))
    path, common = heatmap_program[0], ['--res', '64', '--dataset', 'mpii', '--device', 'cpu']
    out = tmp_path / 'sync.jpg'
    assert serving_demo.main(['sync', path, str(frames / '0.jpg'), '--iters', '2',
                              '--skeleton', '--out', str(out),
                              '--profile', str(tmp_path / 'trace'), *common]) == 0
    assert cv2.imread(str(out)).shape == (96, 128, 3)
    assert os.path.getsize(tmp_path / 'trace' / 'trace.json') > 0
    assert serving_demo.main(['async', path, str(frames), str(tmp_path / 'drawn'),
                              *common]) == 0
    assert sorted(os.listdir(tmp_path / 'drawn')) == ['0.jpg', '1.jpg', '2.jpg']
    assert serving_demo.main(['sustained', path, str(frames / '1.jpg'), '--iters', '4',
                              *common]) == 0
    text = capsys.readouterr().out
    assert 'median' in text and '3 frames' in text and 'differential' in text
    # a keypoint program's result: circles where the maxval clears 0.02
    drawn = serving_demo.draw(np.zeros((96, 128, 3), np.uint8),
                              (torch.tensor([[[32.0, 16.0]]]), torch.tensor([[0.5]])), res=64)
    assert drawn[24, 64].any()


def test_step_cost_and_profile_step(tmp_path):
    x, w = torch.randn(2, 8, 10, 12), torch.randn(6, 8, 3, 3)
    conv = lambda a: F.conv2d(a, w, padding=1)
    assert step_cost(conv, x) == {'flops': 2 * 2 * 10 * 12 * 8 * 6 * 3 * 3}
    trace = profile_step(conv, x, trace_dir=str(tmp_path / 'trace'))
    assert json.loads((tmp_path / 'trace' / 'trace.json').read_text())['traceEvents']
    assert trace == str(tmp_path / 'trace')
