"""Port serving front-end on the CPU: MicroBatcher (padding, fan-out,
QueueFull, cancel-shedding), the HTTP round trip over a port inference
function, and the `serve_http` entry point with its SIGTERM drain."""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hourglass_pose_estimation_torch.export import make_inference_fn
from hourglass_pose_estimation_torch.models import get_model
from hourglass_pose_estimation_torch.serving import (
    MicroBatcher, QueueFull, _fetch_tree, make_server)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_microbatcher_pads_and_fans_out():
    calls = []

    def infer(batch):
        calls.append(batch.copy())
        time.sleep(0.02)
        t = torch.from_numpy(batch).to(torch.float32)
        return t.sum(dim=(1, 2, 3)), t.amax(dim=(1, 2, 3))

    mb = MicroBatcher(infer, batch_size=4, frame_shape=(8, 8, 3),
                      max_wait_ms=50.0)
    frames = [np.random.RandomState(s).randint(0, 255, (8, 8, 3), np.uint8)
              for s in range(10)]
    try:
        got = [f.result(timeout=30) for f in [mb.submit(f) for f in frames]]
    finally:
        mb.close()
    for frame, (s, m) in zip(frames, got):
        assert isinstance(s, np.ndarray) and s.shape == ()
        assert float(s) == float(frame.astype(np.float32).sum())
        assert float(m) == float(frame.max())
    assert mb.n_batches < mb.n_requests == 10 and mb.n_frames == 10
    assert all(c.shape == (4, 8, 8, 3) for c in calls)   # padded to B


def test_microbatcher_zero_pads_a_partial_batch():
    calls = []

    def infer(batch):
        calls.append(batch.copy())
        return torch.zeros(len(batch))

    mb = MicroBatcher(infer, 4, (2, 2, 1), max_wait_ms=1.0)
    try:
        frame = np.full((2, 2, 1), 255, np.uint8)
        assert float(mb.submit(frame).result(timeout=30)) == 0.0
    finally:
        mb.close()
    assert calls[0].shape == (4, 2, 2, 1)
    assert (calls[0][0] == 255).all() and not calls[0][1:].any()


def test_microbatcher_queue_full_and_cancel_shedding():
    release = threading.Event()

    def slow(batch):
        release.wait(30)
        return torch.from_numpy(batch).to(torch.float32).sum(dim=(1, 2, 3))

    mb = MicroBatcher(slow, batch_size=2, frame_shape=(4, 4, 3),
                      max_wait_ms=1.0, max_queue=3)
    frame = np.zeros((4, 4, 3), np.uint8)
    try:
        first = mb.submit(frame)
        deadline = time.monotonic() + 5
        while mb._q and time.monotonic() < deadline:
            time.sleep(0.01)
        queued = [mb.submit(frame) for _ in range(3)]
        with pytest.raises(QueueFull):
            mb.submit(frame)
        assert mb.n_rejected == 1
        assert queued[0].cancel()
        release.set()
        for fut in queued[1:]:
            assert float(fut.result(timeout=30)) == 0.0
        assert float(first.result(timeout=30)) == 0.0
    finally:
        mb.close()
    assert mb.n_shed == 1 and mb.n_frames == 3
    with pytest.raises(ValueError, match='frame shape'):
        MicroBatcher(slow, 1, (4, 4, 3)).submit(np.zeros((5, 4, 3), np.uint8))


def test_fetch_tree_copies_each_tensor_to_host():
    out = _fetch_tree((torch.arange(6.0).reshape(2, 3), torch.ones(2)))
    assert all(isinstance(o, np.ndarray) for o in out)
    np.testing.assert_array_equal(out[0], np.arange(6.0).reshape(2, 3))


def _post_npy(base, frame, timeout=60):
    buf = io.BytesIO()
    np.save(buf, frame)
    req = urllib.request.Request(base + '/keypoints', data=buf.getvalue(),
                                 headers={'Content-Type': 'application/x-npy'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_round_trip_with_port_inference_fn():
    model = get_model('hg', device='cpu', num_stacks=1, num_classes=16,
                      num_feats=16, dtype=torch.float32, fuse_block=True,
                      fuse_upsample=True)
    fn = make_inference_fn(model, None, decode='quarter', fold_bn=True,
                           preprocess=((0.4, 0.44, 0.47), (0.23, 0.23, 0.24)),
                           input_res=64, device='cpu')
    mb = MicroBatcher(fn, 4, (64, 64, 3), max_wait_ms=50.0)
    srv = make_server(mb, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f'http://{srv.server_address[0]}:{srv.server_address[1]}'
    frames = [np.random.RandomState(s).randint(0, 255, (64, 64, 3)).astype(np.uint8)
              for s in range(6)]
    try:
        with ThreadPoolExecutor(6) as ex:
            outs = list(ex.map(lambda f: _post_npy(base, f), frames))
        for frame, out in zip(frames, outs):
            kps = np.asarray(out['keypoints'])
            assert kps.shape == (16, 2) and len(out['scores']) == 16
            assert np.isfinite(kps).all()
            assert kps.min() >= -0.5 and kps.max() <= 64.5
        ref_k, _ = fn(np.stack(frames[:1]))
        np.testing.assert_allclose(np.asarray(outs[0]['keypoints']),
                                   ref_k[0].numpy(), atol=1e-5)
        bad = urllib.request.Request(
            base + '/keypoints', data=b'not-a-frame',
            headers={'Content-Type': 'application/x-npy'})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(bad, timeout=30)
        assert exc.value.code == 400
        assert 'error' in json.loads(exc.value.read())
        with urllib.request.urlopen(base + '/stats', timeout=30) as r:
            stats = json.loads(r.read())
        assert stats['frames'] == 6 and stats['batch_size'] == 4
    finally:
        srv.shutdown()
        mb.close()


@pytest.mark.parametrize('overrides,on', [([], True),
                                          (['MODEL.fuse_block=false'], False)])
def test_serve_http_kernel_switches_follow_fuse_block(tmp_path, monkeypatch,
                                                      overrides, on):
    """MODEL.fuse_block (on by default in the port) turns on both the
    fused bottleneck and the fused upsample+add of the served model."""
    from hourglass_pose_estimation_torch import export, serve_http
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.models.modules import Bottleneck, Hourglass
    weights = tmp_path / 'weights.pt'
    torch.save({}, weights)          # the stand-in below loads nothing
    seen = []
    monkeypatch.setattr(export, 'make_inference_fn',
                        lambda model, *a, **k: seen.append(model))
    cfg = load_config(raw={'DATASET': {'name': 'mpii', 'inp_res': 64, 'out_res': 16},
                           'MODEL': {'num_stacks': 1}}, overrides=overrides)
    serve_http.build_inference(cfg, str(weights), device='cpu')
    (model,) = seen
    assert [m.fuse_block for m in model.modules() if isinstance(m, Bottleneck)] \
        == [on] * sum(isinstance(m, Bottleneck) for m in model.modules())
    assert all(m.fuse_upsample is on for m in model.modules()
               if isinstance(m, Hourglass))


def test_serve_http_main_serves_and_drains_on_sigterm(tmp_path):
    cfg = tmp_path / 'tiny.yaml'
    cfg.write_text(
        'DATASET:\n  name: mpii\n  inp_res: 64\n  out_res: 16\n'
        'MODEL:\n  arch: hg\n  num_stacks: 1\n'
        'EVAL:\n  export_keypoints: True\n  export_preprocess: True\n'
        '  export_batch: 2\n')
    model = get_model('hg', device='cpu', num_stacks=1, num_classes=16)
    weights = tmp_path / 'weights.pt'
    torch.save(model.state_dict(), weights)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'hourglass_pose_estimation_torch.serve_http',
         str(cfg), str(weights), '--device', 'cpu', '--port', '0'],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, 'OMP_NUM_THREADS': '1'})
    try:
        seen = []
        while not seen or 'serving hg s1' not in seen[-1]:
            seen.append(proc.stdout.readline())
            assert seen[-1] and len(seen) < 50, ''.join(seen)
        line = seen[-1]
        assert 'on cpu' in line
        base = line.strip().rsplit(' ', 1)[-1]
        out = _post_npy(base, np.zeros((64, 64, 3), np.uint8))
        assert np.asarray(out['keypoints']).shape == (16, 2)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        assert 'drained; bye' in rest
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
