#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failed check exits non-zero; no phase catches its own
failure):
  1. the card's name and power limit (nvidia-smi);
  2. build the Hopper kernels from `hourglass_pose_estimation_torch/
     csrc/*.cu` (nvcc, into the package's ignored build directory);
  3. each kernel at the serving path's shapes against its plain PyTorch
     version on the card, with the tolerance stated, and timed (CUDA
     events) beside its plain version and its bound;
  4. the serving path: the flagship 8-stack hourglass of
     configs/train_mpii_8stack.yaml with seeded weights, built by
     serve_http.build_inference into a frames -> keypoints function
     (MODEL.fuse_block at its default, on: fused bottleneck, fused
     upsample+add, peak decode) behind MicroBatcher(batch 64) and the
     HTTP server on
     127.0.0.1, answering 256 POSTed uint8 256x256 frames from 4 client
     processes of 16 connections each; every reply is checked;
  5. the kernels' launch counts in that run: 65 bottleneck, 32 upsample
     and 1 decode launch per batch;
  6. the last-stack heatmaps of the kernel path against the same weights
     with the three kernels switched off (card, bf16), and against an f32
     run of the plain path on the CPU for two frames;
  7. latency and throughput, then the `kernels` JSON line, then the
     result line.
--profile adds a torch.profiler breakdown of one batch by kernel.
It exits with a non-zero code, printing no result, without a CUDA device
or without the port package beside it.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import multiprocessing
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 64
RES = 256
N_REQUESTS = 256
CLIENT_PROCS = 4          # load generators run in their own processes
CLIENT_THREADS = 16       # concurrent connections per client process
# bounds: NVIDIA H100 SXM data-sheet peaks (dense bf16 tensor cores,
# f32 outside them, HBM3 bandwidth)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# tolerances: relative L2 of the kernel against its plain version on the
# same inputs. The bottleneck's plain version rounds at the same points
# (t1, t2, t3, h3 to bf16) and differs only in f32 summation order and
# the bf16 roundings that order flips; upsample and decode are exact.
# The bottleneck is held on its residual branch, out - x (what the kernel
# computes; read at ~5e-4 on an H100), and on the whole output.
TOL_BOTTLENECK = 1e-2
# kernel path vs the path with the kernels off (both bf16 on the card):
# the unfused blocks round each conv output to bf16 where the kernel
# keeps f32, so the two differ by bf16 noise through 8 stacks (read at
# 7.6e-3 on an H100)
TOL_SWITCHES = 3e-2
# bf16 card path vs the f32 plain path on the CPU, two frames (read at
# 7.3e-3 on an H100). Keypoints are not compared: random weights give
# flat, near-tied heatmaps whose argmax flips under bf16 noise.
TOL_F32_REFERENCE = 3e-2


def fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, bytes_: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops > t_bytes else 'bytes')


def randomize_bn_(model, gen) -> None:
    """Random BatchNorm affine and running statistics, from `gen`."""
    import torch
    from hourglass_pose_estimation_torch.models.norm import BatchNorm
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                r = lambda: torch.randn(n, generator=gen)
                m.weight.copy_(1 + 0.1 * r())
                m.bias.copy_(0.1 * r())
                m.running_mean.copy_(0.1 * r())
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def kernel_phases(seed: int):
    """Each kernel vs its plain version at the serving path's shapes."""
    import torch
    from hourglass_pose_estimation_torch.models.modules import Bottleneck
    from hourglass_pose_estimation_torch.ops.hopper import (
        bottleneck_reference, decode_peaks, decode_peaks_reference,
        fused_bottleneck, upsample2x_add, upsample2x_add_reference)

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    rows = []

    # --- fused bottleneck: 64 images at 64^2, 32^2, 16^2, C=256, P=128
    blk = Bottleneck(256, 128, fuse_block=True)
    randomize_bn_(blk, gen)
    prm = blk.to(dev).fused_params()
    per_shape = {}
    for hw in (64, 32, 16):
        x = torch.randn(BATCH, hw, hw, 256, generator=gen).to(dev, torch.bfloat16)
        got = fused_bottleneck(x, prm)
        ref = bottleneck_reference(x, prm)
        torch.cuda.synchronize()
        err = rel_l2(got, ref)
        branch = rel_l2(got.float() - x.float(), ref.float() - x.float())
        check(bool(torch.isfinite(got.float()).all()), f'bottleneck {hw}^2 not finite')
        check(err <= TOL_BOTTLENECK, f'bottleneck {hw}^2 rel L2 {err:.3e} > {TOL_BOTTLENECK}')
        check(branch <= TOL_BOTTLENECK,
              f'bottleneck {hw}^2 branch rel L2 {branch:.3e} > {TOL_BOTTLENECK}')
        npix = BATCH * hw * hw
        flops = 2.0 * npix * (256 * 128 * 2 + 9 * 128 * 128)
        nbytes = 2.0 * npix * 256 * 2 + 2 * (256 * 128 * 2 + 9 * 128 * 128) + 4 * (3 * 256 + 6 * 128)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16)
        per_shape[hw] = dict(
            hw=hw, rel_l2=err, rel_l2_branch=branch,
            max_abs_err=float((got.float() - ref.float()).abs().max()),
            ms=time_ms(lambda: fused_bottleneck(x, prm), 20),
            plain_ms=time_ms(lambda: bottleneck_reference(x, prm), 5),
            bound_ms=b_ms, bound_by=b_by, tflops=flops / 1e9)
        per_shape[hw]['tflops'] = flops / per_shape[hw]['ms'] / 1e9
        print(f'bottleneck {hw}x{hw}: ' + json.dumps(per_shape[hw]), flush=True)
        del x, got, ref
    s = per_shape[64]
    rows.append(dict(name='fused_bottleneck', route='cuda',
                     source='hourglass_pose_estimation_torch/csrc/bottleneck.cu',
                     replaces='hourglass_pose_estimation_tpu/ops/pallas/bottleneck.py:259',
                     max_abs_err=s['max_abs_err'], ms=s['ms'], plain_ms=s['plain_ms'],
                     bound_ms=s['bound_ms'], bound_by=s['bound_by'], library_ms=None,
                     shape='[64,64,64,256] bf16', rel_l2=s['rel_l2']))

    # --- upsample + add: low [64,32,32,256] -> [64,64,64,256], plus H=12
    for (b, h, c) in ((2, 12, 256), (BATCH, 32, 256)):
        low = torch.randn(b, h, h, c, generator=gen).to(dev, torch.bfloat16)
        skip = torch.randn(b, 2 * h, 2 * h, c, generator=gen).to(dev, torch.bfloat16)
        got = upsample2x_add(low, skip)
        ref = upsample2x_add_reference(low, skip)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f'upsample h={h} differs from its plain version')
    nbytes = 2.0 * (low.numel() + 2 * skip.numel())
    b_ms, b_by = bound_ms(skip.numel(), nbytes, PEAK_F32)
    rows.append(dict(name='upsample2x_add', route='cuda',
                     source='hourglass_pose_estimation_torch/csrc/upsample.cu',
                     replaces='hourglass_pose_estimation_tpu/ops/pallas/upsample.py:87',
                     max_abs_err=float((got.float() - ref.float()).abs().max()),
                     ms=time_ms(lambda: upsample2x_add(low, skip), 50),
                     plain_ms=time_ms(lambda: upsample2x_add_reference(low, skip), 20),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape='low [64,32,32,256] bf16'))
    del low, skip, got, ref

    # --- peak decode: [64,64,64,16] f32 with planted ties, edges, flats
    hm = torch.rand(BATCH, 64, 64, 16, generator=gen)
    hm[0, 10, 10, 0] = hm[0, 12, 3, 0] = 5.0
    hm[1, 0, 5, 1] = 5.0
    hm[2, 30, 30, 2] = 5.0
    hm[2, 30, 31, 2] = hm[2, 30, 29, 2] = 0.5
    hm[3, :, :, 3] = 0.0
    hm = hm.to(dev)
    (gc, gm), (rc, rm) = decode_peaks(hm), decode_peaks_reference(hm)
    torch.cuda.synchronize()
    check(torch.equal(gc, rc) and torch.equal(gm, rm), 'decode differs from its plain version')
    check(gc[0, 0, 1].item() in (9.75, 10.0, 10.25), 'decode tie not first row-major')
    nbytes = 4.0 * (hm.numel() + gc.numel() + gm.numel())
    b_ms, b_by = bound_ms(hm.numel(), nbytes, PEAK_F32)
    rows.append(dict(name='decode_peaks', route='cuda',
                     source='hourglass_pose_estimation_torch/csrc/decode.cu',
                     replaces='hourglass_pose_estimation_tpu/ops/pallas/decode.py:61',
                     max_abs_err=float(max((gc - rc).abs().max(), (gm - rm).abs().max())),
                     ms=time_ms(lambda: decode_peaks(hm), 50),
                     plain_ms=time_ms(lambda: decode_peaks_reference(hm), 20),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape='[64,64,64,16] f32'))
    return rows


def post_npy(base: str, frame) -> dict:
    import numpy as np
    buf = io.BytesIO()
    np.save(buf, frame)
    req = urllib.request.Request(base + '/keypoints', data=buf.getvalue(),
                                 headers={'Content-Type': 'application/x-npy'})
    with urllib.request.urlopen(req, timeout=300) as r:    # raises on non-2xx
        return json.loads(r.read())


def client_frames(seed: int, n: int):
    import numpy as np
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, RES, RES, 3)).astype(np.uint8)


def run_client(base: str, seed: int, n: int, threads: int):
    """One load-generating client process: n frames from `threads`
    concurrent connections -> (start, end, replies); the clock starts
    after the frames are made."""
    frames = client_frames(seed, n)
    t0 = time.time()
    with ThreadPoolExecutor(threads) as ex:
        replies = list(ex.map(lambda f: post_npy(base, f), frames))
    return t0, time.time(), replies


def serve_load(fn, seed: int):
    """Serve `fn` behind MicroBatcher(BATCH) + the HTTP server and POST
    N_REQUESTS frames from the client processes -> (replies, seconds,
    batcher stats, batcher)."""
    import numpy as np
    from hourglass_pose_estimation_torch.serving import MicroBatcher, make_server
    batcher = MicroBatcher(fn, BATCH, (RES, RES, 3), dtype=np.uint8,
                           max_wait_ms=50.0, max_queue=4 * N_REQUESTS)
    srv = make_server(batcher, '127.0.0.1', 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f'http://127.0.0.1:{srv.server_address[1]}'
    per_proc = N_REQUESTS // CLIENT_PROCS
    try:
        with multiprocessing.get_context('spawn').Pool(CLIENT_PROCS) as pool:
            parts = pool.starmap(run_client, [
                (base, seed + 1 + i, per_proc, CLIENT_THREADS)
                for i in range(CLIENT_PROCS)])
        stats = batcher.stats()
    finally:
        srv.shutdown()
        batcher.close()
    serve_s = max(p[1] for p in parts) - min(p[0] for p in parts)
    return [r for part in parts for r in part[2]], serve_s, stats, batcher


def set_switches(model, on: bool):
    from hourglass_pose_estimation_torch.models.modules import Bottleneck, Hourglass
    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.fuse_block = on
        elif isinstance(m, Hourglass):
            m.fuse_upsample = on
    return model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile', action='store_true')
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if not (REPO / 'hourglass_pose_estimation_torch').is_dir():
        print('chip_smoke: hourglass_pose_estimation_torch/ not found beside '
              'this script', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.data import get_meanstd, resolve_num_classes
    from hourglass_pose_estimation_torch.export import make_inference_fn
    from hourglass_pose_estimation_torch.models import HourglassNet, get_model
    from hourglass_pose_estimation_torch.ops.hopper import KERNEL_WRAPPERS, _build
    from hourglass_pose_estimation_torch.serve_http import build_inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.time()

    # 1. the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else 'unknown'
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} device {kind}', flush=True)

    # 2. build
    t0 = time.time()
    lib = _build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    print(f'build: {time.time() - t0:.1f} s; ' + ' | '.join(ptxas), flush=True)

    # 3. kernels vs plain
    rows = kernel_phases(args.seed)

    # 4. the serving path at full width, built as serve_http builds it
    # from the config (MODEL.fuse_block at its default) and the weights
    cfg = load_config(str(REPO / 'configs' / 'train_mpii_8stack.yaml'), overrides=[
        'EVAL.export_keypoints=true', 'EVAL.export_preprocess=true',
        f'EVAL.export_batch={BATCH}', 'EVAL.export_bf16_weights=true'])
    torch.manual_seed(args.seed)
    model_kw = dict(num_stacks=cfg.model.num_stacks, num_blocks=cfg.model.num_blocks,
                    num_classes=resolve_num_classes(cfg), mobile=cfg.model.mobile,
                    skip_mode=cfg.model.skip_mode)
    model = get_model('hg', device='cpu', **model_kw)     # the kernels off
    randomize_bn_(model, torch.Generator().manual_seed(args.seed + 1))
    weights = io.BytesIO()
    torch.save(model.state_dict(), weights)
    weights.seek(0)
    fn, batch, frame_shape, frame_dtype = build_inference(cfg, weights)
    check(batch == BATCH and frame_shape == (RES, RES, 3) and frame_dtype == np.uint8,
          f'serve_http built batch {batch}, frames {frame_shape} {frame_dtype}')
    meanstd = get_meanstd(cfg.dataset.name)
    build = lambda m, decode, device='cuda': make_inference_fn(
        m, None, decode=decode, fold_bn=True, weights_dtype=torch.bfloat16,
        preprocess=meanstd, input_res=RES, device=device)
    frames = client_frames(args.seed, BATCH)
    t0 = time.time()
    fn(frames[:BATCH])
    torch.cuda.synchronize()
    print(f'first batch (cuDNN plans, allocator): {time.time() - t0:.2f} s', flush=True)

    for w in KERNEL_WRAPPERS:
        w.launches = 0
    replies, serve_s, stats, batcher = serve_load(fn, args.seed)
    launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    for i, r in enumerate(replies):
        kps = np.asarray(r['keypoints'], np.float64)
        check(kps.shape == (16, 2) and len(r['scores']) == 16, f'reply {i} shape {kps.shape}')
        check(bool(np.isfinite(kps).all() and np.isfinite(r['scores']).all()),
              f'reply {i} not finite')
        check(bool((kps >= 0).all() and (kps <= RES).all()), f'reply {i} outside the frame')
    nb = batcher.n_batches
    check(batcher.n_frames == N_REQUESTS and nb >= 1, f'served {batcher.n_frames} frames')
    print(f'served {len(replies)} requests in {nb} batches '
          f'({batcher.n_frames / nb:.1f} frames each), {serve_s:.3f} s; '
          f'launches {launches}', flush=True)

    # 5. launch counts of the main path
    want = {'fused_bottleneck': 65 * nb, 'upsample2x_add': 32 * nb, 'decode_peaks': nb}
    check(launches == want, f'launch counts {launches} != {want}')

    # 6. kernel path vs kernels off (card) and vs f32 plain on the CPU
    x64 = frames[:BATCH]
    hm_fn = build(set_switches(copy.deepcopy(model), True), None)
    off_fn = build(model, None)
    hm_k, hm_off = hm_fn(x64), off_fn(x64)
    torch.cuda.synchronize()
    err_switch = rel_l2(hm_k, hm_off)
    check(bool(torch.isfinite(hm_k).all()), 'heatmaps not finite')
    check(tuple(hm_k.shape) == (BATCH, RES // 4, RES // 4, 16), f'heatmaps {tuple(hm_k.shape)}')
    check(err_switch <= TOL_SWITCHES, f'kernel path vs kernels off: rel L2 {err_switch:.3e}')
    ref_model = HourglassNet(dtype=torch.float32, **model_kw)
    ref_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        hm_ref = build(ref_model, None, device='cpu')(frames[:2])
    err_ref = rel_l2(hm_k[:2].cpu(), hm_ref)
    check(err_ref <= TOL_F32_REFERENCE, f'card bf16 vs CPU f32 rel L2 {err_ref:.3e}')
    kps_k, _ = fn(frames[:2])
    kps_ref, _ = build(ref_model, 'quarter', device='cpu')(frames[:2])
    agree = float((kps_k.cpu() - kps_ref).abs().amax(-1).le(4.0).float().mean())
    print(f'heatmaps: kernels vs kernels off rel L2 {err_switch:.3e} (tol {TOL_SWITCHES}); '
          f'card bf16 vs CPU f32 rel L2 {err_ref:.3e} (tol {TOL_F32_REFERENCE}); '
          f'keypoints within 4 px of the f32 path: {agree:.3f}', flush=True)
    del hm_off, off_fn

    # 7. latency and throughput of the inference function (synchronized)
    def one(x):
        out = fn(x)
        torch.cuda.synchronize()
        return out

    lat = {}
    for b in (BATCH, 1):
        xs = frames[:b]
        for _ in range(3):
            one(xs)
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            one(xs)
            ts.append(time.perf_counter() - t0)
        lat[b] = sorted(ts)[len(ts) // 2] * 1e3
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    perf = dict(card=card, batch=BATCH, fn_batch_ms_p50=lat[BATCH],
                fn_images_per_s=BATCH / lat[BATCH] * 1e3, fn_batch1_ms_p50=lat[1],
                served_images_per_s=N_REQUESTS / serve_s,
                served_batch_ms_p50=stats['batch_latency_ms_p50'],
                served_batch_ms_p95=stats['batch_latency_ms_p95'],
                served_batches=nb)
    print('serving: ' + json.dumps(perf), flush=True)

    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        one(x64)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one(x64)
            wall = (time.perf_counter() - t0) * 1e3
        # device kernels only (an aten op's device time repeats its kernels')
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
        busy = sum(e.device_time_total for e in ev) / 1e3
        ev.sort(key=lambda e: -e.device_time_total)
        print(f'profile: wall {wall:.2f} ms, device busy {busy:.2f} ms '
              f'(idle share {max(0.0, 1 - busy / wall):.3f})', flush=True)
        for e in ev[:14]:
            print(f'  {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x {e.key[:90]}', flush=True)
        # the front end alone: the same load against a function that
        # returns fixed keypoints at once
        kp0, mv0 = (t.cpu() for t in fn(x64[:1]))
        _, s0, st0, b0 = serve_load(
            lambda b: (kp0.expand(len(b), -1, -1), mv0.expand(len(b), -1)), args.seed)
        print(f'front end alone: {N_REQUESTS / s0:.1f} img/s, '
              f'{b0.n_frames / b0.n_batches:.1f} frames per batch', flush=True)

    for r, name in zip(rows, [w.__name__ for w in KERNEL_WRAPPERS]):
        r['launches'] = launches[name]
        check(r['launches'] > 0, f'{name} not launched on the main path')
    print(json.dumps({'kernels': rows}), flush=True)
    print(f'total {time.time() - t_start:.1f} s', flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
