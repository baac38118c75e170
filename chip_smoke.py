#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failed check exits non-zero; no phase catches its own
failure):
  1. the card's name and power limit (nvidia-smi), and a probe of what the
     host data layer could decode images with here (cv2, libjpeg,
     jpeglib.h; it informs and fails nothing);
  2. build the Hopper kernels from `hourglass_pose_estimation_torch/
     csrc/*.cu`, one nvcc per source, all started together, into the
     package's ignored build directory;
  3. each kernel at its main path's shapes against its plain PyTorch
     version on the card, with the tolerance stated, and its device time
     (`cold_hot_ms`: a CUDA graph of 20 calls, cold with each call on its
     own inputs and outputs, hot on one set; the kernels line's `ms` is
     the cold one, the bottleneck's the hot one, as a forward reads an
     activation just written) beside its plain version
     (CUDA events around calls), its bound and, where one PyTorch call
     computes the same function, that call's device time: the fused
     bottleneck under both schedules (the cluster kernel, impl 'image',
     and the row-tile kernel, impl 'chunked', held bit-equal to each
     other; at 64^2, 32^2 and 16^2 each one's TFLOP/s and share of the
     bound, its row tile, cluster shape, shared memory and resident
     clusters; registers and spills from the build log; the times weighted
     by one forward's launches at each shape), upsample+add, peak decode
     (planted ties, one across two blocks' slabs, and NaN; also at batches
     1, 37, 48 and 60, where the launch takes clusters of 8, 7, 6 and 5
     blocks), and the training kernels (upsample backward at every decoder
     shape, the 2x2 max-pool forward and both its backward modes, ties
     split and first maximum, at the stem and hourglass shapes with
     planted ties, the first-maximum one also against PyTorch's pool
     backward, the Gaussian target render with joints on the edges, off
     the map and at weight 0, equal at sigma 1);
  4. the serving path: the flagship 8-stack hourglass of
     configs/train_mpii_8stack.yaml with seeded weights, built by
     serve_http.build_inference into a frames -> keypoints function
     (MODEL.fuse_block at its default, on: fused bottleneck, fused
     upsample+add, the pool kernel, peak decode) behind MicroBatcher
     (batch 64) and the HTTP server on 127.0.0.1, answering 256 POSTed
     uint8 256x256 frames from 4 client processes of 16 connections each;
     every reply is checked; launch counts 65 bottleneck (DEFAULT_IMPL),
     32 upsample, 33 pool and 1 decode launch per batch;
  5. the serving heatmaps of the kernel path against the same weights
     with the kernels switched off (card, bf16), and against an f32 run
     of the plain path on the CPU for two frames; latency and throughput;
  6. the flagship train step (bench.py's build): Synthetic(64 samples,
     256^2 -> 64^2, sigma 1, scale 0.25, rotation 30), the 8-stack model
     in bf16 with f32 parameters and BN, RMSprop(2.5e-3, [35, 45], 0.1,
     100), make_train_step(device_pipeline=True) on one fixed batch of 64
     canvases: one step against the same step with the kernels off (loss
     and every gradient; a second kernels-off step reads the gradients'
     run-to-run noise), 3 warm-up and 10 timed steps (loss of every
     step, step ms p50, img/s, peak memory), 32 + 32 upsample, 33 + 33
     pool (the backward's first-maximum mode) and 1 render launch per
     step;
  7. the eval step on the same batch under each bottleneck schedule (65
     launches of that schedule's kernel, 32 upsample, 33 pool, 1 render;
     the two schedules' losses and heatmaps equal), its loss against the
     kernels off;
  8. the frozen-BN train step with the fused bottleneck, 2 steps against
     the same 2 steps with the kernels off (loss of each step), 65
     bottleneck launches and 65 backward calls of its autograd Function
     per step, gradients reaching a fused block's BN and conv parameters;
  9. the trainer entry point: `train_and_evaluate.main()` on the flagship
     config with synthetic data, 3 epochs of 4 steps at batch 32, BN
     frozen from epoch 3, a snapshot every epoch; each epoch's launches
     checked exactly, every value finite, the loss falling, checkpoint_1..3
     and best written; then `main()` resumed from checkpoint_2 restores
     every tensor exactly, step 8 and its learning rate, and runs only
     epoch 3;
 10. the standalone evaluator: `train_and_evaluate.main()` with
     COMMON.evaluate_only and EVAL.official on checkpoint_3: per val
     batch 65/32/33 launches and 1 render in `evaluate`, 130/64/66 and 1
     decode in the flip-test `predict_keypoints`; (loss, PCK) equal to the
     trainer's epoch-3 validation of the same weights; a finite OKS
     table; the flip-test keypoints against the kernels off; EVAL.decode=
     dark, its decode on the card with TF32 on against the CPU on the same
     heatmaps; each call's wall time;
 11. the Estimator on checkpoint_3 with the device preprocess:
     `run_batch` of 64 uint8 480x640 frames (65/32/33 launches and 1
     decode) against the kernels off, `run` batch-1 latency (p50 of 20),
     `run_skeleton`;
 12. MSPN at full width (configs/train_mpii_8stack.yaml with
     MODEL.arch=mspn MODEL.num_stacks=2: 56,848,576 parameters, 256^2 ->
     64^2, bf16 compute): the train step at batch 64 (3 warm-up and 10
     timed steps, the loss of every step finite and the last below the
     first, step p50, img/s, peak memory, 1 render launch a step and no
     other), the eval step (1 render);
 13. MSPN serving: serve_http.build_inference (fold_bn, bf16 weights, batch
     64, MODEL.fuse_block at the arch's default, off) behind the batcher
     and the HTTP server answering 128 frames, 1 decode a batch; folded vs
     unfolded heatmaps and the card's bf16 vs the CPU's f32 for two
     frames; batch-64 and batch-1 latency;
 14. the trainer CLI with MODEL.arch=mspn: 2 epochs of 3 steps at batch
     32, a snapshot each epoch, 1 render a step and a val batch; the
     evaluator CLI (COMMON.evaluate_only, flip test, EVAL.official) on its
     checkpoint_2: 1 render a batch in `evaluate`, 1 decode in the
     flip-test `predict_keypoints`, (loss, PCK) equal to the trainer's;
     the Estimator on it (1 decode a `run_batch`); the interop CLI's export
     to a reference-named .pth.tar and import back, whose served heatmaps
     equal the checkpoint's bit for bit;
 15. the `kernels` JSON line (launches summed over the main paths of
     phases 4, 6-11 and 12-14; the pool backward that splits ties is on
     none of them), then the result line.
--profile adds torch.profiler breakdowns (by kernel, by launching
PyTorch op, by kind) of one serving batch and of one train step, each for
the hourglass and for MSPN, and the serving front end's rate alone.
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
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
# device times: a CUDA graph of GRAPH_CALLS calls, the median of
# GRAPH_REPLAYS replays
GRAPH_CALLS, GRAPH_REPLAYS = 20, 5
L2_BYTES = 50 * 2 ** 20
# the port's kernels in a profile, by their symbols' names
PORT_KERNEL_NAMES = ('upsample2x', 'maxpool2x2', 'render_gaussian', 'bottleneck', 'decode_peaks')
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
# fused bottleneck launches of one flagship forward at each image side (the
# eligible blocks: layer3 and per stack up1_l4 and res at 64^2, low1_l4,
# up1_l3 and low3_l4 at 32^2, low1_l3, up1_l2 and low3_l3 at 16^2)
BOTTLENECK_LAUNCHES_PER_FORWARD = {64: 17, 32: 24, 16: 24}
# kernel path vs the path with the kernels off (both bf16 on the card):
# the unfused blocks round each conv output to bf16 where the kernel
# keeps f32, so the two differ by bf16 noise through 8 stacks (read at
# 7.6e-3 on an H100)
TOL_SWITCHES = 3e-2
# bf16 card path vs the f32 plain path on the CPU, two frames (read at
# 7.3e-3 on an H100). Keypoints are not compared: random weights give
# flat, near-tied heatmaps whose argmax flips under bf16 noise.
TOL_F32_REFERENCE = 3e-2
# the training kernels are held exactly to their plain versions (the same
# f32 arithmetic in the same order, rounded once), except the render: the
# card's expf against PyTorch's exp, within 1 ulp of f32
RENDER_MAX_ULP = 1
# the flagship train step
TRAIN_BATCH = 64
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
DS_KW = dict(num_samples=64, inp_res=RES, out_res=RES // 4, sigma=1,
             scale_factor=0.25, rot_factor=30)
OPT = (2.5e-3, [35, 45], 0.1, 100)
# one train step with the kernels vs without them (same weights, same
# draws, TF32 off): the loss, relative, and the gradients, relative L2 of
# all of them together (the worst single parameter is printed: a conv
# bias before a train-mode BN has a gradient of rounding noise only). In
# train mode the kernels' forwards equal the plain path's bit for bit, and
# since the model's pools give a tie's gradient to the first maximum, as
# F.max_pool2d and the JAX model's nn.max_pool do, so do the backwards: on
# an H100 the loss and the gradients read 0 (with the split of ties, the
# gradients read 4.2e-2), and kernels off vs off reads 0. Held equal.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 0.0
# the eval step (running-average BN, the fused bottleneck) with the
# kernels vs without them, the loss, relative: read 5.0e-4 on an H100
TOL_EVAL_LOSS = 2e-3
# the frozen-BN steps with the fused bottleneck vs the kernels off, each
# from one state: the loss of steps 1 and 2, relative (read 1.7e-3 and
# 1.6e-3 on an H100), and the step-1 gradients, relative L2 (read 4.0e-3),
# each twice alike. They run at the flagship schedule's rate past both
# decays (2.5e-5), where the trainer freezes BN late in training.
TOL_FROZEN_LOSS = (7e-3, 7e-3)
TOL_FROZEN_GRAD = 1.6e-2
# the trainer phase: the CLI on the flagship config, synthetic data, three
# epochs of four steps, BN frozen from epoch 3 on, a snapshot every epoch,
# at the flagship schedule's rate past both decays (2.5e-5), where a run
# freezes BN late in training. At its base rate (2.5e-3) RMSprop's first
# update moves every weight by lr * 10 = 0.025 and running averages of 8
# steps cannot follow: on an H100 the first validation's loss read inf and
# the frozen epoch's 6e17 (both packages compute the same math).
FREEZE_BN_AFTER = 2
# the evaluator phase: its (loss, PCK) of checkpoint_3 against the trainer
# phase's epoch-3 validation of the same weights, relative (the same eval
# step on the same batches)
TOL_EVALUATOR = 1e-6
# the evaluator and the estimator, kernels on vs off (`switch_agreement`):
# random weights give flat heatmaps with near-ties, and the bf16 noise
# between the two paths (the fused bottleneck keeps f32 where the plain
# blocks round to bf16) moves the argmax of many joints anywhere on the map
# (on an H100 375 of 2048 joints in the evaluator, 246 of 1024 in the
# estimator; 77% and 72% within 0.5 px), so the keypoints are held to
# each other only where the argmax stayed, and a moved argmax is held to a
# near-tie: each path's map at the other's argmax lies within TOL_NEAR_TIE
# of its max, as a share of the map's range (read at most 6.9% in the
# evaluator and 6.3% in the estimator on an H100, held at 4x the larger).
# The heatmaps of checkpoint_3, relative L2: read 3.03e-2 in the evaluator
# in two runs (the path is deterministic; its maps lie near 0, as the
# targets mostly do, so the same bf16 noise is larger against them than
# serving's 7.6e-3), held at 4x that. DARK on
# the card (TF32 on) vs the CPU on the same heatmaps: the same f32 ops in
# the same order, the log taken in f64 on both: every joint within
# TOL_DARK_PX
TOL_PATH_SWITCHES = 0.12
TOL_NEAR_TIE = 0.28
TOL_DARK_PX = 1e-3
# the estimator phase: a batch of camera-sized frames, and batch-1 calls
ESTIMATOR_FRAMES, ESTIMATOR_FRAME, ESTIMATOR_RUNS = 64, (480, 640), 20
# the MSPN phases: the full-width MSPN (2 stages, 16 joints, decoder
# width 256) of the flagship config with MODEL.arch=mspn
MSPN_STACKS, MSPN_PARAMS = 2, 56_848_576
MSPN_OVERRIDES = ['MODEL.arch=mspn', f'MODEL.num_stacks={MSPN_STACKS}']
# batch 64, the flagship's: at 32 the step peaked at 15.28 GiB on an H100
MSPN_TRAIN_BATCH = 64
MSPN_REQUESTS = 128
MSPN_STEPS = 3
MSPN_TRAINER = ['DATASET.name=synthetic', 'DATASET.num_samples=128', 'TRAIN.epochs=2',
                f'TRAIN.steps_per_epoch={MSPN_STEPS}', 'COMMON.snapshot=1',
                'TRAIN.learning_rate=2.5e-5']
# MSPN serving heatmaps, relative L2: folded BN against unfolded (both bf16
# weights on the card), and the card's bf16 against the f32 forward on the
# CPU for two frames
TOL_MSPN_FOLD = 3e-2
TOL_MSPN_F32_REFERENCE = 5e-2
TRAINER_OVERRIDES = ['DATASET.name=synthetic', 'DATASET.num_samples=128',
                     'TRAIN.epochs=3', 'TRAIN.steps_per_epoch=4',
                     f'TRAIN.freeze_bn_after_epoch={FREEZE_BN_AFTER}', 'COMMON.snapshot=1',
                     'TRAIN.learning_rate=2.5e-5']


def fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def rel_l2(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
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


def graph_ms(calls, hold: bool, replays: int = GRAPH_REPLAYS):
    """Device time of one call: the zero-argument functions `calls`
    captured in order in one CUDA graph and replayed, so that a wrapper's
    host time (its checks and ctypes call, tens of microseconds) does not
    stretch a short kernel; the median of `replays` replays over
    len(calls). hold: keep every call's output alive during the capture,
    so that each call writes its own buffer (else the allocator hands the
    next call the memory just freed). -> (ms, distinct output buffers)."""
    import statistics
    import torch
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    held, ptrs = [], set()
    with torch.cuda.graph(graph):
        for fn in calls:
            out = fn()
            first = out[0] if isinstance(out, (tuple, list)) else out
            ptrs.add(first.data_ptr())
            if hold:
                held.append(out)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph, held
    return statistics.median(times), len(ptrs)


def same_nan_and_bits(a, b) -> bool:
    """Equal, NaN where the other has NaN."""
    import torch
    return bool(torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(nan=0.0), b.nan_to_num(nan=0.0)))


def tensor_bytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(map(tensor_bytes, x)) if isinstance(x, (tuple, list)) else 0


def cold_hot_ms(fn, inputs, calls: int = GRAPH_CALLS) -> dict:
    """Device times of fn(*inputs): `cold`, a graph of at least `calls`
    calls, each on its own copy of the inputs and its own output buffer,
    and as many more as it takes for the calls' bytes to reach 4x the
    50 MB L2 (20 calls at the main path's shapes, 16.8 MB and up a call;
    763 at [1,64,64,16]), so that each call reads and writes device memory
    as the bound assumes; `hot`, `calls` calls on one set of inputs, as
    the serving decode finds a map that the cast before it has just
    written."""
    import torch
    call_bytes = tensor_bytes(inputs) + tensor_bytes(fn(*inputs))
    n = max(calls, -(-4 * L2_BYTES // call_bytes))
    copies = [inputs] + [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in inputs)
                         for _ in range(n - 1)]
    cold, n_cold = graph_ms([lambda a=a: fn(*a) for a in copies], hold=True)
    del copies
    hot, n_hot = graph_ms([lambda: fn(*inputs)] * calls, hold=False)
    torch.cuda.empty_cache()
    check(n_cold == n, f'cold timing: {n_cold} output buffers for {n} calls')
    return dict(cold=cold, hot=hot, cold_calls=n, hot_buffers=n_hot)


def ptxas_usage(log: str, source: str) -> dict:
    """{kernel symbol: registers, spill stores and loads in bytes} of one
    source's section of the build log (`nvcc -Xptxas -v`)."""
    import re
    out, name, inside = {}, None, False
    for ln in log.splitlines():
        if ln.startswith('== '):
            inside = ln[3:].strip() == source
            continue
        if not inside:
            continue
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', ln)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers', ln)
        if m and name:
            out[name]['registers'] = int(m.group(1))
    return out


def bound_ms(flops: float, bytes_: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops > t_bytes else 'bytes')


def max_abs_err(got, ref) -> float:
    """Largest |got - ref| where not both are NaN (a NaN in one only counts
    as inf)."""
    got, ref = got.detach().float(), ref.detach().float()
    both = got.isnan() & ref.isnan()
    d = (got - ref).abs().nan_to_num(nan=float('inf'))[~both]
    return float(d.max()) if d.numel() else 0.0


def kernel_row(name, source, replaces, got, ref, ms: dict, plain_ms, bound,
               library_ms: dict = None, timing: str = 'cold', **extra) -> dict:
    """One kernel's entry of the `kernels` line: ms and library_ms are
    cold_hot_ms's times; 'ms', 'library_ms' and 'bound_share' take the
    `timing` one, the other stands beside them ('ms_hot' or 'ms_cold')."""
    b_ms, b_by = bound
    other = 'hot' if timing == 'cold' else 'cold'
    return dict(name=name, route='cuda',
                source=f'hourglass_pose_estimation_torch/csrc/{source}',
                replaces=f'hourglass_pose_estimation_tpu/ops/pallas/{replaces}',
                launches=0, max_abs_err=max_abs_err(got, ref),
                ms=ms[timing], **{f'ms_{other}': ms[other]}, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms[timing],
                library_ms=library_ms[timing] if library_ms else None,
                **{f'library_ms_{other}': library_ms[other] if library_ms else None}, **extra)


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


def bottleneck_impls() -> dict:
    from hourglass_pose_estimation_torch.ops.hopper import (
        fused_bottleneck_chunked, fused_bottleneck_image)
    return {'image': fused_bottleneck_image, 'chunked': fused_bottleneck_chunked}


def kernel_phases(seed: int):
    """Each kernel vs its plain version at the serving path's shapes."""
    BOTTLENECK_IMPLS = bottleneck_impls()
    import torch
    from hourglass_pose_estimation_torch.models.modules import Bottleneck
    from hourglass_pose_estimation_torch.ops.hopper import (
        _build, bottleneck_reference, decode_peaks, decode_peaks_reference,
        upsample2x_add, upsample2x_add_reference)
    from hourglass_pose_estimation_torch.ops.hopper import bottleneck as bk

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    rows = []

    # --- fused bottleneck, both schedules: 64 images at 64^2, 32^2, 16^2,
    # C=256, P=128; each against the plain version and against each other;
    # each kernel's device time (a CUDA graph of 20 calls), TFLOP/s and
    # share of the bound at each shape, its tile choice, shared memory,
    # registers and spills. Every time of its row is the hot one, as in a
    # forward, where a block reads the activation the layer before it has
    # just written (`ms_cold` beside it)
    blk = Bottleneck(256, 128, fuse_block=True)
    randomize_bn_(blk, gen)
    prm = blk.to(dev).fused_params()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.library()
    usage = {impl: next(v for k, v in ptxas_usage(lib.build_log, 'bottleneck.cu').items()
                        if kname in k)
             for impl, kname in (('image', 'bottleneck_image_kernel'),
                                 ('chunked', 'bottleneck_fwd_kernel'))}
    print(f'bottleneck build (ptxas): {json.dumps(usage)}', flush=True)
    per_shape, at64 = {}, {}
    for hw in (64, 32, 16):
        x = torch.randn(BATCH, hw, hw, 256, generator=gen).to(dev, torch.bfloat16)
        ref = bottleneck_reference(x, prm)
        outs = {impl: fn(x, prm) for impl, fn in BOTTLENECK_IMPLS.items()}
        torch.cuda.synchronize()
        tr, r = bk.image_schedule(BATCH, hw, hw, sms)
        ctr = bk.rows_per_block(BATCH, hw, hw, sms)
        npix = BATCH * hw * hw
        flops = 2.0 * npix * (256 * 128 * 2 + 9 * 128 * 128)
        nbytes = 2.0 * npix * 256 * 2 + 2 * (256 * 128 * 2 + 9 * 128 * 128) + 4 * (3 * 256 + 6 * 128)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16)
        entry = dict(hw=hw, bound_ms=b_ms, bound_by=b_by,
                     image_TR=tr, image_R=r,
                     image_smem_bytes=lib.hpe_bottleneck_smem_bytes(hw, tr),
                     image_max_active_clusters=bk.max_active_clusters(hw, tr, r, dev.index or 0),
                     chunked_TR=ctr, chunked_blocks=BATCH * -(-hw // ctr),
                     chunked_smem_bytes=lib.hpe_bottleneck_smem_bytes(hw, ctr),
                     image_equals_chunked=bool(torch.equal(outs['image'], outs['chunked'])))
        for impl, got in outs.items():
            err = rel_l2(got, ref)
            branch = rel_l2(got.float() - x.float(), ref.float() - x.float())
            check(bool(torch.isfinite(got.float()).all()), f'bottleneck {impl} {hw}^2 not finite')
            check(err <= TOL_BOTTLENECK, f'bottleneck {impl} {hw}^2 rel L2 {err:.3e} > {TOL_BOTTLENECK}')
            check(branch <= TOL_BOTTLENECK,
                  f'bottleneck {impl} {hw}^2 branch rel L2 {branch:.3e} > {TOL_BOTTLENECK}')
            fn = BOTTLENECK_IMPLS[impl]
            t = cold_hot_ms(fn, (x, prm))
            ms = t['hot']
            entry.update({f'{impl}_rel_l2': err, f'{impl}_rel_l2_branch': branch,
                          f'{impl}_max_abs_err': float((got.float() - ref.float()).abs().max()),
                          f'{impl}_ms': ms, f'{impl}_ms_cold': t['cold'],
                          f'{impl}_tflops': flops / ms / 1e9,
                          f'{impl}_bound_share': b_ms / ms,
                          f'{impl}_wrapper_ms': time_ms(lambda: fn(x, prm), 20)})
        entry['plain_ms'] = time_ms(lambda: bottleneck_reference(x, prm), 5)
        per_shape[hw] = entry
        print(f'bottleneck {hw}x{hw}: ' + json.dumps(entry), flush=True)
        check(entry['image_equals_chunked'],
              f'bottleneck {hw}^2: the image and chunked kernels differ')
        if hw == 64:
            at64 = dict(outs, ref=ref)
        del x, ref, outs
    # the schedule one forward of the flagship should default to: each
    # shape's time weighted by its launches in one forward
    per_forward = {impl: sum(n * per_shape[hw][f'{impl}_ms']
                             for hw, n in BOTTLENECK_LAUNCHES_PER_FORWARD.items())
                   for impl in BOTTLENECK_IMPLS}
    print(f'bottleneck per forward (launches {BOTTLENECK_LAUNCHES_PER_FORWARD}): '
          + ', '.join(f'{impl} {ms:.3f} ms' for impl, ms in per_forward.items())
          + f'; faster: {min(per_forward, key=per_forward.get)}; '
          f'DEFAULT_IMPL {bk.DEFAULT_IMPL!r}', flush=True)
    s = per_shape[64]
    for impl, replaces in (('image', 'bottleneck.py:259'), ('chunked', 'bottleneck.py:207')):
        rows.append(kernel_row(
            f'fused_bottleneck_{impl}', 'bottleneck.cu', replaces, at64[impl], at64['ref'],
            dict(cold=s[f'{impl}_ms_cold'], hot=s[f'{impl}_ms']), s['plain_ms'],
            (s['bound_ms'], s['bound_by']), None, timing='hot',
            shape='[64,64,64,256] bf16', rel_l2=s[f'{impl}_rel_l2'],
            ms_by_hw={hw: e[f'{impl}_ms'] for hw, e in per_shape.items()},
            ms_cold_by_hw={hw: e[f'{impl}_ms_cold'] for hw, e in per_shape.items()},
            tflops_by_hw={hw: e[f'{impl}_tflops'] for hw, e in per_shape.items()},
            bound_ms_by_hw={hw: e['bound_ms'] for hw, e in per_shape.items()},
            per_forward_ms=per_forward[impl], ptxas=usage[impl],
            library='none: no one PyTorch call computes the whole block'))
    del at64

    # --- upsample + add: low [64,32,32,256] -> [64,64,64,256], plus H=12
    for (b, h, c) in ((2, 12, 256), (BATCH, 32, 256)):
        low = torch.randn(b, h, h, c, generator=gen).to(dev, torch.bfloat16)
        skip = torch.randn(b, 2 * h, 2 * h, c, generator=gen).to(dev, torch.bfloat16)
        got = upsample2x_add(low, skip)
        ref = upsample2x_add_reference(low, skip)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f'upsample h={h} differs from its plain version')
    nbytes = 2.0 * (low.numel() + 2 * skip.numel())
    rows.append(kernel_row(
        'upsample2x_add', 'upsample.cu', 'upsample.py:87', got, ref,
        cold_hot_ms(upsample2x_add, (low, skip)),
        time_ms(lambda: upsample2x_add_reference(low, skip), 20),
        bound_ms(skip.numel(), nbytes, PEAK_F32), None,
        shape='low [64,32,32,256] bf16',
        library='none: no one PyTorch call upsamples and adds'))
    del low, skip, got, ref

    # --- peak decode: [64,64,64,16] f32 with planted ties (one across two
    # blocks' slabs), edges, a flat map and NaN (a NaN among numbers, two
    # NaNs side by side, an all-NaN joint); timed there and at
    # [1,64,64,16], the batch-1 serving path
    from hourglass_pose_estimation_torch.ops.hopper.decode import decode_schedule
    K, slab_rows, _, _ = decode_schedule(BATCH, 64, 64, 16)
    nan = float('nan')
    hm = torch.rand(BATCH, 64, 64, 16, generator=gen)
    hm[0, 10, 10, 0] = hm[0, 12, 3, 0] = 5.0
    hm[4, slab_rows - 1, 9, 5] = hm[4, slab_rows, 2, 5] = 5.0   # tie across slabs 0 and 1
    hm[1, 0, 5, 1] = 5.0
    hm[2, 30, 30, 2] = 5.0
    hm[2, 30, 31, 2] = hm[2, 30, 29, 2] = 0.5
    hm[3, :, :, 3] = 0.0
    hm[5, 40, 17, 6] = nan
    hm[6, 20, 20, 8] = hm[6, 20, 21, 8] = nan
    hm[7, :, :, 9] = nan
    hm = hm.to(dev)
    (gc, gm), (rc, rm) = decode_peaks(hm), decode_peaks_reference(hm)
    torch.cuda.synchronize()
    check(same_nan_and_bits(gc, rc) and same_nan_and_bits(gm, rm),
          'decode differs from its plain version')
    check(gc[0, 0, 1].item() in (9.75, 10.0, 10.25), 'decode tie not first row-major')
    check(gc[4, 5, 1].item() in (slab_rows - 1.25, slab_rows - 1.0, slab_rows - 0.75),
          'decode tie across slabs not first row-major')
    check(bool(gm[5, 6].isnan() and gm[6, 8].isnan() and gc[6, 8, 0].isnan()
               and gm[7, 9].isnan() and gc[7, 9].tolist() == [0.0, 0.0]),
          'decode: NaN not ranked first')
    # the launch follows the batch: every cluster size a serving batch
    # reaches (8 blocks an image at batch 1, 7, 6 and 5 at the partial
    # batches 37, 48 and 60), each held exactly on a tie across its first
    # two slabs and NaN before it is timed; batch 1's maps are timed below
    checked = {}
    for b in (1, 37, 48, 60):
        k, slab, _, _ = decode_schedule(b, 64, 64, 16)
        m = torch.rand(b, 64, 64, 16, generator=gen)
        m[-1, slab - 1, 9, 5] = m[-1, slab, 2, 5] = 5.0
        m[-1, 40, 17, 6] = nan
        m[0, 20, 20, 8] = m[0, 20, 21, 8] = nan
        m = m.to(dev)
        (bc, bm), (rc1, rm1) = decode_peaks(m), decode_peaks_reference(m)
        torch.cuda.synchronize()
        check(same_nan_and_bits(bc, rc1) and same_nan_and_bits(bm, rm1),
              f'decode at batch {b} (clusters of {k}) differs from its plain version')
        check(bc[-1, 5, 1].item() in (slab - 1.25, slab - 1.0, slab - 0.75),
              f'decode at batch {b}: tie across slabs not first row-major')
        check(bool(bm[-1, 6].isnan() and bc[0, 8, 0].isnan()),
              f'decode at batch {b}: NaN not ranked first')
        checked[b] = k
        if b == 1:
            one = m
    del m, bc, bm, rc1, rm1
    times, times1 = cold_hot_ms(decode_peaks, (hm,)), cold_hot_ms(decode_peaks, (one,))
    nbytes = 4.0 * (hm.numel() + gc.numel() + gm.numel())
    rows.append(kernel_row(
        'decode_peaks', 'decode.cu', 'decode.py:61', torch.cat([gc.flatten(), gm.flatten()]),
        torch.cat([rc.flatten(), rm.flatten()]), times,
        time_ms(lambda: decode_peaks_reference(hm), 20),
        bound_ms(hm.numel(), nbytes, PEAK_F32), None, shape='[64,64,64,16] f32',
        schedule=dict(K=K, rows=slab_rows), exact_at_batch_K=checked,
        b1=dict(shape='[1,64,64,16] f32', ms=times1['cold'], ms_hot=times1['hot'],
                bound_ms=bound_ms(one.numel(), 4.0 * (one.numel() + 48), PEAK_F32)[0]),
        library='none: no one PyTorch call takes the argmax with its offsets'))
    print('decode: ' + json.dumps(rows[-1]), flush=True)
    return rows


def plant_ties_(x) -> None:
    """2-, 3- and 4-way ties of a 2x2 window's max, in one lane and across
    whole 16-byte vectors of channels."""
    import torch
    x[0, 0:2, 0:2, 0] = 3.0
    x[0, 2:4, 2:4, 1] = torch.tensor([[2.0, 2.0], [2.0, -1.0]])
    x[1 % x.shape[0], 0:2, 2:4, 2] = torch.tensor([[1.5, -4.0], [1.5, 0.0]])
    x[0, 4:6, 4:6, :] = 1.0
    x[0, 6:8, 0:2, :16] = torch.tensor([[0.5, 0.5], [0.25, 0.5]])[..., None]


def training_kernel_phases(seed: int):
    """The training kernels vs their plain versions, at the train step's
    shapes: exact, except the render (within RENDER_MAX_ULP)."""
    import torch
    import torch.nn.functional as F
    from hourglass_pose_estimation_torch.ops.heatmap import render_preamble
    from hourglass_pose_estimation_torch.ops.hopper import (
        maxpool2x2_bwd, maxpool2x2_bwd_first, maxpool2x2_bwd_first_reference,
        maxpool2x2_bwd_reference, maxpool2x2_fwd, maxpool2x2_reference, render_gaussian,
        render_gaussian_reference, upsample2x_add_bwd, upsample2x_add_bwd_reference)

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(seed + 7)
    bf16 = torch.bfloat16
    rows = []

    # --- upsample backward: g [64, {64,32,16,8}^2, 256] bf16 (every decoder
    # merge of the flagship), and an H=12 d_low
    times = {}
    for b, hw in ((2, 24), (BATCH, 8), (BATCH, 16), (BATCH, 32), (BATCH, 64)):
        g = torch.randn(b, hw, hw, 256, generator=gen).to(dev, bf16)
        got, ref = upsample2x_add_bwd(g), upsample2x_add_bwd_reference(g)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f'upsample bwd g {tuple(g.shape)} differs from its plain version')
        if b == BATCH:
            times[hw] = cold_hot_ms(upsample2x_add_bwd, (g,))
    B, H2, W2, C = g.shape
    lib = lambda g: g.view(B, H2 // 2, 2, W2 // 2, 2, C).sum(dim=(2, 4))
    nbytes = 2.0 * (g.numel() + got.numel())
    rows.append(kernel_row(
        'upsample2x_add_bwd', 'upsample.cu', 'upsample.py:44', got, ref, times[64],
        time_ms(lambda: upsample2x_add_bwd_reference(g), 20),
        bound_ms(3.0 * got.numel(), nbytes, PEAK_F32), cold_hot_ms(lib, (g,)),
        shape='g [64,64,64,256] bf16', ms_by_hw={hw: v['cold'] for hw, v in times.items()},
        ms_hot_by_hw={hw: v['hot'] for hw, v in times.items()},
        library='torch.sum over the [B,H,2,W,2,C] view'))
    print('upsample bwd: ' + json.dumps(rows[-1]), flush=True)
    del g, got, ref

    # --- 2x2 max-pool, forward and both backward modes: the stem
    # [64,128,128,128] and the hourglass [64,{64,32,16,8}^2,256], with
    # planted ties, and H=12 and H=24 inputs (6 and 12 pooled rows). The
    # first-maximum backward (the model's) is also held to PyTorch's pool
    # backward, given the forward's indices
    fwd_t, bwd_t, first_t = {}, {}, {}
    shapes = ((2, 12, 256), (2, 24, 256), (BATCH, 8, 256), (BATCH, 16, 256),
              (BATCH, 32, 256), (BATCH, 128, 128), (BATCH, 64, 256))
    pool_bwd_lib = lambda gn, xn, ind: torch.ops.aten.max_pool2d_with_indices_backward(
        gn, xn, [2, 2], [2, 2], [0, 0], [1, 1], False, ind)
    for b, hw, c in shapes:
        x = torch.randn(b, hw, hw, c, generator=gen)
        plant_ties_(x)
        x = x.to(dev, bf16)
        g = torch.randn(b, hw // 2, hw // 2, c, generator=gen).to(dev, bf16)
        out, ref = maxpool2x2_fwd(x), maxpool2x2_reference(x)
        dx, dref = maxpool2x2_bwd(x, g), maxpool2x2_bwd_reference(x, g)
        dxf, dfref = maxpool2x2_bwd_first(x, g), maxpool2x2_bwd_first_reference(x, g)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        lib_out, ind = F.max_pool2d(xn, 2, 2, return_indices=True)
        lib_dx = pool_bwd_lib(gn, xn, ind).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        check(torch.equal(out, ref) and torch.equal(out, lib_out.permute(0, 2, 3, 1)),
              f'pool fwd {tuple(x.shape)} differs from its plain version')
        check(torch.equal(dx, dref), f'pool bwd {tuple(x.shape)} differs from its plain version')
        check(torch.equal(dxf, dfref) and torch.equal(dxf, lib_dx),
              f"pool bwd (first maximum) {tuple(x.shape)} differs from its plain version "
              "or from PyTorch's pool backward")
        if b == BATCH:
            fwd_t[hw] = cold_hot_ms(maxpool2x2_fwd, (x,))
            bwd_t[hw] = cold_hot_ms(maxpool2x2_bwd, (x, g))
            first_t[hw] = cold_hot_ms(maxpool2x2_bwd_first, (x, g))
    # the 4-way tie of the last shape: split in quarters, or all of g to
    # the window's top-left element
    q = (g[0, 2, 2, :].float() / 4).to(bf16)
    check(torch.equal(dx[0, 4:6, 4:6, :], q.expand(2, 2, -1)), 'pool bwd: 4-way tie not split')
    check(torch.equal(dxf[0, 4, 4, :], g[0, 2, 2, :]) and not dxf[0, 4:6, 4:6, :].flatten(0, 1)[1:].any(),
          'pool bwd (first maximum): 4-way tie not at the first element')
    # what the tie convention changes on bf16 normal values: the share of
    # windows whose max is tied, and the split dx against the first-maximum
    # one (PyTorch's and the JAX model's)
    xw = x.view(BATCH, 32, 2, 32, 2, 256)
    tied = float(((xw == xw.amax(dim=(2, 4), keepdim=True)).sum(dim=(2, 4)) > 1)
                 .float().mean())
    route_gap = rel_l2(dxf, dx)
    del xw
    nbytes = 2.0 * (x.numel() + out.numel())
    rows.append(kernel_row(
        'maxpool2x2_fwd', 'pool.cu', 'pool.py:37', out, ref, fwd_t[64],
        time_ms(lambda: maxpool2x2_reference(x), 20),
        bound_ms(3.0 * out.numel(), nbytes, PEAK_F32),
        cold_hot_ms(lambda x: F.max_pool2d(x, 2, 2), (xn,)),
        shape='x [64,64,64,256] bf16', ms_by_hw={hw: v['cold'] for hw, v in fwd_t.items()},
        ms_hot_by_hw={hw: v['hot'] for hw, v in fwd_t.items()},
        library='F.max_pool2d(x, 2, 2), channels-last'))
    print('pool fwd: ' + json.dumps(rows[-1]), flush=True)
    nbytes = 2.0 * (2 * x.numel() + g.numel())
    rows.append(kernel_row(
        'maxpool2x2_bwd', 'pool.cu', 'pool.py:43', dx, dref, bwd_t[64],
        time_ms(lambda: maxpool2x2_bwd_reference(x, g), 20),
        bound_ms(8.0 * g.numel(), nbytes, PEAK_F32), None,
        shape='x [64,64,64,256] bf16', ms_by_hw={hw: v['cold'] for hw, v in bwd_t.items()},
        ms_hot_by_hw={hw: v['hot'] for hw, v in bwd_t.items()}, tied_windows=tied,
        dx_rel_l2_vs_first_max=route_gap, on_main_path=False,
        library="none: PyTorch's pool backward gives a tie's gradient to one "
                'element, this one splits it equally'))
    print('pool bwd: ' + json.dumps(rows[-1]), flush=True)
    rows.append(kernel_row(
        'maxpool2x2_bwd_first', 'pool.cu', 'pool.py:43', dxf, dfref, first_t[64],
        time_ms(lambda: maxpool2x2_bwd_first_reference(x, g), 20),
        bound_ms(8.0 * g.numel(), nbytes, PEAK_F32),
        cold_hot_ms(pool_bwd_lib, (gn, xn, ind)),
        shape='x [64,64,64,256] bf16', ms_by_hw={hw: v['cold'] for hw, v in first_t.items()},
        ms_hot_by_hw={hw: v['hot'] for hw, v in first_t.items()},
        library='aten.max_pool2d_with_indices_backward(g, x, indices of the forward), '
                'channels-last'))
    print('pool bwd (first maximum): ' + json.dumps(rows[-1]), flush=True)
    del x, g, out, ref, dx, dref, dxf, dfref, lib_out, lib_dx, ind, xn, gn

    # --- Gaussian target render: [64, 64, 64, 16] f32 from joints in
    # input pixels, some on the map's edges, some off it, some invisible
    R, J = RES, 16
    joints = torch.rand(BATCH, J, 2, generator=gen) * 1.4 * R - 0.2 * R
    joints[0, :4] = torch.tensor([[0.0, 0.0], [R - 1.0, R - 1.0], [-30.0, 5.0],
                                  [R + 20.0, 100.0]])
    vis = (torch.rand(BATCH, J, generator=gen) > 0.2).float()
    vis[1, :] = 0.0
    size = (R // 4, R // 4)
    mu, weight = render_preamble(joints.to(dev), vis.to(dev), size, (R, R), 1)
    got = render_gaussian(mu, weight, size, 1)
    ref = render_gaussian_reference(mu, weight, size, 1)
    torch.cuda.synchronize()
    check(bool((weight == 0).any() and (weight > 0).any()), 'render: no joint off the map')
    check(torch.equal(got > 0, ref > 0), 'render: windows differ from the plain version')
    ulps = int((got.view(torch.int32) - ref.view(torch.int32)).abs().max())
    check(ulps == 0, f'render at sigma 1: {ulps} ulp from the plain version, not equal')
    n_exp = int((got > 0).sum())
    nbytes = 4.0 * (got.numel() + mu.numel() + weight.numel())
    times = cold_hot_ms(lambda m, w: render_gaussian(m, w, size, 1), (mu, weight))
    rows.append(kernel_row(
        'render_gaussian', 'render.cu', 'render.py:21', got, ref, times,
        time_ms(lambda: render_gaussian_reference(mu, weight, size, 1), 20),
        # a select per element, and the square, sum, scale and exp of each
        # rendered one
        bound_ms(got.numel() + 4.0 * n_exp, nbytes, PEAK_F32), None,
        shape='[64,64,64,16] f32', max_ulp=ulps,
        library='none: no one PyTorch call renders windowed Gaussians'))
    print('render: ' + json.dumps(rows[-1]), flush=True)
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


def serve_load(fn, seed: int, n_requests: int = N_REQUESTS):
    """Serve `fn` behind MicroBatcher(BATCH) + the HTTP server and POST
    n_requests frames from the client processes -> (replies, seconds,
    batcher stats, batcher)."""
    import numpy as np
    from hourglass_pose_estimation_torch.serving import MicroBatcher, make_server
    batcher = MicroBatcher(fn, BATCH, (RES, RES, 3), dtype=np.uint8,
                           max_wait_ms=50.0, max_queue=4 * n_requests)
    srv = make_server(batcher, '127.0.0.1', 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f'http://127.0.0.1:{srv.server_address[1]}'
    per_proc = n_requests // CLIENT_PROCS
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
    """The port's kernels on or off in `model` (MODEL.fuse_block's two
    module switches: the fused bottleneck, and the upsample+add with the
    pools)."""
    from hourglass_pose_estimation_torch.models import (
        Bottleneck, Hourglass, HourglassNet)
    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.fuse_block = on
        elif isinstance(m, (Hourglass, HourglassNet)):
            m.fuse_upsample = on
    return model


def zero_counts() -> None:
    from hourglass_pose_estimation_torch.ops.hopper import KERNEL_WRAPPERS, fused_bottleneck
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    fused_bottleneck.backward_calls = 0


def read_counts() -> dict:
    from hourglass_pose_estimation_torch.ops.hopper import KERNEL_WRAPPERS
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def fused_name(impl: str = None) -> str:
    """The launch counter of the fused bottleneck's `impl` schedule
    (DEFAULT_IMPL, the one the model's blocks run, when None)."""
    from hourglass_pose_estimation_torch.ops.hopper import bottleneck as bk
    return f'fused_bottleneck_{impl or bk.DEFAULT_IMPL}'


def expect_counts(got: dict, what: str, **want) -> None:
    full = {name: want.get(name, 0) for name in got}
    check(got == full, f'{what}: launch counts {got} != {full}')


def grad_rel_l2(model_a, model_b):
    """(relative L2 of all gradients together, worst single parameter's
    relative L2 and its name) of model_a's gradients against model_b's."""
    import torch
    num = den = 0.0
    worst, worst_name = 0.0, ''
    for (name, a), b in zip(model_a.named_parameters(), model_b.parameters()):
        d = float((a.grad.float() - b.grad.float()).norm() ** 2)
        n = float(b.grad.float().norm() ** 2)
        num, den = num + d, den + n
        r = (d / max(n, 1e-30)) ** 0.5
        if r > worst:
            worst, worst_name = r, name
    return (num / max(den, 1e-30)) ** 0.5, worst, worst_name


def train_data(batch: int):
    """The flagship train step's data: bench.py's Synthetic and one fixed
    batch of canvases."""
    from hourglass_pose_estimation_torch.data import Synthetic, make_spec
    ds = Synthetic(True, **DS_KW)
    return ds.canvas_batch(range(batch), canvas=RES), make_spec(ds)


def flagship_model(seed: int, device='cuda'):
    """HourglassNet(8 stacks, 1 block, 16 joints, sum merges), bf16
    compute, f32 parameters and BN, seeded weights, the kernels on."""
    import torch
    from hourglass_pose_estimation_torch.models import get_model
    torch.manual_seed(seed)
    return get_model('hg', device=device, num_stacks=8, num_blocks=1,
                     num_classes=16, mobile=False, skip_mode='sum',
                     fuse_block=True, fuse_upsample=True)


def train_phase(seed: int, raw, spec, batch: int, paths: dict):
    """The flagship train step: kernels on vs off, then warm-up and timed
    steps on the fixed batch. -> (the trained state, numbers)."""
    import torch
    from hourglass_pose_estimation_torch.runner import (
        init_state, make_optimizer, make_train_step)
    tx = make_optimizer(*OPT)
    step = make_train_step(spec, device_pipeline=True)
    model = flagship_model(seed)
    state = init_state(model, tx)
    off = init_state(set_switches(copy.deepcopy(model), False), tx)
    off2 = init_state(set_switches(copy.deepcopy(model), False), tx)

    # one step from the same weights with the same draws, kernels on and
    # off; a second kernels-off step reads the run-to-run noise of the
    # gradients (cuDNN's backward accumulates in no fixed order)
    zero_counts()
    state, m_on = step(state, raw, seed)
    loss_on = float(m_on['loss'])
    first = read_counts()
    off, m_off = step(off, raw, seed)
    loss_off = float(m_off['loss'])
    off2, _ = step(off2, raw, seed)
    d_loss = abs(loss_on - loss_off) / abs(loss_off)
    g_all, g_leaf, g_name = grad_rel_l2(state.model, off.model)
    g_noise = grad_rel_l2(off2.model, off.model)[0]
    print(f'train: kernels on vs off: loss {loss_on:.6f} vs {loss_off:.6f} '
          f'(rel {d_loss:.3e}, tol {TOL_TRAIN_LOSS}); gradients rel L2 {g_all:.3e} '
          f'(tol {TOL_TRAIN_GRAD}), worst parameter {g_name} {g_leaf:.3e}; '
          f'kernels off vs off again: gradients rel L2 {g_noise:.3e}', flush=True)
    check(all(map(lambda v: v == v and abs(v) < float('inf'), (loss_on, loss_off))),
          'train: loss not finite')
    check(d_loss <= TOL_TRAIN_LOSS, f'train: loss kernels on vs off {d_loss:.3e}')
    check(g_all <= TOL_TRAIN_GRAD, f'train: gradients kernels on vs off {g_all:.3e}')
    del off, off2

    losses = [loss_on]
    for _ in range(TRAIN_WARMUP - 1):
        state, m = step(state, raw, seed)
        losses.append(float(m['loss']))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        state, m = step(state, raw, seed)
        losses.append(float(m['loss']))              # waits for the step
        times.append(time.perf_counter() - t0)
    paths['train'] = launches = read_counts()
    per_step = dict(upsample2x_add=32, upsample2x_add_bwd=32, maxpool2x2_fwd=33,
                    maxpool2x2_bwd_first=33, render_gaussian=1)
    expect_counts(first, 'train step', **per_step)
    expect_counts(launches, f'{TRAIN_TIMED} train steps',
                  **{k: v * TRAIN_TIMED for k, v in per_step.items()})
    check(all(l == l and abs(l) < float('inf') for l in losses), f'train: losses {losses}')
    check(sum(losses[-3:]) / 3 < losses[0],
          f'train: the loss does not fall on the fixed batch: {losses}')
    step_ms = sorted(times)[len(times) // 2] * 1e3
    out = dict(batch=batch, step_ms_p50=step_ms, images_per_s=batch / step_ms * 1e3,
               step_ms_min=min(times) * 1e3, step_ms_max=max(times) * 1e3,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=losses, acc_last=float(m['acc']),
               on_vs_off=dict(loss_rel=d_loss, grad_rel_l2=g_all,
                              worst_leaf=g_name, worst_leaf_rel_l2=g_leaf),
               off_vs_off_grad_rel_l2=g_noise)
    print('train: ' + json.dumps(out), flush=True)
    return state, out


def eval_phase(state, raw, spec, batch: int, paths: dict) -> dict:
    """The eval step on the fixed batch: running-average BN, so the fused
    bottleneck runs; once under each schedule (DEFAULT_IMPL switched),
    whose losses and heatmaps must be equal, and once with the kernels
    off."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch.data import augment_batch, sample_augmentations, to_device
    from hourglass_pose_estimation_torch.ops.hopper import bottleneck as bk
    from hourglass_pose_estimation_torch.runner import TrainState, make_eval_step
    eval_step = make_eval_step(spec, device_pipeline=True)
    valid = np.ones(batch, np.float32)
    data = to_device(raw, 'cuda')
    image = augment_batch(data, sample_augmentations(
        None, data['scale'], scale_factor=0, rot_factor=0, train=False), spec, False)['image']
    default = bk.DEFAULT_IMPL
    out, heatmaps = {}, {}
    try:
        for impl in (default,) + tuple(i for i in bk.IMPLS if i != default):
            bk.DEFAULT_IMPL = impl
            eval_step(state, raw, valid)                      # warm-up
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            m = eval_step(state, raw, valid)
            loss, acc = float(m['loss']), float(m['acc'])
            ms = (time.perf_counter() - t0) * 1e3
            paths[f'eval_{impl}'] = launches = read_counts()
            expect_counts(launches, f'eval step ({impl})', **{fused_name(impl): 65},
                          upsample2x_add=32, maxpool2x2_fwd=33, render_gaussian=1)
            check(np.isfinite(loss) and np.isfinite(acc), f'eval ({impl}): loss {loss}, acc {acc}')
            out[impl] = dict(loss=loss, acc=acc, step_ms=ms)
            with torch.no_grad():
                heatmaps[impl] = state.model(image, train=False)
    finally:
        bk.DEFAULT_IMPL = default
    a, b = bk.IMPLS
    check(out[a]['loss'] == out[b]['loss'] and out[a]['acc'] == out[b]['acc'],
          f'eval: the schedules give other metrics: {out}')
    check(torch.equal(heatmaps[a], heatmaps[b]), 'eval: the schedules give other heatmaps')
    del heatmaps
    # the same step with the kernels off, from the same state
    off = TrainState(model=set_switches(copy.deepcopy(state.model), False),
                     tx=state.tx, optimizer=state.optimizer, step=state.step)
    loss_off = float(eval_step(off, raw, valid)['loss'])
    loss = out[default]['loss']
    d_loss = abs(loss - loss_off) / abs(loss_off)
    del off
    out.update(loss_kernels_off=loss_off, loss_rel=d_loss, heatmaps_equal=True)
    print(f'eval: {json.dumps(out)} (tol loss {TOL_EVAL_LOSS})', flush=True)
    check(d_loss <= TOL_EVAL_LOSS, f'eval: loss kernels on vs off rel {d_loss:.3e}')
    return out


def frozen_phase(state, raw, spec, seed: int, paths: dict) -> dict:
    """Two frozen-BN train steps with the fused bottleneck (its autograd
    Function) from the trained state and its optimizer's statistics, at the
    schedule's rate past both decays, each against the same step with the
    kernels off from the same state: step 1 from the trained state (loss
    and gradients), step 2 from the kernel run's state after step 1 (loss:
    a fold of the fused blocks' parameters left stale by the optimizer's
    update would show here). Two runs that go their own ways after step 1
    are no check: with BN frozen on statistics of a few train steps, the
    loss is steep in the parameters (on the CPU at a small size: gradients
    9e-8 apart, losses after the second step 7e-2 apart)."""
    import torch
    from hourglass_pose_estimation_torch.models.norm import BatchNorm
    from hourglass_pose_estimation_torch.ops.hopper import fused_bottleneck
    from hourglass_pose_estimation_torch.runner import (
        TrainState, make_optimizer, make_train_step)
    step = make_train_step(spec, device_pipeline=True, freeze_bn=True)
    tx = make_optimizer(OPT[0] * OPT[2] ** 2, [], OPT[2], OPT[3])

    def fork(src, on: bool):
        model = set_switches(copy.deepcopy(src.model), on)
        opt = tx.build(list(model.parameters()))
        opt.load_state_dict(src.optimizer.state_dict())
        return TrainState(model=model, tx=tx, optimizer=opt, step=src.step)

    on = fork(state, True)
    stats = [t.clone() for m in on.model.modules() if isinstance(m, BatchNorm)
             for t in (m.running_mean, m.running_var)]
    losses, counts, grads = [], [], None
    for i in range(2):
        off = fork(on, False)
        zero_counts()
        on, m_on = step(on, raw, seed)
        loss_on = float(m_on['loss'])
        counts.append(read_counts())
        check(fused_bottleneck.backward_calls == 65,
              f'frozen step {i + 1}: {fused_bottleneck.backward_calls} backward '
              'calls of the fused bottleneck, not 65')
        off, m_off = step(off, raw, seed)
        losses.append((loss_on, float(m_off['loss'])))
        if i == 0:
            blk = on.model.hg0.up1_l4.block0            # 64^2: fused
            for name in ('bn1.weight', 'bn1.bias', 'bn2.weight', 'bn3.bias',
                         'conv1.weight', 'conv2.weight', 'conv3.weight', 'conv3.bias'):
                grad = blk.get_parameter(name).grad
                check(grad is not None and float(grad.abs().max()) > 0,
                      f'frozen step: hg0.up1_l4.block0.{name} has no gradient')
            grads = grad_rel_l2(on.model, off.model)
        del off
    paths['frozen'] = {k: counts[0][k] + counts[1][k] for k in counts[0]}
    for i, c in enumerate(counts):
        expect_counts(c, f'frozen step {i + 1}', **{fused_name(): 65}, upsample2x_add=32,
                      upsample2x_add_bwd=32, maxpool2x2_fwd=33, maxpool2x2_bwd_first=33,
                      render_gaussian=1)
    after = [t for m in on.model.modules() if isinstance(m, BatchNorm)
             for t in (m.running_mean, m.running_var)]
    check(all(torch.equal(a, b) for a, b in zip(after, stats)),
          'frozen step changed the running statistics')
    rels = [abs(a - b) / abs(b) for a, b in losses]
    out = dict(losses_on_off=losses, loss_rel=rels, step1_grad_rel_l2=grads[0],
               step1_worst_leaf=grads[2], step1_worst_leaf_rel_l2=grads[1])
    print(f'frozen: {json.dumps(out)} (tol loss {TOL_FROZEN_LOSS}, '
          f'gradients {TOL_FROZEN_GRAD})', flush=True)
    for i, (r, tol) in enumerate(zip(rels, TOL_FROZEN_LOSS)):
        check(all(abs(v) < float('inf') for v in losses[i]), f'frozen step {i + 1}: loss not finite')
        check(r <= tol, f'frozen step {i + 1}: loss kernels on vs off rel {r:.3e} > {tol}')
    check(grads[0] <= TOL_FROZEN_GRAD, f'frozen step 1: gradients on vs off {grads[0]:.3e}')
    return out


def trainer_phase(paths: dict, tmp: str) -> dict:
    """The trainer entry point at full width: `train_and_evaluate.main()` on
    configs/train_mpii_8stack.yaml (8 stacks, 256^2 -> 64^2, bf16, train and
    val batch 32, MODEL.fuse_block on) with TRAINER_OVERRIDES and its
    checkpoints in the directory `tmp`, then a second `main()` resumed
    from checkpoint_2. The Trainer is the CLI's own, instrumented to count
    the launches of each train epoch and each validation pass."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch import train_and_evaluate as tae
    from hourglass_pose_estimation_torch.ops.hopper import fused_bottleneck
    from hourglass_pose_estimation_torch.runner.trainer import Trainer

    runs = []

    class CountingTrainer(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.counts, self.resumed, self.produce_s = [], None, 0.0
            runs.append(self)
            if self.cfg.common.resume:
                self.resumed = self._against_checkpoint(self.cfg.common.resume)

        def _against_checkpoint(self, path: str) -> dict:
            saved = torch.load(path, map_location=self.device, weights_only=True)
            model = self.state.model.state_dict()
            opt, sopt = self.state.optimizer.state_dict(), saved['optimizer']
            opt_equal = all(
                torch.equal(v, sopt['state'][i][k]) if isinstance(v, torch.Tensor)
                else v == sopt['state'][i][k]
                for i, st in opt['state'].items() for k, v in st.items())
            return dict(
                start_epoch=self.start_epoch, step=self.state.step,
                lr=self.state.tx.lr(self.state.step), best_acc=self.best_acc,
                saved_step=saved['step'], saved_best_acc=saved['best_acc'],
                model_tensors=len(model),
                model_equal=model.keys() == saved['model'].keys() and all(
                    torch.equal(v, saved['model'][k]) for k, v in model.items()),
                optimizer_tensors=sum(len(st) for st in opt['state'].values()),
                optimizer_equal=(len(opt['state']) == len(sopt['state']) > 0 and opt_equal))

        def _make_produce(self, ds, with_valid=False):
            """The producer thread's seconds (host packing and the copy's
            dispatch) add up in `self.produce_s`."""
            produce = super()._make_produce(ds, with_valid)

            def timed(item):
                t0 = time.perf_counter()
                try:
                    return produce(item)
                finally:
                    self.produce_s += time.perf_counter() - t0
            return timed

        def _train_epoch(self, epoch, rng):
            zero_counts()
            self.produce_s = 0.0
            out = super()._train_epoch(epoch, rng)
            counts = read_counts()
            self.counts.append(dict(train=counts, backward_calls=fused_bottleneck.backward_calls,
                                    train_produce_s=self.produce_s))
            return out

        def _evaluate(self):
            zero_counts()
            out = super()._evaluate()
            self.counts[-1]['val'] = read_counts()
            return out

    cfg_path = str(REPO / 'configs' / 'train_mpii_8stack.yaml')
    out = {}
    saved_trainer = tae.Trainer
    tae.Trainer = CountingTrainer
    torch.cuda.reset_peak_memory_stats()
    try:
        overrides = TRAINER_OVERRIDES + [f'COMMON.checkpoint_dir={tmp}']
        t0 = time.time()
        check(tae.main([cfg_path] + overrides) == 0, 'trainer: main() failed')
        out['run_s'] = time.time() - t0
        ckpts = next(Path(tmp).glob('*/ckpts'))
        written = sorted(p.name for p in ckpts.iterdir())
        t0 = time.time()
        check(tae.main([cfg_path] + overrides
                       + [f'COMMON.resume={ckpts / "checkpoint_2"}']) == 0,
              'trainer: resumed main() failed')
        out['resume_run_s'] = time.time() - t0
    finally:
        tae.Trainer = saved_trainer
    out['max_memory_allocated_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(runs) == 2, f'trainer: {len(runs)} Trainers built, not 2')
    first, resumed = runs
    steps = first.steps_per_epoch
    check(steps == 4 and first.val_loader.batch_size == 32 and len(first.val_loader) == 4,
          f'trainer: {steps} steps, val batches {len(first.val_loader)}')

    # launches, worked out from the code: per train step 32 + 32 upsample,
    # 33 + 33 pool and 1 render; per validation batch 65 fused bottlenecks,
    # 32 upsample, 33 pool and 1 render; the frozen epoch adds 65 fused
    # bottleneck forwards and 65 backward calls of its Function per step
    per_step = dict(upsample2x_add=32, upsample2x_add_bwd=32, maxpool2x2_fwd=33,
                    maxpool2x2_bwd_first=33, render_gaussian=1)
    per_val = {fused_name(): 65, 'upsample2x_add': 32, 'maxpool2x2_fwd': 33,
               'render_gaussian': 1}
    total = {}
    epochs = [(run, h, c) for run in runs for h, c in zip(run.history, run.counts)]
    for run, h, c in epochs:
        frozen = h['epoch'] > FREEZE_BN_AFTER
        want = dict(per_step, **({fused_name(): 65} if frozen else {}))
        expect_counts(c['train'], f"trainer epoch {h['epoch']} train",
                      **{k: v * steps for k, v in want.items()})
        check(c['backward_calls'] == (65 * steps if frozen else 0),
              f"trainer epoch {h['epoch']}: {c['backward_calls']} backward calls")
        expect_counts(c['val'], f"trainer epoch {h['epoch']} val",
                      **{k: v * len(run.val_loader) for k, v in per_val.items()})
        for k in c['train']:
            total[k] = total.get(k, 0) + c['train'][k] + c['val'][k]
        check(all(np.isfinite(v) for v in h.values()), f'trainer: not finite: {h}')
        print('trainer epoch: ' + json.dumps(dict(h, resumed=run is resumed, launches_train=c['train'],
                                                  launches_val=c['val'],
                                                  fused_backward_calls=c['backward_calls'],
                                                  train_produce_s=c['train_produce_s'])),
              flush=True)
    paths['trainer'] = total
    check([h['epoch'] for h in first.history] == [1, 2, 3],
          f"trainer: epochs {[h['epoch'] for h in first.history]}")
    check(first.history[2]['train_loss'] < first.history[0]['train_loss'],
          'trainer: epoch 3 train loss not below epoch 1: '
          f"{[h['train_loss'] for h in first.history]}")
    check(written == ['best', 'checkpoint_1', 'checkpoint_2', 'checkpoint_3'],
          f'trainer: checkpoints {written}')
    r = resumed.resumed
    check(r['start_epoch'] == 2 and [h['epoch'] for h in resumed.history] == [3],
          f"trainer resume: start {r['start_epoch']}, epochs {[h['epoch'] for h in resumed.history]}")
    check(r['model_equal'] and r['optimizer_equal'],
          f"trainer resume: tensors differ from checkpoint_2: {r}")
    check(r['step'] == r['saved_step'] == 2 * steps and r['lr'] == first.tx.lr(2 * steps)
          and r['best_acc'] == r['saved_best_acc'], f'trainer resume: {r}')
    out.update(resume=r, best_acc=first.best_acc, checkpoints=written,
               losses=[h['train_loss'] for h in first.history])
    print('trainer: ' + json.dumps(out), flush=True)
    # checkpoint_3 holds the resumed run's weights after epoch 3, which
    # its epoch-3 validation read
    last = resumed.history[-1]
    out.update(checkpoint=str(ckpts / 'checkpoint_3'), val=(last['val_loss'], last['val_acc']),
               val_batches=len(resumed.val_loader), val_samples=len(resumed.val_ds))
    return out


def keypoint_agreement(got, ref, close: float, pixel) -> dict:
    """Share of joints whose keypoints lie within `close` px of `ref`'s (on
    both axes), and the largest gap in heatmap pixels' sizes (`pixel`, the
    image size of one heatmap pixel, (x, y))."""
    import numpy as np
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return dict(share_within=float((d.max(-1) <= close).mean()), close_px=close,
                max_px=float(d.max()), max_heatmap_px=float((d / np.asarray(pixel)).max()))


def tie_depth(hm, at):
    """Per map of `hm` [B, H*W, J]: how far below its max its value at the
    flat index `at` [B, J] (the other path's argmax) lies, as a share of
    the map's range (0: a tie)."""
    hi, lo = hm.amax(1), hm.amin(1)
    return (hi - hm.gather(1, at[:, None]).squeeze(1)) / (hi - lo).clamp_min(1e-30)


def switch_agreement(hm_on, hm_off, kp_on, kp_off, kp_plain, pixel, slack_px: float = 0.0):
    """The kernels on vs off through a whole path: heatmaps hm_* [N, H, W,
    J] on the card, keypoints kp_* [N, J, 2] in image pixels; kp_plain the
    plain decode (CPU) of hm_on. -> numbers, and whether the gates hold:
    the heatmaps within TOL_PATH_SWITCHES (rel L2); the path's keypoints the
    decode of its heatmaps (within slack_px + 1e-3 px); where a joint's
    argmax is the same in both maps, the two keypoints within half a
    heatmap pixel (the quarter step's two signs) plus that. Where the
    argmax moved (random weights: flat maps, near-ties that bf16 noise
    reorders), the keypoints may lie anywhere on the map, but the move is
    held to a near-tie: each path's map at the other's argmax within
    TOL_NEAR_TIE of its max, as a share of its range."""
    import numpy as np
    import torch
    B, H, W, J = hm_on.shape
    on, off = (h.reshape(B, H * W, J).float() for h in (hm_on, hm_off))
    a_on, a_off = on.argmax(1), off.argmax(1)
    moved = (a_on != a_off).cpu().numpy()
    depth = torch.maximum(tie_depth(off, a_on), tie_depth(on, a_off)).cpu().numpy()
    d = np.abs(np.asarray(kp_on, np.float64) - np.asarray(kp_off, np.float64)) / np.asarray(pixel)
    plain = np.abs(np.asarray(kp_on, np.float64) - np.asarray(kp_plain, np.float64)).max()
    out = dict(keypoint_agreement(kp_on, kp_off, 0.5, pixel), heatmaps_rel_l2=rel_l2(hm_on, hm_off),
               argmax_moved=int(moved.sum()), joints=int(moved.size),
               moved_tie_depth_max=float(depth[moved].max()) if moved.any() else 0.0,
               unmoved_max_heatmap_px=float(d[~moved].max()) if (~moved).any() else 0.0,
               path_vs_plain_decode_px=float(plain))
    out['ok'] = bool(out['heatmaps_rel_l2'] <= TOL_PATH_SWITCHES and plain <= slack_px + 1e-3
                     and out['moved_tie_depth_max'] <= TOL_NEAR_TIE
                     and out['unmoved_max_heatmap_px'] <= 0.5 + (slack_px + 1e-3) / min(pixel))
    return out


def evaluator_phase(tmp: str, trainer: dict, paths: dict) -> dict:
    """The standalone evaluator at full width: `train_and_evaluate.main()`
    with COMMON.evaluate_only on the trainer phase's checkpoint_3 (the
    flagship config with TRAINER_OVERRIDES: 128 synthetic val samples at
    batch 32, EVAL.flip_test on) and EVAL.official, the Evaluator the CLI's
    own, instrumented to count each pass's launches; then the flip-test
    keypoints with the kernels off, and with EVAL.decode=dark, its decode
    on the card (TF32 on) against the CPU on the same heatmaps."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch import train_and_evaluate as tae
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.ops.decode import decode_dark, decode_quarter_offset
    from hourglass_pose_estimation_torch.runner import Evaluator, TrainState

    calls = []

    class CountingEvaluator(Evaluator):
        def _count(self, what, fn, *args, **kwargs):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append(dict(what=what, s=time.perf_counter() - t0, counts=read_counts(),
                              out=out, state=args[0], evaluator=self))
            return out

        def evaluate(self, state):
            return self._count('evaluate', super().evaluate, state)

        def predict_keypoints(self, state, flip_test=None, return_scores=False):
            return self._count('predict_keypoints', super().predict_keypoints, state,
                               flip_test, return_scores)

        def evaluate_official(self, state, output_dir=None):
            return self._count('evaluate_official', super().evaluate_official, state, output_dir)

    cfg_path = str(REPO / 'configs' / 'train_mpii_8stack.yaml')
    argv = [cfg_path] + TRAINER_OVERRIDES + [
        f'COMMON.checkpoint_dir={tmp}', 'COMMON.evaluate_only=True',
        f'COMMON.resume={trainer["checkpoint"]}', 'EVAL.official=True']
    saved = tae.Evaluator
    tae.Evaluator = CountingEvaluator
    try:
        t0 = time.time()
        check(tae.main(argv) == 0, 'evaluator: main() failed')
        main_s = time.time() - t0
    finally:
        tae.Evaluator = saved
    check([c['what'] for c in calls] == ['evaluate', 'predict_keypoints', 'evaluate_official'],
          f"evaluator: calls {[c['what'] for c in calls]}")
    ev_call, pk_call, off_call = calls
    ev, state = ev_call['evaluator'], ev_call['state']
    nb, n = len(ev.loader), len(ev.ds)
    check(nb == trainer['val_batches'] == 4 and n == trainer['val_samples'] == 128
          and ev.cfg.eval.flip_test, f'evaluator: {nb} val batches of {n} samples')
    per_batch = {'evaluate': {fused_name(): 65, 'upsample2x_add': 32, 'maxpool2x2_fwd': 33,
                              'render_gaussian': 1},
                 'predict_keypoints': {fused_name(): 130, 'upsample2x_add': 64,
                                       'maxpool2x2_fwd': 66, 'decode_peaks': 1}}
    for c in (ev_call, pk_call):
        expect_counts(c['counts'], f"evaluator: {c['what']}, {nb} batches",
                      **{k: v * nb for k, v in per_batch[c['what']].items()})
        paths[f"evaluator_{c['what']}"] = c['counts']
    (loss, acc), (want_loss, want_acc) = ev_call['out'], trainer['val']
    d_loss, d_acc = abs(loss - want_loss) / abs(want_loss), abs(acc - want_acc)
    table = off_call['out']
    preds, scores = pk_call['out']
    check(np.isfinite(loss) and np.isfinite(acc) and d_loss <= TOL_EVALUATOR
          and d_acc <= TOL_EVALUATOR * abs(want_acc),
          f'evaluator: (loss, pck) ({loss}, {acc}) against the trainer\'s ({want_loss}, {want_acc})')
    check(table.keys() == {'AR', 'AR50', 'AR75', 'mean_oks'}
          and all(np.isfinite(v) for v in table.values()), f'evaluator: OKS table {table}')
    check(preds.shape == (n, 16, 2) and np.isfinite(preds).all() and np.isfinite(scores).all(),
          f'evaluator: keypoints {preds.shape}')
    pixel = (RES / (RES // 4),) * 2                 # a 256 px box on 64 px maps

    # the kernels off, the same weights: the flip-test keypoints
    off = TrainState(model=set_switches(copy.deepcopy(state.model), False), tx=None,
                     optimizer=None)
    t0 = time.perf_counter()
    preds_off = ev.predict_keypoints(off, flip_test=True)
    off_s = time.perf_counter() - t0
    perm = ev.flip_permutation(True)
    maps = [(ev.batch_heatmaps(state, idx, True, perm), ev.batch_heatmaps(off, idx, True, perm)[0])
            for idx, _ in ev.loader.epoch_indices()]
    plain = torch.cat([decode_quarter_offset(h.cpu(), c.cpu(), s.cpu(), zero_based=True)[0]
                       for (h, c, s), _ in maps])
    agree_off = switch_agreement(torch.cat([h for (h, _, _), _ in maps]),
                                 torch.cat([o for _, o in maps]), preds, preds_off, plain, pixel)
    del off, maps

    # EVAL.decode=dark with TF32 on: predict_keypoints, and its decode of
    # the first batch's flip-test heatmaps on the card against the CPU
    dark = Evaluator(load_config(cfg_path, overrides=TRAINER_OVERRIDES + ['EVAL.decode=dark']),
                     verbose=False)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        preds_dark = dark.predict_keypoints(state)
        dark_s = time.perf_counter() - t0
        hms, center, scale = dark.batch_heatmaps(state, dark.loader.epoch_indices()[0][0], True,
                                                 dark.flip_permutation(True))
        on_card = dark._decode(hms, center, scale)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    on_cpu = decode_dark(hms.cpu(), center.cpu(), scale.cpu(), zero_based=True)
    agree_dark = keypoint_agreement(on_card[0].cpu(), on_cpu[0], TOL_DARK_PX, pixel)
    agree_dark['maxvals_equal'] = bool(torch.equal(on_card[1].cpu(), on_cpu[1]))
    check(np.isfinite(preds_dark).all(), 'evaluator: DARK keypoints not finite')
    out = dict(main_s=main_s, evaluate_s=ev_call['s'], predict_flip_s=pk_call['s'],
               predict_flip_images_per_s=n / pk_call['s'], official_s=off_call['s'],
               predict_kernels_off_s=off_s, predict_dark_s=dark_s, loss=loss, acc=acc,
               trainer_val=trainer['val'], loss_rel=d_loss, acc_abs=d_acc, oks=table,
               kernels_on_vs_off=agree_off, dark_card_vs_cpu=agree_dark,
               dark_vs_quarter_median_px=float(np.median(np.abs(preds_dark - preds))))
    print('evaluator: ' + json.dumps(out), flush=True)
    check(agree_off['ok'], f'evaluator, kernels on vs off: {agree_off}')
    check(agree_dark['share_within'] == 1.0 and agree_dark['maxvals_equal'],
          f'evaluator, DARK decode card vs CPU: {agree_dark}')
    return out


def estimator_phase(ckpt: str, seed: int, paths: dict) -> dict:
    """The Estimator on the trainer phase's checkpoint_3 (the flagship
    config, COMMON.dataset synthetic, device preprocess): `run_batch` of
    ESTIMATOR_FRAMES uint8 480x640 frames (65/32/33 launches of the
    forward and 1 decode), against the kernels off; `run` of one frame,
    p50 of ESTIMATOR_RUNS calls; `run_skeleton`."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.ops.decode import decode_quarter_offset
    from hourglass_pose_estimation_torch.runner import Estimator
    cfg = load_config(str(REPO / 'configs' / 'train_mpii_8stack.yaml'),
                      overrides=[f'COMMON.resume={ckpt}', 'COMMON.dataset=synthetic'])
    est = Estimator(cfg)
    h, w = ESTIMATOR_FRAME
    frames = np.random.RandomState(seed + 11).randint(
        0, 256, size=(ESTIMATOR_FRAMES, h, w, 3)).astype(np.uint8)
    est.run_batch(frames, device_preprocess=True)                 # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    kps = est.run_batch(frames, device_preprocess=True)
    batch_s = time.perf_counter() - t0
    paths['estimator_run_batch'] = counts = read_counts()
    expect_counts(counts, f'estimator: run_batch of {ESTIMATOR_FRAMES}',
                  **{fused_name(): 65}, upsample2x_add=32, maxpool2x2_fwd=33, decode_peaks=1)
    check(kps.shape == (ESTIMATOR_FRAMES, 16, 2) and bool((kps >= 0).all())
          and bool((kps[..., 0] <= w).all() and (kps[..., 1] <= h).all()),
          f'estimator: keypoints {kps.shape} outside the frame')
    on = est.model
    hm_on = est._heatmaps(frames, True)
    est.model = set_switches(copy.deepcopy(on), False)
    kps_off = est.run_batch(frames, device_preprocess=True)
    hm_off = est._heatmaps(frames, True)
    est.model = on
    # the plain decode of the kernel path's heatmaps, as post_process_v2
    # decodes them (the network input as the box, each axis stretched)
    box = (torch.full((ESTIMATOR_FRAMES, 2), RES / 2.0), torch.full((ESTIMATOR_FRAMES, 2), RES / 200.0))
    plain = (decode_quarter_offset(hm_on.cpu(), *box, zero_based=True)[0].numpy()
             * np.array([w / RES, h / RES], np.float32)).astype(np.int32)
    pixel = (w / (RES // 4), h / (RES // 4))
    # int keypoints: the truncation adds up to 1 px
    agree = switch_agreement(hm_on, hm_off, kps, kps_off, plain, pixel, slack_px=1.0)
    del hm_on, hm_off
    ts = []
    for i in range(ESTIMATOR_RUNS + 2):
        t0 = time.perf_counter()
        one = est.run(frames[i % ESTIMATOR_FRAMES], time_it=False, device_preprocess=True)
        ts.append(time.perf_counter() - t0)
    zero_counts()
    peaks, hm_shape = est.run_skeleton(frames[0], device_preprocess=True)
    paths['estimator_run_skeleton'] = read_counts()
    check(peaks.shape == (16, 3) and np.isfinite(peaks).all() and hm_shape == (RES // 4,) * 2,
          f'estimator: run_skeleton {peaks.shape} {hm_shape}')
    check(one.shape == (16, 2), f'estimator: run {one.shape}')
    lat = sorted(ts[2:])[len(ts[2:]) // 2] * 1e3
    out = dict(frames=ESTIMATOR_FRAMES, frame=ESTIMATOR_FRAME, run_batch_s=batch_s,
               run_batch_images_per_s=ESTIMATOR_FRAMES / batch_s, run_ms_p50=lat,
               run_ms_min=min(ts[2:]) * 1e3, kernels_on_vs_off=agree)
    print('estimator: ' + json.dumps(out), flush=True)
    check(agree['ok'], f'estimator, kernels on vs off: {agree}')
    return out


def host_data_probe() -> dict:
    """What the host data layer could read images with on this machine: cv2
    (its version, imported in a child process, so that this one never
    loads it), libjpeg (the native loader links -ljpeg: the linker's name
    for it, and the libjpeg files in the usual library directories),
    jpeglib.h, and Pillow. Informs only."""
    import ctypes.util
    import importlib.util
    r = subprocess.run([sys.executable, '-c', 'import cv2; print(cv2.__version__)'],
                       capture_output=True, text=True, timeout=120)
    cv2 = r.stdout.strip() if r.returncode == 0 else (r.stderr.strip().splitlines() or [''])[-1]
    libdirs = ['/usr/lib', '/usr/lib64', '/usr/local/lib', '/usr/lib/x86_64-linux-gnu',
               '/usr/lib/aarch64-linux-gnu']
    incdirs = ['/usr/include', '/usr/local/include', '/usr/include/x86_64-linux-gnu',
               '/usr/include/aarch64-linux-gnu']
    return dict(cv2=cv2, cv2_imports=r.returncode == 0,
                libjpeg=ctypes.util.find_library('jpeg'),
                libjpeg_files=sorted(str(p) for d in libdirs for p in Path(d).glob('libjpeg*')),
                jpeglib_h=[d for d in incdirs if Path(d, 'jpeglib.h').is_file()],
                pillow=importlib.util.find_spec('PIL') is not None)


def mspn_model(seed: int, device='cuda'):
    """The full-width MSPN of MSPN_OVERRIDES (2 stages, 16 joints, decoder
    width 256, 256^2 -> 64^2), bf16 compute, f32 parameters and BN, seeded
    weights."""
    import torch
    from hourglass_pose_estimation_torch.models import get_model
    torch.manual_seed(seed)
    return get_model('mspn', device=device, num_stacks=MSPN_STACKS, num_classes=16,
                     out_res=RES // 4)


def mspn_train_phase(seed: int, raw, spec, batch: int, paths: dict):
    """The MSPN train step at full width: 3 warm-up and 10 timed steps on a
    fixed batch through the device pipeline (the render kernel), the loss of
    every step, 1 render and no other launch a step. -> (state, numbers)."""
    import torch
    from hourglass_pose_estimation_torch.runner import init_state, make_optimizer, make_train_step
    model = mspn_model(seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f'mspn: {MSPN_STACKS} stages, {n_params:,} parameters', flush=True)
    check(n_params == MSPN_PARAMS, f'mspn: {n_params:,} parameters, not {MSPN_PARAMS:,}')
    state = init_state(model, make_optimizer(*OPT))
    step = make_train_step(spec, device_pipeline=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, m = step(state, raw, seed)
    losses = [float(m['loss'])]
    expect_counts(read_counts(), 'mspn train step', render_gaussian=1)
    for _ in range(TRAIN_WARMUP - 1):
        state, m = step(state, raw, seed)
        losses.append(float(m['loss']))
    zero_counts()
    times = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        state, m = step(state, raw, seed)
        losses.append(float(m['loss']))              # waits for the step
        times.append(time.perf_counter() - t0)
    paths['mspn_train'] = launches = read_counts()
    expect_counts(launches, f'mspn: {TRAIN_TIMED} train steps', render_gaussian=TRAIN_TIMED)
    check(all(l == l and abs(l) < float('inf') for l in losses), f'mspn train: losses {losses}')
    check(losses[-1] < losses[0], f'mspn train: step {len(losses)} loss not below step 1: {losses}')
    step_ms = sorted(times)[len(times) // 2] * 1e3
    out = dict(batch=batch, params=n_params, step_ms_p50=step_ms,
               images_per_s=batch / step_ms * 1e3, step_ms_min=min(times) * 1e3,
               step_ms_max=max(times) * 1e3,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=losses, acc_last=float(m['acc']), launches_per_step={
                   k: v // TRAIN_TIMED for k, v in launches.items()})
    print('mspn train: ' + json.dumps(out), flush=True)
    return state, out


def mspn_eval_phase(state, raw, spec, batch: int, paths: dict) -> dict:
    """The eval step on the trained MSPN: 1 render, a finite loss."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch.runner import make_eval_step
    eval_step = make_eval_step(spec, device_pipeline=True)
    valid = np.ones(batch, np.float32)
    eval_step(state, raw, valid)                                   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    m = eval_step(state, raw, valid)
    loss, acc = float(m['loss']), float(m['acc'])
    ms = (time.perf_counter() - t0) * 1e3
    paths['mspn_eval'] = launches = read_counts()
    expect_counts(launches, 'mspn eval step', render_gaussian=1)
    check(np.isfinite(loss) and np.isfinite(acc), f'mspn eval: loss {loss}, acc {acc}')
    out = dict(loss=loss, acc=acc, step_ms=ms)
    print('mspn eval: ' + json.dumps(out), flush=True)
    return out


def mspn_config(*extra):
    from hourglass_pose_estimation_torch.config import load_config
    return load_config(str(REPO / 'configs' / 'train_mpii_8stack.yaml'),
                       overrides=MSPN_OVERRIDES + list(extra))


def mspn_serving_phase(seed: int, paths: dict, profile: bool) -> dict:
    """serve_http.build_inference of MODEL.arch=mspn (fold_bn, bf16 weights,
    batch 64, MODEL.fuse_block at the arch's default, off) behind the
    batcher and the HTTP server: MSPN_REQUESTS frames, 1 decode launch a
    batch; the folded heatmaps against the unfolded ones on the card, and
    the card's bf16 against the f32 forward on the CPU for two frames;
    batch-64 and batch-1 latency."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch.data import get_meanstd
    from hourglass_pose_estimation_torch.export import make_inference_fn
    from hourglass_pose_estimation_torch.models import MSPN
    from hourglass_pose_estimation_torch.serve_http import build_inference
    cfg = mspn_config('EVAL.export_keypoints=true', 'EVAL.export_preprocess=true',
                      f'EVAL.export_batch={BATCH}', 'EVAL.export_bf16_weights=true')
    check(cfg.model.fuse_block is False, f'mspn config: MODEL.fuse_block {cfg.model.fuse_block}')
    model = mspn_model(seed, device='cpu')
    randomize_bn_(model, torch.Generator().manual_seed(seed + 1))
    weights = io.BytesIO()
    torch.save(model.state_dict(), weights)
    weights.seek(0)
    fn, batch, frame_shape, frame_dtype = build_inference(cfg, weights)
    check(batch == BATCH and frame_shape == (RES, RES, 3) and frame_dtype == np.uint8,
          f'mspn serve_http built batch {batch}, frames {frame_shape} {frame_dtype}')
    frames = client_frames(seed, BATCH)
    fn(frames)                                                     # warm-up
    torch.cuda.synchronize()
    zero_counts()
    replies, serve_s, stats, batcher = serve_load(fn, seed, MSPN_REQUESTS)
    paths['mspn_serve'] = launches = read_counts()
    nb = batcher.n_batches
    for i, r in enumerate(replies):
        kps = np.asarray(r['keypoints'], np.float64)
        check(kps.shape == (16, 2) and len(r['scores']) == 16
              and bool(np.isfinite(kps).all() and np.isfinite(r['scores']).all())
              and bool((kps >= 0).all() and (kps <= RES).all()), f'mspn reply {i}: {kps.shape}')
    check(batcher.n_frames == MSPN_REQUESTS, f'mspn served {batcher.n_frames} frames')
    expect_counts(launches, f'mspn serving, {nb} batches', decode_peaks=nb)

    meanstd = get_meanstd(cfg.dataset.name)
    build = lambda m, fold, device='cuda', wd=torch.bfloat16: make_inference_fn(
        m, None, fold_bn=fold, weights_dtype=wd, preprocess=meanstd, input_res=RES,
        device=device)
    hm_fold = build(model, True)(frames)
    hm_unfold = build(model, False)(frames)
    torch.cuda.synchronize()
    check(tuple(hm_fold.shape) == (BATCH, RES // 4, RES // 4, 16)
          and bool(torch.isfinite(hm_fold).all()), f'mspn heatmaps {tuple(hm_fold.shape)}')
    err_fold = rel_l2(hm_fold, hm_unfold)
    ref = MSPN(num_stacks=MSPN_STACKS, num_classes=16, out_res=RES // 4, dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    with torch.inference_mode():
        hm_ref = build(ref, True, device='cpu', wd=None)(frames[:2])
    err_ref = rel_l2(hm_fold[:2].cpu(), hm_ref)
    del hm_unfold, ref

    def one(x):
        out = fn(x)
        torch.cuda.synchronize()
        return out

    lat = {}
    for b in (BATCH, 1):
        for _ in range(3):
            one(frames[:b])
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            one(frames[:b])
            ts.append(time.perf_counter() - t0)
        lat[b] = sorted(ts)[len(ts) // 2] * 1e3
    out = dict(batch=BATCH, requests=MSPN_REQUESTS, served_batches=nb,
               served_images_per_s=MSPN_REQUESTS / serve_s,
               served_batch_ms_p50=stats['batch_latency_ms_p50'],
               fn_batch_ms_p50=lat[BATCH], fn_images_per_s=BATCH / lat[BATCH] * 1e3,
               fn_batch1_ms_p50=lat[1], folded_vs_unfolded_rel_l2=err_fold,
               card_bf16_vs_cpu_f32_rel_l2=err_ref, launches=launches)
    print(f'mspn serving: {json.dumps(out)} (tol folded {TOL_MSPN_FOLD}, '
          f'f32 reference {TOL_MSPN_F32_REFERENCE})', flush=True)
    check(err_fold <= TOL_MSPN_FOLD, f'mspn folded vs unfolded rel L2 {err_fold:.3e}')
    check(err_ref <= TOL_MSPN_F32_REFERENCE, f'mspn card bf16 vs CPU f32 rel L2 {err_ref:.3e}')
    if profile:
        profile_block(lambda: one(frames), 'mspn serving batch of 64', lat[BATCH])
    return out


def mspn_trainer_phase(paths: dict, tmp: str) -> dict:
    """The trainer CLI with MODEL.arch=mspn at full width (MSPN_TRAINER:
    synthetic data, 2 epochs of MSPN_STEPS steps at batch 32, a snapshot
    each epoch), each epoch's launches counted: 1 render a train step and a
    val batch, nothing else."""
    import numpy as np
    from hourglass_pose_estimation_torch import train_and_evaluate as tae
    from hourglass_pose_estimation_torch.runner.trainer import Trainer

    runs = []

    class CountingTrainer(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.counts = []
            runs.append(self)

        def _train_epoch(self, epoch, rng):
            zero_counts()
            out = super()._train_epoch(epoch, rng)
            self.counts.append(dict(train=read_counts()))
            return out

        def _evaluate(self):
            zero_counts()
            out = super()._evaluate()
            self.counts[-1]['val'] = read_counts()
            return out

    saved = tae.Trainer
    tae.Trainer = CountingTrainer
    try:
        t0 = time.time()
        check(tae.main([str(REPO / 'configs' / 'train_mpii_8stack.yaml')] + MSPN_OVERRIDES
                       + MSPN_TRAINER + [f'COMMON.checkpoint_dir={tmp}']) == 0,
              'mspn trainer: main() failed')
        run_s = time.time() - t0
    finally:
        tae.Trainer = saved
    check(len(runs) == 1, f'mspn trainer: {len(runs)} Trainers')
    (tr,) = runs
    check(type(tr.model).__name__ == 'MSPN' and tr.steps_per_epoch == MSPN_STEPS,
          f'mspn trainer: {type(tr.model).__name__}, {tr.steps_per_epoch} steps')
    nval = len(tr.val_loader)
    total = {}
    for h, c in zip(tr.history, tr.counts):
        expect_counts(c['train'], f"mspn trainer epoch {h['epoch']} train",
                      render_gaussian=MSPN_STEPS)
        expect_counts(c['val'], f"mspn trainer epoch {h['epoch']} val", render_gaussian=nval)
        for k in c['train']:
            total[k] = total.get(k, 0) + c['train'][k] + c['val'][k]
        check(all(np.isfinite(v) for v in h.values()), f'mspn trainer: not finite: {h}')
        print('mspn trainer epoch: ' + json.dumps(dict(h, launches_train=c['train'],
                                                       launches_val=c['val'])), flush=True)
    paths['mspn_trainer'] = total
    ckpts = next(Path(tmp).glob('*_mspn_*/ckpts'))
    written = sorted(p.name for p in ckpts.iterdir())
    check([h['epoch'] for h in tr.history] == [1, 2]
          and {'checkpoint_1', 'checkpoint_2'} <= set(written)
          and ('best' in written) == (tr.best_acc > 0), f'mspn trainer: checkpoints {written}')
    last = tr.history[-1]
    out = dict(run_s=run_s, epochs=tr.history, checkpoints=written,
               checkpoint=str(ckpts / 'checkpoint_2'), val=(last['val_loss'], last['val_acc']),
               val_batches=nval)
    print('mspn trainer: ' + json.dumps({k: v for k, v in out.items() if k != 'epochs'}),
          flush=True)
    return out


def mspn_evaluator_phase(tmp: str, trainer: dict, paths: dict) -> dict:
    """`evaluate_only` with MODEL.arch=mspn on the trainer's checkpoint_2
    (the config's flip test, EVAL.official): 1 render a batch in
    `evaluate`, 1 decode a batch in the flip-test `predict_keypoints`;
    (loss, PCK) equal to the trainer's epoch-2 validation; a finite OKS
    table."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch import train_and_evaluate as tae
    from hourglass_pose_estimation_torch.runner import Evaluator

    calls = []

    class CountingEvaluator(Evaluator):
        def _count(self, what, fn, *args):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            calls.append(dict(what=what, s=time.perf_counter() - t0, counts=read_counts(),
                              out=out))
            return out

        def evaluate(self, state):
            return self._count('evaluate', super().evaluate, state)

        def predict_keypoints(self, state, flip_test=None, return_scores=False):
            return self._count('predict_keypoints', super().predict_keypoints, state,
                               flip_test, return_scores)

    saved = tae.Evaluator
    tae.Evaluator = CountingEvaluator
    try:
        t0 = time.time()
        check(tae.main([str(REPO / 'configs' / 'train_mpii_8stack.yaml')] + MSPN_OVERRIDES
                       + MSPN_TRAINER + [f'COMMON.checkpoint_dir={tmp}',
                                         'COMMON.evaluate_only=True', 'EVAL.official=True',
                                         f'COMMON.resume={trainer["checkpoint"]}']) == 0,
              'mspn evaluator: main() failed')
        main_s = time.time() - t0
    finally:
        tae.Evaluator = saved
    check([c['what'] for c in calls] == ['evaluate', 'predict_keypoints'],
          f"mspn evaluator: calls {[c['what'] for c in calls]}")
    ev, pk = calls
    nb = trainer['val_batches']
    expect_counts(ev['counts'], 'mspn evaluator: evaluate', render_gaussian=nb)
    expect_counts(pk['counts'], 'mspn evaluator: predict_keypoints', decode_peaks=nb)
    paths['mspn_evaluator_evaluate'], paths['mspn_evaluator_predict'] = ev['counts'], pk['counts']
    (loss, acc), (want_loss, want_acc) = ev['out'], trainer['val']
    preds, scores = pk['out']
    check(np.isfinite(loss) and abs(loss - want_loss) <= TOL_EVALUATOR * abs(want_loss)
          and abs(acc - want_acc) <= TOL_EVALUATOR * abs(want_acc),
          f'mspn evaluator: ({loss}, {acc}) against the trainer\'s ({want_loss}, {want_acc})')
    check(preds.shape[1:] == (16, 2) and np.isfinite(preds).all() and np.isfinite(scores).all(),
          f'mspn evaluator: keypoints {preds.shape}')
    out = dict(main_s=main_s, evaluate_s=ev['s'], predict_flip_s=pk['s'],
               predict_flip_images_per_s=len(preds) / pk['s'], loss=loss, acc=acc)
    print('mspn evaluator: ' + json.dumps(out), flush=True)
    return out


def mspn_estimator_phase(ckpt: str, seed: int, paths: dict) -> dict:
    """The Estimator with MODEL.arch=mspn on the trainer's checkpoint_2,
    device preprocess: `run_batch` of 64 uint8 480x640 frames (1 decode),
    `run` batch-1 latency."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch.runner import Estimator
    est = Estimator(mspn_config(f'COMMON.resume={ckpt}', 'COMMON.dataset=synthetic'))
    check(type(est.model).__name__ == 'MSPN', f'mspn estimator: {type(est.model).__name__}')
    h, w = ESTIMATOR_FRAME
    frames = np.random.RandomState(seed + 12).randint(
        0, 256, size=(ESTIMATOR_FRAMES, h, w, 3)).astype(np.uint8)
    est.run_batch(frames, device_preprocess=True)                  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    kps = est.run_batch(frames, device_preprocess=True)
    batch_s = time.perf_counter() - t0
    paths['mspn_estimator'] = counts = read_counts()
    expect_counts(counts, 'mspn estimator: run_batch', decode_peaks=1)
    check(kps.shape == (ESTIMATOR_FRAMES, 16, 2) and bool((kps >= 0).all())
          and bool((kps[..., 0] <= w).all() and (kps[..., 1] <= h).all()),
          f'mspn estimator: keypoints {kps.shape} outside the frame')
    ts = []
    for i in range(ESTIMATOR_RUNS + 2):
        t0 = time.perf_counter()
        one = est.run(frames[i % ESTIMATOR_FRAMES], time_it=False, device_preprocess=True)
        ts.append(time.perf_counter() - t0)
    check(one.shape == (16, 2), f'mspn estimator: run {one.shape}')
    out = dict(run_batch_s=batch_s, run_batch_images_per_s=ESTIMATOR_FRAMES / batch_s,
               run_ms_p50=sorted(ts[2:])[len(ts[2:]) // 2] * 1e3)
    print('mspn estimator: ' + json.dumps(out), flush=True)
    return out


def mspn_interop_phase(ckpt: str, tmp: str, seed: int) -> dict:
    """The trainer's checkpoint_2 exported to a reference-named .pth.tar and
    imported back through the interop CLI: the served heatmaps of the two
    port checkpoints (serve_http's build) equal bit for bit."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch import interop
    from hourglass_pose_estimation_torch.serve_http import build_inference
    ref = str(Path(tmp) / 'mspn_reference.pth.tar')
    back = str(Path(tmp) / 'mspn_imported')
    cfg_path = str(REPO / 'configs' / 'train_mpii_8stack.yaml')
    t0 = time.time()
    check(interop.main(['export', ckpt, ref]) == 0, 'mspn interop: export failed')
    check(interop.main(['import', cfg_path, ref, back] + MSPN_OVERRIDES) == 0,
          'mspn interop: import failed')
    round_s = time.time() - t0
    keys = torch.load(ref, weights_only=True)['state_dict'].keys()
    check(any(k.startswith('mspn_modules.1.upsample.up4.') for k in keys)
          and not any(k.startswith('stage') for k in keys), 'mspn interop: reference names')
    cfg = mspn_config('EVAL.export_preprocess=true', f'EVAL.export_batch={BATCH}',
                      'EVAL.export_bf16_weights=true')
    frames = client_frames(seed + 5, BATCH)
    maps = []
    for path in (ckpt, back):
        weights = io.BytesIO()
        torch.save(torch.load(path, map_location='cpu', weights_only=True)['model'], weights)
        weights.seek(0)
        maps.append(build_inference(cfg, weights)[0](frames))
    torch.cuda.synchronize()
    equal = bool(torch.equal(maps[0], maps[1]))
    out = dict(entries=len(keys), round_trip_s=round_s, heatmaps_equal=equal,
               heatmaps_finite=bool(torch.isfinite(maps[0]).all()))
    print('mspn interop: ' + json.dumps(out), flush=True)
    check(equal and out['heatmaps_finite'], 'mspn interop: served heatmaps differ after the '
          'round trip')
    return out


def profile_block(fn, what: str, unprofiled_ms: float, top: int = 14) -> None:
    """torch.profiler over one call of fn: wall time, device busy time and
    idle share (against the profiled wall, and against `unprofiled_ms`, the
    same call's p50 without the profiler), the largest kernels by device
    time, each of the port's kernels, the PyTorch ops that launched the
    most device time, and the device time by kind of kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # device kernels only (an aten op's device time repeats its kernels';
    # a user annotation's device span repeats the kernels inside it)
    ev = [e for e in avgs if e.device_type == DeviceType.CUDA and e.device_time_total > 0
          and not getattr(e, 'is_user_annotation', False)]
    busy = sum(e.device_time_total for e in ev) / 1e3
    ev.sort(key=lambda e: -e.device_time_total)
    print(f'profile {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms '
          f'(idle share {max(0.0, 1 - busy / wall):.3f}; against the unprofiled '
          f'{unprofiled_ms:.2f} ms: {max(0.0, 1 - busy / unprofiled_ms):.3f})', flush=True)
    for e in ev[:top]:
        print(f'  {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x {e.key[:90]}', flush=True)
    for e in ev:
        if any(n in e.key.lower() for n in PORT_KERNEL_NAMES):
            print(f'  port kernel {e.device_time_total / 1e3:9.4f} ms {e.count:5d}x {e.key[:70]}',
                  flush=True)
    ops = [e for e in avgs if e.device_type == DeviceType.CPU
           and getattr(e, 'self_device_time_total', 0) > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:top]:
        print(f'  op {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x {e.key[:80]}',
              flush=True)
    kinds = {}
    for e in ev:
        k = e.key.lower()
        kind = ('port kernels' if any(n in k for n in PORT_KERNEL_NAMES)
                else 'convolution and GEMM' if any(n in k for n in (
                    'conv', 'gemm', 'xmma', 'sm90', 'cutlass', 'wgrad', 'dgrad', 'cudnn'))
                else 'reductions' if 'reduce' in k
                else 'copies and casts' if any(n in k for n in ('copy', 'cat', 'fill'))
                else 'elementwise' if 'elementwise' in k
                else 'other')
        kinds[kind] = kinds.get(kind, 0.0) + e.device_time_total / 1e3
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f'  by kind: {ms:9.3f} ms {kind}', flush=True)


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
    from hourglass_pose_estimation_torch.ops.hopper import _build
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
    print('host data probe: ' + json.dumps(host_data_probe()), flush=True)

    # 2. build (one nvcc per source, all started together)
    t0 = time.time()
    lib = _build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    print(f'build: {time.time() - t0:.1f} s; ' + ' | '.join(ptxas), flush=True)

    # 3. kernels vs plain
    with torch.no_grad():
        rows = kernel_phases(args.seed) + training_kernel_phases(args.seed)
    paths = {}

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

    zero_counts()
    replies, serve_s, stats, batcher = serve_load(fn, args.seed)
    paths['serve'] = launches = read_counts()
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
    expect_counts(launches, f'serving, {nb} batches', **{fused_name(): 65 * nb},
                  upsample2x_add=32 * nb, maxpool2x2_fwd=33 * nb, decode_peaks=nb)

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
    perf = dict(card=card, batch=BATCH, fn_batch_ms_p50=lat[BATCH],
                fn_images_per_s=BATCH / lat[BATCH] * 1e3, fn_batch1_ms_p50=lat[1],
                served_images_per_s=N_REQUESTS / serve_s,
                served_batch_ms_p50=stats['batch_latency_ms_p50'],
                served_batch_ms_p95=stats['batch_latency_ms_p95'],
                served_batches=nb)
    print('serving: ' + json.dumps(perf), flush=True)

    if args.profile:
        one(x64)
        profile_block(lambda: one(x64), 'serving batch of 64', lat[BATCH])
        # the front end alone: the same load against a function that
        # returns fixed keypoints at once
        kp0, mv0 = (t.cpu() for t in fn(x64[:1]))
        _, s0, st0, b0 = serve_load(
            lambda b: (kp0.expand(len(b), -1, -1), mv0.expand(len(b), -1)), args.seed)
        print(f'front end alone: {N_REQUESTS / s0:.1f} img/s, '
              f'{b0.n_frames / b0.n_batches:.1f} frames per batch', flush=True)
    del fn, hm_fn, batcher, model, ref_model
    torch.cuda.empty_cache()

    # 6-8. the flagship train step, the eval step, the frozen-BN step
    raw, spec = train_data(TRAIN_BATCH)
    state, train = train_phase(args.seed, raw, spec, TRAIN_BATCH, paths)
    eval_phase(state, raw, spec, TRAIN_BATCH, paths)
    frozen_phase(state, raw, spec, args.seed, paths)
    if args.profile:
        from hourglass_pose_estimation_torch.runner import make_train_step
        step = make_train_step(spec, device_pipeline=True)
        profile_block(lambda: step(state, raw, args.seed), f'train step, batch {TRAIN_BATCH}',
                      train['step_ms_p50'], top=24)
    del state
    torch.cuda.empty_cache()

    # 9-11. the trainer entry point, with snapshots and a resumed run; the
    # standalone evaluator and the estimator on its last checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        trainer = trainer_phase(paths, tmp)
        torch.cuda.empty_cache()
        evaluation = evaluator_phase(tmp, trainer, paths)
        torch.cuda.empty_cache()
        estimation = estimator_phase(trainer['checkpoint'], args.seed, paths)
    torch.cuda.empty_cache()

    # 12-14. MSPN at full width: the train step, the eval step, serving, the
    # trainer CLI, the evaluator CLI, the estimator, the interop round trip
    raw, spec = train_data(MSPN_TRAIN_BATCH)
    state, mspn_train = mspn_train_phase(args.seed, raw, spec, MSPN_TRAIN_BATCH, paths)
    mspn_eval_phase(state, raw, spec, MSPN_TRAIN_BATCH, paths)
    if args.profile:
        from hourglass_pose_estimation_torch.runner import make_train_step
        step = make_train_step(spec, device_pipeline=True)
        profile_block(lambda: step(state, raw, args.seed),
                      f'mspn train step, batch {MSPN_TRAIN_BATCH}', mspn_train['step_ms_p50'],
                      top=24)
    del state, raw
    torch.cuda.empty_cache()
    mspn_serve = mspn_serving_phase(args.seed, paths, args.profile)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mspn_trainer = mspn_trainer_phase(paths, tmp)
        torch.cuda.empty_cache()
        mspn_evaluator_phase(tmp, mspn_trainer, paths)
        torch.cuda.empty_cache()
        mspn_estimation = mspn_estimator_phase(mspn_trainer['checkpoint'], args.seed, paths)
        torch.cuda.empty_cache()
        mspn_interop_phase(mspn_trainer['checkpoint'], tmp, args.seed)

    # 15. the kernels, with their launches on the main paths
    for r in rows:
        r['launches'] = sum(p[r['name']] for p in paths.values())
        r['launches_by_path'] = {k: p[r['name']] for k, p in paths.items()}
        # the pool backward that splits ties is held to the Pallas kernel
        # above; the model's pools take the first-maximum one
        if r.pop('on_main_path', True):
            check(r['launches'] > 0, f"{r['name']} not launched on the main paths")
        else:
            check(r['launches'] == 0, f"{r['name']} launched on the main paths")
    print(f'card: {card}; train step p50 {train["step_ms_p50"]:.2f} ms, '
          f'{train["images_per_s"]:.1f} img/s at batch {TRAIN_BATCH}; trainer '
          f'{trainer["run_s"]:.1f} s for 3 epochs; evaluator predict_keypoints with flip '
          f'test {evaluation["predict_flip_images_per_s"]:.1f} img/s; estimator run_batch '
          f'{estimation["run_batch_images_per_s"]:.1f} img/s, run p50 '
          f'{estimation["run_ms_p50"]:.2f} ms', flush=True)
    print(f'card: {card}; mspn ({MSPN_PARAMS:,} parameters): train step p50 '
          f'{mspn_train["step_ms_p50"]:.2f} ms, {mspn_train["images_per_s"]:.1f} img/s at batch '
          f'{MSPN_TRAIN_BATCH}, peak {mspn_train["max_memory_allocated_gib"]:.2f} GiB; served '
          f'{mspn_serve["served_images_per_s"]:.1f} img/s, batch-1 '
          f'{mspn_serve["fn_batch1_ms_p50"]:.2f} ms; trainer {mspn_trainer["run_s"]:.1f} s for '
          f'2 epochs; estimator run p50 {mspn_estimation["run_ms_p50"]:.2f} ms', flush=True)
    print(json.dumps({'kernels': rows}), flush=True)
    print(f'total {time.time() - t_start:.1f} s', flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
