#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failed check exits non-zero; no phase catches its own
failure):
  1. the card's name and power limit (nvidia-smi), and a probe of what the
     host data layer could decode images with here (cv2, libjpeg,
     jpeglib.h, Pillow, and the native loader's build: available, or why
     not; it informs and fails nothing);
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
 15. the host data layer at full width (cv2 required): seeded trees of
     JPEG files in the readers' formats, MPII (128 train and 64 valid
     persons over 1280x720 images, scales 1.5 to 3.5, 16 valid persons at
     0.9, gt_valid.mat) and COCO (64 persons a split over 640x480 images,
     with a crowd, a zero-area and an all-zero-keypoint annotation);
     the native loader's state and the slots each path filled; cv2's
     decode ms of a 1280x720 JPEG, `canvas_batch` and `host_batch` ms of
     32; cv2's file crops against the numpy warp_region (1 level); the
     host pipeline's crops against the device pipeline's on the card
     (median < 1 and p99 < 4 levels); the trainer CLI on
     configs/train_mpii_8stack.yaml with the tree (2 epochs of 4 steps at
     batch 32, the device pipeline: launches exact, the loss falling, the
     producer's seconds beside the epoch's), `evaluate_only` with
     EVAL.official and EVAL.gt_mat on its checkpoint_2 (the PCKh table and
     pred.mat; (loss, PCK) equal to the trainer's; the decode launches),
     the host pipeline (1 epoch: 1 render a batch through
     prepare_host_batch, no device warp), a validation pass on
     whole-image canvases (q = 0.2), and on configs/train_coco_8stack.yaml
     the trainer (1 epoch of 2 steps) and `evaluate_only` with the DARK
     decode (a results file row per valid person, a finite OKS table);
 16. export and the serving tools on the trainer phase's checkpoint_3: the
     export CLI (`python -m hourglass_pose_estimation_torch.export`) writes
     the flagship serving function as a `torch.export` program (batch 64,
     uint8 256x256 frames, quarter decode, folded BN, bf16 weights), whose
     graph keeps every kernel as an `hpe::` op; loaded in a fresh process
     and in this one (`load_serving_artifact`), each held bit-equal to
     make_inference_fn on the same seeded frames with exact launches per
     call (65 bottleneck, 32 upsample, 33 pool, 1 decode); served over HTTP
     as phase 4 serves (every reply equal to the direct call's); a batch-1
     program for batch-1 latency, and serving_demo's sync, async and
     sustained modes through it on seeded JPEGs; profile_step and step_cost
     once; export and load seconds, size, batch-64 and batch-1 p50 beside
     the in-process function's, served img/s;
 17. MSPN at full width through the export CLI on the MSPN trainer's
     checkpoint_2, loaded and held bit-equal to make_inference_fn (1 decode
     launch a call, no other);
 18. data parallelism (`parallel/`): (a) the flagship train step at batch
     64 under DDP over NCCL at world size 1 (a process group of this
     process alone), held equal to the one-process step from the same
     weights and draws (the loss and every gradient), both timed in turns
     (step ms p50); (b) two ranks on this one card over gloo (NCCL refuses
     two ranks on one device), each a process of its own whose first use
     of the kernels builds them into one fresh directory at the same time
     as the other's: the 8-stack at full width, bf16, global batch 32 (16 a
     rank), 3 implicit steps (DDP, BatchNorm synced over the ranks) against
     the one-process step on the same 32 samples (each step's loss, equal
     on both ranks, and the parameters' update after step 3, within the
     gates; the step-1 gradients beside one process's own noise with the
     batch's halves swapped; one f32 step, TF32 off, whose gradients are
     held to one process's), then 2 explicit steps with sync_bn off (finite; their running
     statistics differ across the ranks and from the synced step's after
     as many steps, which are equal across the ranks); per rank step ms
     p50, global img/s, peak memory and launches (exact); (c) the trainer
     CLI on the two ranks: one epoch of 4 steps at batch 32 on synthetic
     data, rank 0 writing checkpoint_1, and a resume from it to epoch 2
     that restores every tensor exactly on both ranks; launches exact; a
     failed rank fails the run;
 19. pipeline parallelism (`parallel/pipeline.py`): the flagship's 8
     stacks split 4 + 4 over two ranks (stages) on this one card over gloo,
     each hand-off staged through host memory, each rank a process of its
     own that loads the library phase 2 built: (a) in f32 (TF32 off) at a
     global batch of 8 in 2 microbatches, the eval-mode loss and gradients
     against one process's HourglassNet with the same weights, and the
     train-mode ones against one process's sequential oracle of the same
     microbatch slices; (b) in bf16 at a global batch of 32 in 4
     microbatches, 3 warm-up and 5 timed steps of the raw step (device
     pipeline): every loss finite and equal on both stages, per stage step
     ms p50, global img/s, the hand-off's host ms, peak memory and exact
     launches (stage 0: 68 pool and 64 upsample launches a step, each
     forward and backward; stage 1: 64 and 64; 1 render each); (c) the
     trainer CLI with TRAIN.pipeline_parallel=2 TRAIN.microbatches=4, one
     epoch of 4 steps at batch 32 (launches exact), validation through the
     merged model (65/32/33 launches and 1 render a val batch), rank 0
     alone writing checkpoint_1 in the standard layout, a pipeline resume
     that restores every tensor exactly on both ranks, and `evaluate_only`
     (EVAL.official) of checkpoint_1 on both ranks, reading the trainer's
     validation of those weights. Two ranks on one card share its SMs and
     pass each hand-off through host memory: its times are not two cards'
     over NVLink;
 20. the overlapped train step (`make_overlapped_train_step`): the
     flagship at batch 64, the next batch's augmentation and target render
     staged on a side stream; the prime, 3 overlapped steps and the drain
     against as many sequential steps from the same weights (each staged
     batch bit-equal to the sequential augmentation of it, every loss
     within 1e-6 relative of the sequential one), exact launches;
     step ms p50 overlapped and sequential, timed in turns (3 warm-up, 5
     timed);
 21. tensor parallelism (`parallel/tensor_parallel.py`): the flagship
     over a (data 1 x model 2) layout, two ranks on this one card over
     gloo (which copies every model-axis collective through host memory),
     each rank a process of its own that loads the library phase 2 built;
     (a) in f32 (TF32 off) at a global batch of 8, one step in eval mode
     (frozen BN) and one in train mode against one process's unsharded
     step with the same weights (the loss, the gathered gradients, the
     update), the model ranks' replicated gradients before their average
     (how far each rank's lies from it), the replicated parameters
     bit-equal on both ranks; (b) in bf16 at a global batch of 16, 2
     warm-up and 3 timed steps: every loss finite and equal on both ranks,
     step ms p50, global img/s, the model axis's bytes and collectives a
     step and their host ms, peak memory, exact launches (each rank sees
     the full activations: 33 + 33 pool, 32 + 32 upsample, 1 render a
     step), and a frozen-BN step with no fused bottleneck (its blocks hold
     shards); (c) the trainer CLI with TRAIN.model_parallel=2: an epoch of
     4 steps at batch 4 and one with BN frozen (launches exact), validation
     through the gathered standard-layout replica (65/32/33 launches and 1
     render a val batch), rank 0 alone writing checkpoint_1 in the
     standard layout, a TP resume that restores every tensor exactly and
     shards the same leaves again, and `evaluate_only` (EVAL.official) of
     checkpoint_1, reading the trainer's validation of those weights. Two
     ranks on one card share its SMs and pass every collective through
     host memory: its times are not two cards' over NVLink;
 22. the `kernels` JSON line (launches summed over the main paths of
     phases 4, 6-11, 12-14, 15, 16, 17, 18, 19, 20 and 21, each rank's
     among them; the pool backward that splits ties is on none of them),
     then the result line.
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
# the flagship train step, and its launches on any path (the device
# pipeline's render, 32 + 32 upsample and 33 + 33 pool)
TRAIN_BATCH = 64
TRAIN_LAUNCHES = dict(upsample2x_add=32, upsample2x_add_bwd=32, maxpool2x2_fwd=33,
                      maxpool2x2_bwd_first=33, render_gaussian=1)
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
# the export phase: the flagship serving function as the export CLI writes
# it (batch 64, uint8 frames, quarter decode, folded BN, bf16 weights), and
# serving_demo's modes on DEMO_JPEGS seeded JPEGs of DEMO_FRAME pixels
EXPORT_OVERRIDES = ['EVAL.export_keypoints=true', 'EVAL.export_preprocess=true',
                    f'EVAL.export_batch={BATCH}', 'EVAL.export_bf16_weights=true']
DEMO_JPEGS, DEMO_FRAME = 3, (480, 640)
TRAINER_OVERRIDES = ['DATASET.name=synthetic', 'DATASET.num_samples=128',
                     'TRAIN.epochs=3', 'TRAIN.steps_per_epoch=4',
                     f'TRAIN.freeze_bn_after_epoch={FREEZE_BN_AFTER}', 'COMMON.snapshot=1',
                     'TRAIN.learning_rate=2.5e-5']

# the host data phase: seeded trees of JPEG files in the readers' formats.
# MPII: 128 train and 64 valid persons, two a 1280x720 image, annotated
# scales 1.5 to 3.5 (MPII's); the first 16 valid persons at 0.9, whose eval
# crop region (0.9 * 1.25 * 200 + 4 = 229 px) fits a 256 canvas at q = 1.
# COCO: 64 persons a split, two a 640x480 image. The flagship configs
# with the trees' paths, a snapshot each epoch, lr 2.5e-5 (as the trainer
# phase), 4 steps an epoch at batch 32 (COCO: 2, its 64 persons)
HOST_MPII = dict(n_train=128, n_valid=64, image_size=(1280, 720), scales=(1.5, 3.5), n_small=16,
                 small_scale=0.9)
HOST_COCO = dict(n_persons=64, image_size=(640, 480))
HOST_OVERRIDES = ['COMMON.snapshot=1', 'TRAIN.learning_rate=2.5e-5']
HOST_STEPS, HOST_COCO_STEPS = 4, 2
# cv2's crop of a file against the port's numpy warp_region on the same
# decoded pixels: within 1 level (the rounding of the taps' weights), on
# at most 1e-4 of the values (data/common.py::warp_region)
TOL_CV2_WARP = (1, 1e-4)
# the host pipeline's crops against the device pipeline's crop of the same
# persons at q = 1, in levels: the bound the JAX package holds its own two
# pipelines to (tests/test_pipeline.py), median and 99th percentile
TOL_HOST_CROPS = (1.0, 4.0)

# the data-parallel phase.
# (a) DDP over NCCL at world size 1 against the one-process step at batch
# 64: the loss and the gradients (relative L2), held equal (read 0 on an
# H100); then both timed in turns
DP_WORLD1_WARMUP, DP_WORLD1_TIMED = 2, 5
TOL_DP_WORLD1 = 0.0
# (b) two ranks on the one card over gloo (NCCL refuses two ranks on one
# device): global batch 32 (16 a rank), DP_STEPS implicit steps (DDP, sync
# BN) against the one-process step on the same 32 samples: the loss of
# each step, relative, and the parameters' update after the last,
# relative L2 of the difference over the one process's update. Each
# stands beside one process's own noise: the same steps with the batch's
# halves swapped (the same sums in another order). In bf16 that noise is
# large: the step-1 gradients read 0.29 relative L2 between the ranks and
# one process on an H100, and 0.31 with the halves swapped, and RMSprop's
# first update, lr * 10 * sign(g), moves each parameter whose gradient is
# that noise by +-lr * 10 at random. So the gradients are held in an f32
# step (TF32 off): read 4.9e-3, held at 2e-2. The losses read at most
# 3.2e-3 apart, held at 1.3e-2; the update 0.60, held below 1.0 (updates
# of independent signs read sqrt(2)). Then DP_EXPLICIT_STEPS explicit
# steps with sync_bn off. At the
# flagship schedule's rate past both decays (2.5e-5), as the trainer
# phase: at 2.5e-3 the first update lifts the loss 30-fold (0.08 to 2.7 at
# a small size on the CPU) and the steps after it compare chaos.
DP_RANKS, DP_GLOBAL_BATCH, DP_STEPS, DP_EXPLICIT_STEPS = 2, 32, 3, 2
DP_OPT = (2.5e-5, [], 0.1, 100)
TOL_DP_LOSS = 1.3e-2
TOL_DP_UPDATE = 1.0
TOL_DP_GRAD_F32 = 2e-2
# (c) the trainer CLI on the two ranks: one epoch of 4 steps (batch 32),
# validation of 4 batches, a snapshot; then a resume to epoch 2
DP_TRAINER_STEPS = 4
DP_TRAINER = ['DATASET.name=synthetic', 'DATASET.num_samples=128', 'TRAIN.epochs=1',
              f'TRAIN.steps_per_epoch={DP_TRAINER_STEPS}', 'COMMON.snapshot=1',
              'TRAIN.learning_rate=2.5e-5']
# every rank of (b) and (c) together, the build included; also each
# collective's limit
DP_TIMEOUT_S = 600
DP_DEVICE = 'cuda:0'
# the pipeline phase (19): the flagship's 8 stacks split 4 + 4 over two
# ranks (stages) on this one card over gloo, every hand-off through host
# memory. (a) parity in f32 (TF32 off): a global batch of 8 in 2
# microbatches, the eval-mode (running averages) loss and gradients against
# one process's HourglassNet with the same weights, and the train-mode ones
# against one process's sequential oracle of the same microbatch slices
# (loss relative; gradients relative L2 over the model). Read on an H100:
# the losses 0 (eval) and 1.04e-7 (train), the gradients 2.08e-7 and
# 2.40e-6; held at about 4x (the eval loss at the train loss's gate).
PP_RANKS, PP_STACKS = 2, 8
PP_PARITY_BATCH, PP_PARITY_M = 8, 2
TOL_PP_LOSS = {'eval': 4e-7, 'train': 4e-7}
TOL_PP_GRAD = {'eval': 8e-7, 'train': 1e-5}
# (b) bf16 timing: global batch 32 in 4 microbatches of 8, the raw step
# (device pipeline); per step and stage the launches: per microbatch stage
# 0 runs the stem's pool and its 4 stacks' 16 pools and 16 merges, stage 1
# its stacks', forward and backward, and each stage renders the targets
PP_GLOBAL_BATCH, PP_M, PP_WARMUP, PP_TIMED = 32, 4, 3, 5
PP_LAUNCHES = [dict(maxpool2x2_fwd=68, maxpool2x2_bwd_first=68, upsample2x_add=64,
                    upsample2x_add_bwd=64, render_gaussian=1),
               dict(maxpool2x2_fwd=64, maxpool2x2_bwd_first=64, upsample2x_add=64,
                    upsample2x_add_bwd=64, render_gaussian=1)]
# (c) the trainer CLI on the two stages: one epoch of 4 steps at batch 32,
# validation of the merged model (4 batches, 16 rows a rank), a snapshot;
# evaluate_only of it on both ranks (each the whole validation set, 4
# batches of 32) against the trainer's validation of the same weights,
# relative (loss) and absolute (PCK): read 0 on an H100 (bf16 forwards of
# 32 rows against 16), held as the evaluator phase holds its own
PP_TRAINER = DP_TRAINER + ['TRAIN.pipeline_parallel=2', f'TRAIN.microbatches={PP_M}']
TOL_PP_EVALUATE_ONLY = TOL_EVALUATOR
PP_TIMEOUT_S = 600
# the overlapped phase (20): the flagship train step at batch 64 on the
# fixed batch, the next batch's augmentation and render staged on a side
# stream. The prime, OVERLAP_STEPS overlapped steps and the drain against
# as many sequential steps from the same weights: each staged batch
# bit-equal to the sequential augmentation of it, and every loss within
# 1e-6 relative of the sequential one (the same step on the same tensors:
# read 0 on an H100); then both timed in turns
OVERLAP_STEPS = 3
OVERLAP_WARMUP, OVERLAP_TIMED = 3, 5
TOL_OVERLAP_LOSS = 1e-6
# the tensor-parallel phase (21): the flagship over a (data 1 x model 2)
# layout, two ranks on this one card over gloo (every model-axis collective
# through host memory), each loading the library phase 2 built. (a) f32,
# TF32 off, a global batch of 8 (the host pipeline, staged here): one step
# in eval mode (frozen BN) and one in train mode against one process's
# unsharded step with the same weights: the loss, relative; the gradients
# gathered and the update, relative L2 over the model. Read on an H100:
# the losses 0 (each output channel is the sum one process forms), the
# gradients 1.35e-7 (eval) and 3.45e-6 (train), the update 3.4e-3 and
# 3.2e-4 (RMSprop's first update follows the sign of the gradients that
# are rounding noise); held at about 4x, the losses at f32's rounding of
# one sum
TP_RANKS, TP_PARITY_BATCH = 2, 8
TOL_TP_LOSS = {'eval': 1e-6, 'train': 1e-6}
TOL_TP_GRAD = {'eval': 6e-7, 'train': 1.4e-5}
TOL_TP_UPDATE = {'eval': 1.4e-2, 'train': 1.3e-3}
# the model ranks' replicated gradients before the average that keeps them
# one value (`ShardedTrainState.replicated_spread`): the largest distance
# of a rank's from the average, relative to the leaf's largest value. Read
# on an H100 in two runs: 2.13e-7 and 3.19e-7 (eval), 5.07e-7 and 3.85e-7
# (train), in 10 of the 30 replicated leaves, the largest in the
# replicated convs' weights (each process may take another cuDNN
# weight-gradient algorithm); held at about 4x the larger reading
TOL_TP_SPREAD = {'eval': 1.3e-6, 'train': 2e-6}
# (b) bf16 at a global batch of 16 (each rank computes all 16 rows, its
# slice of each sharded conv's channels): 2 warm-up and 3 timed steps,
# TRAIN_LAUNCHES a step on each rank (each sees the full activations), and
# one frozen-BN step, which launches no fused bottleneck (its blocks hold
# shards)
TP_GLOBAL_BATCH, TP_WARMUP, TP_TIMED = 16, 2, 3
# (c) the trainer CLI with TRAIN.model_parallel=2: an epoch of 4 steps at
# batch 4 (on an H100 a step of batch 16 took 14.5 s, of 8 about 7: the
# model axis's bytes, which scale with the batch, go through host memory), then
# one with BN frozen; a TP resume from checkpoint_1 (built and checked, no
# epoch run); evaluate_only of checkpoint_1 against the trainer's
# validation of those weights (4 batches of 32, 16 rows a rank), held as
# the evaluator phase holds its own
TP_TRAINER = DP_TRAINER + ['TRAIN.model_parallel=2', 'TRAIN.train_batch=4', 'TRAIN.epochs=2',
                           'TRAIN.freeze_bn_after_epoch=1']
TOL_TP_EVALUATE_ONLY = TOL_EVALUATOR
TP_TIMEOUT_S = 900

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
    from hourglass_pose_estimation_torch.ops.hopper import fused_bottleneck
    from hourglass_pose_estimation_torch.utils import tracing
    tracing.reset()
    fused_bottleneck.backward_calls = 0


def read_counts() -> dict:
    from hourglass_pose_estimation_torch.ops.hopper import launch_counts
    return launch_counts()


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


def flagship_model(seed: int, device='cuda', **kwargs):
    """HourglassNet(8 stacks, 1 block, 16 joints, sum merges), bf16
    compute (unless kwargs name another dtype), f32 parameters and BN,
    seeded weights, the kernels on."""
    import torch
    from hourglass_pose_estimation_torch.models import get_model
    torch.manual_seed(seed)
    return get_model('hg', device=device, num_stacks=8, num_blocks=1,
                     num_classes=16, mobile=False, skip_mode='sum',
                     fuse_block=True, fuse_upsample=True, **kwargs)


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
    per_step = TRAIN_LAUNCHES
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


def counting_trainer(runs: list):
    """The port's Trainer, instrumented: each one built is appended to
    `runs`; it records each train epoch's and validation pass's launch
    counts, the fused bottleneck's backward calls, the producer thread's
    seconds (host packing, decoding included, and the copy's dispatch) and
    the wall seconds; with COMMON.resume, the restored state against the
    checkpoint."""
    import torch
    from hourglass_pose_estimation_torch.ops.hopper import fused_bottleneck
    from hourglass_pose_estimation_torch.runner.trainer import Trainer

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

        def _make_produce(self, *args, **kwargs):
            """The producer thread's seconds (host packing and the copy's
            dispatch) add up in `self.produce_s`."""
            produce = super()._make_produce(*args, **kwargs)

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
            t0 = time.perf_counter()
            out = super()._train_epoch(epoch, rng)
            counts = read_counts()
            self.counts.append(dict(train=counts, backward_calls=fused_bottleneck.backward_calls,
                                    train_produce_s=self.produce_s,
                                    train_s=time.perf_counter() - t0))
            return out

        def _evaluate(self):
            zero_counts()
            self.produce_s = 0.0
            t0 = time.perf_counter()
            out = super()._evaluate()
            self.counts[-1].update(val=read_counts(), val_produce_s=self.produce_s,
                                   val_s=time.perf_counter() - t0)
            return out

    return CountingTrainer


def trainer_phase(paths: dict, tmp: str) -> dict:
    """The trainer entry point at full width: `train_and_evaluate.main()` on
    configs/train_mpii_8stack.yaml (8 stacks, 256^2 -> 64^2, bf16, train and
    val batch 32, MODEL.fuse_block on) with TRAINER_OVERRIDES and its
    checkpoints in the directory `tmp`, then a second `main()` resumed
    from checkpoint_2. The Trainer is the CLI's own, instrumented to count
    the launches of each train epoch and each validation pass."""
    import numpy as np
    import torch

    runs = []
    CountingTrainer = counting_trainer(runs)

    argv = [str(REPO / 'configs' / 'train_mpii_8stack.yaml')] + TRAINER_OVERRIDES + [
        f'COMMON.checkpoint_dir={tmp}']
    out = {}
    torch.cuda.reset_peak_memory_stats()
    out['run_s'] = run_main(argv, 'trainer', Trainer=CountingTrainer)
    ckpts = next(Path(tmp).glob('*/ckpts'))
    written = sorted(p.name for p in ckpts.iterdir())
    out['resume_run_s'] = run_main(argv + [f'COMMON.resume={ckpts / "checkpoint_2"}'],
                                   'trainer, resumed', Trainer=CountingTrainer)
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
    per_step = TRAIN_LAUNCHES
    per_val = eval_launches()
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


def counting_evaluator(calls: list):
    """The port's Evaluator, instrumented: each call of `evaluate`,
    `predict_keypoints` and `evaluate_official` appends to `calls` its name,
    wall seconds (synchronised), launch counts, result, state and the
    Evaluator."""
    import torch
    from hourglass_pose_estimation_torch.runner import Evaluator

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

    return CountingEvaluator


def run_main(argv, what: str, **classes) -> float:
    """`train_and_evaluate.main(argv)` with its Trainer or Evaluator replaced
    by `classes` (restored after), checked to exit 0 -> its wall seconds."""
    from hourglass_pose_estimation_torch import train_and_evaluate as tae
    saved = {k: getattr(tae, k) for k in classes}
    for k, v in classes.items():
        setattr(tae, k, v)
    try:
        t0 = time.time()
        check(tae.main(argv) == 0, f'{what}: main() failed')
        return time.time() - t0
    finally:
        for k, v in saved.items():
            setattr(tae, k, v)


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
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.ops.decode import decode_dark, decode_quarter_offset
    from hourglass_pose_estimation_torch.runner import Evaluator, TrainState

    calls = []
    CountingEvaluator = counting_evaluator(calls)

    cfg_path = str(REPO / 'configs' / 'train_mpii_8stack.yaml')
    argv = [cfg_path] + TRAINER_OVERRIDES + [
        f'COMMON.checkpoint_dir={tmp}', 'COMMON.evaluate_only=True',
        f'COMMON.resume={trainer["checkpoint"]}', 'EVAL.official=True']
    main_s = run_main(argv, 'evaluator', Evaluator=CountingEvaluator)
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
    (its version, imported in a child process), the native loader
    (built here from native/hostloader.cpp, or why it is not), libjpeg (the
    native loader links -ljpeg: the linker's name for it, and the libjpeg
    files in the usual library directories), jpeglib.h, and Pillow.
    Informs only."""
    import ctypes.util
    import importlib.util
    r = subprocess.run([sys.executable, '-c', 'import cv2; print(cv2.__version__)'],
                       capture_output=True, text=True, timeout=120)
    cv2 = r.stdout.strip() if r.returncode == 0 else (r.stderr.strip().splitlines() or [''])[-1]
    libdirs = ['/usr/lib', '/usr/lib64', '/usr/local/lib', '/usr/lib/x86_64-linux-gnu',
               '/usr/lib/aarch64-linux-gnu']
    incdirs = ['/usr/include', '/usr/local/include', '/usr/include/x86_64-linux-gnu',
               '/usr/include/aarch64-linux-gnu']
    from hourglass_pose_estimation_torch.data import native
    return dict(cv2=cv2, cv2_imports=r.returncode == 0,
                native_loader=native.available(),
                native_unavailable_reason=native.unavailable_reason(),
                libjpeg=ctypes.util.find_library('jpeg'),
                libjpeg_files=sorted(str(p) for d in libdirs for p in Path(d).glob('libjpeg*')),
                jpeglib_h=[d for d in incdirs if Path(d, 'jpeglib.h').is_file()],
                pillow=importlib.util.find_spec('PIL') is not None)


class count_warps:
    """Counts the device pipeline's crop warps (`data.pipeline`'s gather and
    separable warp) while active."""

    def __enter__(self):
        from hourglass_pose_estimation_torch.data import pipeline
        self.n, self._saved = 0, {}
        for name in ('affine_warp', 'affine_warp_separable'):
            fn = self._saved[name] = getattr(pipeline, name)
            setattr(pipeline, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        from hourglass_pose_estimation_torch.data import pipeline
        for name, fn in self._saved.items():
            setattr(pipeline, name, fn)


def host_data_timings(ds, cv2, batch: int) -> dict:
    """Host costs on this machine: cv2's decode of each image file of `ds`
    (ms, median of up to 32), `canvas_batch` of `batch` persons in crop mode
    and `host_batch` of `batch` (ms, median of 4 batches each)."""
    import numpy as np
    files = sorted(set(ds.records.image_paths))
    decode = []
    for f in files[:32]:
        t0 = time.perf_counter()
        img = cv2.imread(f, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        decode.append(time.perf_counter() - t0)
        check(img is not None, f'host data: cv2 cannot read {f}')
    canvas, host = [], []
    for k in range(4):
        idx = list(range(k * batch, (k + 1) * batch))
        t0 = time.perf_counter()
        ds.canvas_batch(idx, canvas=RES, crop_aware=True)
        canvas.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ds.host_batch(idx, np.random.RandomState(k))
        host.append(time.perf_counter() - t0)
    med = lambda ts: float(np.median(ts)) * 1e3
    return dict(image=list(img.shape), decode_ms=med(decode), canvas_batch_ms=med(canvas),
                host_batch_ms=med(host), batch=batch, slot_paths=dict(ds.slot_paths))


def host_epochs(what: str, run, steps: int, paths: dict, per_step: dict, per_val: dict) -> dict:
    """Check each epoch of a counting Trainer: its launches exact, every
    value finite; print the epoch with its producer and wall seconds; add
    its launches to paths[what] -> the last epoch's history."""
    import numpy as np
    nval = len(run.val_loader)
    total = {}
    for h, c in zip(run.history, run.counts):
        expect_counts(c['train'], f"{what} epoch {h['epoch']} train",
                      **{k: v * steps for k, v in per_step.items()})
        expect_counts(c['val'], f"{what} epoch {h['epoch']} val",
                      **{k: v * nval for k, v in per_val.items()})
        check(all(np.isfinite(v) for v in h.values()), f'{what}: not finite: {h}')
        for k in c['train']:
            total[k] = total.get(k, 0) + c['train'][k] + c['val'][k]
        print(f'{what} epoch: ' + json.dumps(dict(
            h, train_produce_s=c['train_produce_s'], train_s=c['train_s'],
            val_produce_s=c['val_produce_s'], val_s=c['val_s'], launches_train=c['train'],
            launches_val=c['val'])), flush=True)
    paths[what.replace(' ', '_')] = total
    return run.history[-1]


def host_data_phase(tmp: str, seed: int, paths: dict, card: str, device='cuda') -> dict:
    """The host data layer at full width: seeded MPII and COCO trees of JPEG
    files (HOST_MPII, HOST_COCO) read through the readers, cv2 (required)
    and the native loader where it builds; the trainer CLI on
    configs/train_mpii_8stack.yaml under the device pipeline (2 epochs) and
    `evaluate_only` with EVAL.official and the tree's gt_valid.mat on its
    checkpoint_2; the host pipeline (1 epoch, targets by
    prepare_host_batch, no device warp); the host crops against the device
    pipeline's on the card; a validation pass on whole-image canvases
    (q = 0.2); the trainer CLI and `evaluate_only` (DARK) on
    configs/train_coco_8stack.yaml."""
    import numpy as np
    import torch
    from scipy.io import loadmat
    from hourglass_pose_estimation_torch.data import (
        crop_batch, fabricate, get_dataset, make_spec, native, sample_augmentations, to_device)
    from hourglass_pose_estimation_torch.data.common import warp_region
    try:
        import cv2
    except ImportError as e:
        fail(f'host data: cv2 does not import here: {e}')
    loader = dict(cv2=cv2.__version__, native_available=native.available(),
                  native_unavailable_reason=native.unavailable_reason())
    print('host data loader: ' + json.dumps(loader), flush=True)
    t0 = time.time()
    img, ann, gt = fabricate.mpii_tree(str(Path(tmp, 'mpii')), np.random.RandomState(seed + 21),
                                       **HOST_MPII)
    cimg, cann = fabricate.coco_tree(str(Path(tmp, 'coco')), np.random.RandomState(seed + 22),
                                     **HOST_COCO)
    trees_s = time.time() - t0
    mpii_cfg = [str(REPO / 'configs' / 'train_mpii_8stack.yaml'), f'DATASET.image_path={img}',
                f'DATASET.annotation_path={ann}'] + HOST_OVERRIDES
    coco_cfg = [str(REPO / 'configs' / 'train_coco_8stack.yaml'), f'DATASET.image_path={cimg}',
                f'DATASET.annotation_path={cann}'] + HOST_OVERRIDES
    per_step = TRAIN_LAUNCHES
    per_val = eval_launches()
    per_predict = {fused_name(): 130, 'upsample2x_add': 64, 'maxpool2x2_fwd': 66}

    # the host's costs, and cv2's file crops against the numpy warp
    train_ds = get_dataset('mpii', True, image_path=img, annotation_path=ann)
    timings = host_data_timings(train_ds, cv2, HOST_MPII['n_train'] // 4)
    val_ds = get_dataset('mpii', False, image_path=img, annotation_path=ann)
    small = list(range(HOST_MPII['n_small']))
    saved = native.load_region_batch
    native.load_region_batch = lambda *a, **k: None             # every slot through cv2
    try:
        raw = val_ds.canvas_batch(small, canvas=RES, crop_aware=True)
    finally:
        native.load_region_batch = saved
    check(bool((raw['canvas_scale'] == 1).all()), f"host data: q {raw['canvas_scale']}")
    worst = (0, 0.0)
    for k, i in enumerate(small):
        src = cv2.imread(val_ds.records.image_paths[i],
                         cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        ox, oy = raw['canvas_offset'][k]
        diff = np.abs(raw['canvas'][k].astype(int) - warp_region(src, 1.0, ox, oy, RES))
        worst = max(worst, (int(diff.max()), float((diff > 0).mean())))
    check(worst[0] <= TOL_CV2_WARP[0] and worst[1] <= TOL_CV2_WARP[1],
          f'host data: cv2 crops vs warp_region {worst}')

    # the host pipeline's crops of the small persons against the device
    # pipeline's crop of their canvases on the card (no normalisation)
    host = val_ds.host_batch(small, np.random.RandomState(0), train=False)['image']
    spec = make_spec(val_ds)._replace(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
    dev = to_device(val_ds.canvas_batch(small, canvas=RES, crop_aware=True), device)
    draws = sample_augmentations(None, dev['scale'], scale_factor=spec.scale_factor,
                                 rot_factor=spec.rot_factor, train=False)
    crop = crop_batch(dev, draws, spec, False)['image'] * 255.0
    d = (crop - torch.from_numpy(host).to(device, torch.float32)).abs().flatten().cpu().numpy()
    crops = dict(persons=len(small), median=float(np.median(d)), p99=float(np.percentile(d, 99)),
                 max=float(d.max()))
    check(crops['median'] < TOL_HOST_CROPS[0] and crops['p99'] < TOL_HOST_CROPS[1],
          f'host data: host crops vs device crops {crops}')

    # MPII files, the device pipeline: the trainer CLI, then evaluate_only
    runs, calls = [], []
    run_dir = str(Path(tmp, 'mpii_run'))
    with count_warps() as warps:
        train_s = run_main(mpii_cfg + ['TRAIN.epochs=2', f'TRAIN.steps_per_epoch={HOST_STEPS}',
                                       f'COMMON.checkpoint_dir={run_dir}'],
                           'host data, mpii trainer', Trainer=counting_trainer(runs))
    (tr,) = runs
    nval = len(tr.val_loader)
    check(tr.steps_per_epoch == HOST_STEPS and tr.crop_aware and tr.device_pipeline
          and tr.val_ds.name == 'mpii' and len(tr.val_ds) == HOST_MPII['n_valid']
          and nval == -(-HOST_MPII['n_valid'] // tr.cfg.train.val_batch),
          f'host data, mpii trainer: {tr.steps_per_epoch} steps, {nval} val batches')
    check(warps.n == 2 * (HOST_STEPS + nval), f'host data, mpii trainer: {warps.n} warps')
    last = host_epochs('host mpii trainer', tr, HOST_STEPS, paths, per_step, per_val)
    check(tr.history[1]['train_loss'] < tr.history[0]['train_loss'],
          f"host data, mpii trainer: loss {[h['train_loss'] for h in tr.history]}")
    mpii_slots = dict(train=dict(tr.train_ds.slot_paths), val=dict(tr.val_ds.slot_paths))
    ckpt = next(Path(run_dir).glob('*/ckpts')) / 'checkpoint_2'
    eval_s = run_main(mpii_cfg + [f'COMMON.checkpoint_dir={run_dir}', 'COMMON.evaluate_only=True',
                                  f'COMMON.resume={ckpt}', 'EVAL.official=True', f'EVAL.gt_mat={gt}'],
                      'host data, mpii evaluator', Evaluator=counting_evaluator(calls))
    check([c['what'] for c in calls] == ['evaluate', 'predict_keypoints', 'evaluate_official'],
          f"host data, mpii evaluator: calls {[c['what'] for c in calls]}")
    ev_call, pk_call, off_call = calls
    ev = ev_call['evaluator']
    expect_counts(ev_call['counts'], 'host data, mpii evaluate',
                  **{k: nval * v for k, v in per_val.items()})
    expect_counts(pk_call['counts'], 'host data, mpii predict_keypoints',
                  **{k: nval * v for k, v in per_predict.items()}, decode_peaks=nval)
    paths['host_mpii_evaluate'], paths['host_mpii_predict'] = ev_call['counts'], pk_call['counts']
    (loss, acc), table = ev_call['out'], off_call['out']
    check(abs(loss - last['val_loss']) <= TOL_EVALUATOR * abs(last['val_loss'])
          and abs(acc - last['val_acc']) <= TOL_EVALUATOR * abs(last['val_acc']),
          f"host data, mpii evaluator: ({loss}, {acc}) against the trainer's "
          f"({last['val_loss']}, {last['val_acc']})")
    pred = loadmat(str(Path(ev.cfg.common.checkpoint_dir, 'pred.mat')))['preds']
    check(list(table) == ['Head', 'Shoulder', 'Elbow', 'Wrist', 'Hip', 'Knee', 'Ankle', 'Mean',
                          'Mean@0.1'] and all(np.isfinite(v) for v in table.values())
          and pred.shape == (HOST_MPII['n_valid'], 16, 2) and np.isfinite(pred).all(),
          f'host data, mpii PCKh {table}, pred.mat {pred.shape}')

    # the host pipeline: 1 epoch of the same CLI, no device warp
    runs = []
    with count_warps() as warps:
        host_s = run_main(mpii_cfg + ['DATASET.device_pipeline=false', 'TRAIN.epochs=1',
                                      f'TRAIN.steps_per_epoch={HOST_STEPS}',
                                      f"COMMON.checkpoint_dir={Path(tmp, 'host_run')}"],
                          'host data, host pipeline', Trainer=counting_trainer(runs))
    (hp,) = runs
    check(not hp.device_pipeline and warps.n == 0, f'host data, host pipeline: {warps.n} warps')
    host_last = host_epochs('host pipeline trainer', hp, HOST_STEPS, paths, per_step, per_val)

    # whole-image canvases (q = 256/1280): one validation pass of checkpoint_2
    calls = []
    whole_s = run_main(mpii_cfg + [f"COMMON.checkpoint_dir={Path(tmp, 'whole_run')}",
                                   'COMMON.evaluate_only=True', f'COMMON.resume={ckpt}',
                                   'DATASET.canvas_mode=image'],
                       'host data, whole image', Evaluator=counting_evaluator(calls))
    check([c['what'] for c in calls] == ['evaluate'], f'host data, whole image: {calls}')
    wev = calls[0]['evaluator']
    q = wev.ds.canvas_batch([0], canvas=wev.canvas)['canvas_scale'][0]
    check(not wev.crop_aware and q == np.float32(RES / HOST_MPII['image_size'][0]),
          f'host data, whole image: q {q}')
    expect_counts(calls[0]['counts'], 'host data, whole image',
                  **{k: nval * v for k, v in per_val.items()})
    paths['host_whole_image'] = calls[0]['counts']
    whole = calls[0]['out']
    check(np.isfinite(whole).all(), f'host data, whole image: {whole}')

    # COCO files: the trainer CLI, then evaluate_only (DARK, EVAL.official)
    runs, calls = [], []
    coco_dir = str(Path(tmp, 'coco_run'))
    coco_s = run_main(coco_cfg + ['TRAIN.epochs=1', f'TRAIN.steps_per_epoch={HOST_COCO_STEPS}',
                                  f'COMMON.checkpoint_dir={coco_dir}'],
                      'host data, coco trainer', Trainer=counting_trainer(runs))
    (ct,) = runs
    cval = len(ct.val_loader)
    check(ct.num_classes == 17 and ct.steps_per_epoch == HOST_COCO_STEPS
          and len(ct.val_ds) == HOST_COCO['n_persons'],
          f'host data, coco trainer: {ct.num_classes} joints, {ct.steps_per_epoch} steps')
    host_epochs('host coco trainer', ct, HOST_COCO_STEPS, paths, per_step, per_val)
    cckpt = next(Path(coco_dir).glob('*/ckpts')) / 'checkpoint_1'
    run_main(coco_cfg + [f'COMMON.checkpoint_dir={coco_dir}', 'COMMON.evaluate_only=True',
                         f'COMMON.resume={cckpt}', 'EVAL.official=True'],
             'host data, coco evaluator', Evaluator=counting_evaluator(calls))
    check([c['what'] for c in calls] == ['evaluate', 'predict_keypoints', 'evaluate_official'],
          f"host data, coco evaluator: calls {[c['what'] for c in calls]}")
    cev = calls[0]['evaluator']
    check(cev.cfg.eval.decode == 'dark', f'host data, coco: decode {cev.cfg.eval.decode}')
    expect_counts(calls[1]['counts'], 'host data, coco predict_keypoints (DARK)',
                  **{k: cval * v for k, v in per_predict.items()})
    paths['host_coco_evaluate'], paths['host_coco_predict'] = calls[0]['counts'], calls[1]['counts']
    oks = calls[2]['out']
    rows = json.loads(Path(oks.pop('results_file')).read_text())
    check(len(rows) == len(cev.ds) == HOST_COCO['n_persons']
          and [r['image_id'] for r in rows] == cev.ds.image_ids.tolist()
          and all(len(r['keypoints']) == 3 * 17 for r in rows),
          f'host data, coco results file: {len(rows)} rows')
    check(oks.keys() == {'AR', 'AR50', 'AR75', 'mean_oks'} and all(np.isfinite(v) for v in oks.values()),
          f'host data, coco OKS {oks}')

    # is a file-fed epoch host-bound? the producer's seconds against the epoch's
    epoch = tr.counts[-1]
    out = dict(card=card, loader=loader, trees_s=trees_s, timings=timings, cv2_vs_warp_region=worst,
               host_vs_device_crops=crops, slots=mpii_slots, device_pipeline_warps=2 * (HOST_STEPS + nval),
               mpii_train_s=train_s, mpii_eval_s=eval_s, host_pipeline_s=host_s, whole_image_s=whole_s,
               coco_train_s=coco_s, pckh=table, mpii_val=(last['val_loss'], last['val_acc']),
               host_pipeline_val=(host_last['val_loss'], host_last['val_acc']),
               whole_image_val=whole, coco_oks=oks,
               producer_s_per_epoch=epoch['train_produce_s'], epoch_train_s=epoch['train_s'],
               host_pipeline_producer_s=hp.counts[-1]['train_produce_s'],
               host_pipeline_epoch_train_s=hp.counts[-1]['train_s'])
    print('host data: ' + json.dumps(out), flush=True)
    return out

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

    runs = []
    CountingTrainer = counting_trainer(runs)

    run_s = run_main([str(REPO / 'configs' / 'train_mpii_8stack.yaml')] + MSPN_OVERRIDES
                     + MSPN_TRAINER + [f'COMMON.checkpoint_dir={tmp}'], 'mspn trainer',
                     Trainer=CountingTrainer)
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

    main_s = run_main([str(REPO / 'configs' / 'train_mpii_8stack.yaml')] + MSPN_OVERRIDES
                      + MSPN_TRAINER + [f'COMMON.checkpoint_dir={tmp}',
                                        'COMMON.evaluate_only=True', 'EVAL.official=True',
                                        f'COMMON.resume={trainer["checkpoint"]}'],
                      'mspn evaluator', Evaluator=CountingEvaluator)
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


def p50_ms(fn, x, runs: int = 10, warmup: int = 3) -> float:
    """Median wall time of fn(x) ending in a synchronize, in ms."""
    import torch
    ts = []
    for i in range(warmup + runs):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts[warmup:])[runs // 2] * 1e3


def same_bits(got, ref) -> bool:
    import torch
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def export_config(*overrides):
    """The flagship config with the export phase's EVAL keys and `overrides`."""
    from hourglass_pose_estimation_torch.config import load_config
    return load_config(str(REPO / 'configs' / 'train_mpii_8stack.yaml'),
                       overrides=EXPORT_OVERRIDES + list(overrides))


def checkpoint_function(cfg, ckpt: str):
    """(model, its state from `ckpt`, the graph options) of a config, as the
    export CLI reads them."""
    import torch
    from hourglass_pose_estimation_torch.data import get_meanstd, resolve_num_classes
    from hourglass_pose_estimation_torch.models import model_from_config
    from hourglass_pose_estimation_torch.runner.checkpoint import restore_params
    model = model_from_config(cfg.model, num_classes=resolve_num_classes(cfg),
                              out_res=cfg.dataset.out_res)
    return model, restore_params(ckpt, 'cuda'), dict(
        decode=cfg.eval.decode, fold_bn=cfg.eval.export_fold_bn,
        weights_dtype=torch.bfloat16, preprocess=get_meanstd(cfg.dataset.name),
        input_res=cfg.dataset.inp_res)


def reference_fn(cfg, ckpt: str):
    """make_inference_fn of a config's export options on a checkpoint: the
    in-process function the exported program is held to."""
    from hourglass_pose_estimation_torch.export import make_inference_fn
    model, state, kw = checkpoint_function(cfg, ckpt)
    return make_inference_fn(model, state, **kw)


def run_export_cli(cfg_overrides, out_dir: Path):
    """The export CLI on the flagship config -> (program path, seconds)."""
    from hourglass_pose_estimation_torch.export.__main__ import main as export_main
    t0 = time.perf_counter()
    check(export_main([str(REPO / 'configs' / 'train_mpii_8stack.yaml'), *EXPORT_OVERRIDES,
                       *cfg_overrides, f'COMMON.checkpoint_dir={out_dir}']) == 0,
          'export CLI failed')
    path = out_dir / 'export' / 'model.pt2'
    check(path.is_file(), f'export CLI wrote no {path}')
    return path, time.perf_counter() - t0


def artifact_child(path: str, frames_path: str, out_path: str) -> None:
    """In a fresh process: load the program (`load_serving_artifact`), run
    it once on the saved frames after a warm-up, and save its outputs;
    prints one JSON line: load seconds and the run's launches."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO))
    from hourglass_pose_estimation_torch.serving import load_serving_artifact
    t0 = time.perf_counter()
    fn, batch, shape, dtype = load_serving_artifact(path)
    load_s = time.perf_counter() - t0
    frames = np.load(frames_path)
    fn(frames)
    torch.cuda.synchronize()
    zero_counts()
    kps, maxv = fn(frames)
    torch.cuda.synchronize()
    np.savez(out_path, kps=kps.cpu().numpy(), maxv=maxv.cpu().numpy())
    print(json.dumps(dict(load_s=load_s, batch=batch, shape=list(shape), dtype=str(dtype),
                          launches=read_counts())), flush=True)


def export_phase(tmp: str, ckpt: str, seed: int, paths: dict) -> dict:
    """Export and the serving tools on the trainer phase's checkpoint_3: the
    export CLI writes the flagship serving program (batch 64, uint8 256^2
    frames, quarter decode, folded BN, bf16 weights); a fresh process and
    this one load it (`load_serving_artifact`), each held bit-equal to
    make_inference_fn on the same seeded frames with its launches per call
    exact (65/32/33/1); served over HTTP (every reply equal to the direct
    call's); a batch-1 program (`export_program`) for batch-1 latency and
    serving_demo's sync, async and sustained modes on seeded JPEGs;
    profile_step and step_cost once on the batch-64 program."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch import serving_demo
    from hourglass_pose_estimation_torch.data import fabricate
    from hourglass_pose_estimation_torch.export import export_program
    from hourglass_pose_estimation_torch.serving import load_serving_artifact
    from hourglass_pose_estimation_torch.utils.summary import profile_step, step_cost
    out_dir = Path(tmp) / 'export_hg'
    path, export_s = run_export_cli([f'COMMON.resume={ckpt}'], out_dir)
    cfg = export_config(f'COMMON.resume={ckpt}')
    ref_fn = reference_fn(cfg, ckpt)
    frames = client_frames(seed + 21, BATCH)
    ref = ref_fn(frames)

    # a fresh process: nothing of the program was built there
    np.save(out_dir / 'frames.npy', frames)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-c',
                        f'import chip_smoke; chip_smoke.artifact_child({str(path)!r}, '
                        f'{str(out_dir / "frames.npy")!r}, {str(out_dir / "child.npz")!r})'],
                       cwd=REPO, capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    check(r.returncode == 0, f'export: the fresh process failed:\n{r.stdout[-3000:]}\n'
          f'{r.stderr[-3000:]}')
    child = json.loads(r.stdout.strip().splitlines()[-1])
    got = np.load(out_dir / 'child.npz')
    child_equal = bool(np.array_equal(got['kps'], ref[0].cpu().numpy())
                       and np.array_equal(got['maxv'], ref[1].cpu().numpy()))
    want = {fused_name(): 65, 'upsample2x_add': 32, 'maxpool2x2_fwd': 33, 'decode_peaks': 1}
    expect_counts(child['launches'], 'export: the fresh process, one call', **want)
    check(child['batch'] == BATCH and child['shape'] == [RES, RES, 3]
          and child['dtype'] == 'uint8', f'export: the fresh process read {child}')
    check(child_equal, 'export: the fresh process differs from make_inference_fn')

    # this process
    t0 = time.perf_counter()
    fn, batch, shape, dtype = load_serving_artifact(str(path))
    load_s = time.perf_counter() - t0
    check(batch == BATCH and shape == (RES, RES, 3) and dtype == np.uint8,
          f'export: load_serving_artifact read batch {batch}, frames {shape} {dtype}')
    fn(frames)
    torch.cuda.synchronize()
    zero_counts()
    got = fn(frames)
    torch.cuda.synchronize()
    paths['export'] = launches = read_counts()
    expect_counts(launches, 'export: the program, one call', **want)
    check(same_bits(got, ref), 'export: the program differs from make_inference_fn')

    # served over HTTP: every reply is what the program's call on the batch
    # that held its frame gave for that frame (a frame's row may depend on
    # its place in the batch, which the batcher chooses)
    rows = {}

    def recorded(frames_in):
        out = fn(frames_in)
        k, m = (t.double().cpu() for t in out)
        for i, f in enumerate(frames_in):
            rows[f.tobytes()] = (k[i].tolist(), m[i].tolist())
        return out

    zero_counts()
    replies, serve_s, stats, batcher = serve_load(recorded, seed + 22, N_REQUESTS)
    paths['export_serve'] = served = read_counts()
    nb = batcher.n_batches
    expect_counts(served, f'export: serving the program, {nb} batches',
                  **{k: v * nb for k, v in want.items()})
    sent = np.concatenate([client_frames(seed + 23 + i, N_REQUESTS // CLIENT_PROCS)
                           for i in range(CLIENT_PROCS)])
    for i, rep in enumerate(replies):
        check((rep['keypoints'], rep['scores']) == rows[sent[i].tobytes()],
              f'export: reply {i} differs from the direct call')

    # latency: the program against the in-process function, batch 64 and 1
    path1 = str(out_dir / 'model_b1.pt2')
    t0 = time.perf_counter()
    model, state, kw = checkpoint_function(cfg, ckpt)
    export_program(model, state, (1, RES, RES, 3), path1, **kw)
    export1_s = time.perf_counter() - t0
    fn1 = load_serving_artifact(path1)[0]
    check(same_bits(fn1(frames[:1]), ref_fn(frames[:1])), 'export: the batch-1 program differs')
    # in turns (program, function, function, program): the host's spread is
    # as wide as the gap; each reading the mean of its two turns
    lat = {}
    for name, f, x in (('program_batch', fn, frames), ('fn_batch', ref_fn, frames),
                       ('fn_batch', ref_fn, frames), ('program_batch', fn, frames),
                       ('program_batch1', fn1, frames[:1]), ('fn_batch1', ref_fn, frames[:1]),
                       ('fn_batch1', ref_fn, frames[:1]), ('program_batch1', fn1, frames[:1])):
        lat.setdefault(name + '_ms_p50s', []).append(p50_ms(f, x))
    lat.update({k[:-1]: sum(v) / len(v) for k, v in list(lat.items())})

    # serving_demo on seeded JPEGs through the batch-1 program
    import cv2
    demo = Path(tmp) / 'demo'
    demo.mkdir()
    rng = np.random.RandomState(seed + 24)
    for i in range(DEMO_JPEGS):
        cv2.imwrite(str(demo / f'{i}.jpg'), fabricate.smooth_image(rng, *DEMO_FRAME))
    common = ['--raw', '--res', str(RES), '--dataset', 'mpii']
    t0 = time.perf_counter()
    check(serving_demo.main(['sync', path1, str(demo / '0.jpg'), '--iters', '10',
                             '--out', str(Path(tmp) / 'demo_sync.jpg'), *common]) == 0,
          'serving_demo sync failed')
    check(serving_demo.MODES['async'](serving_demo.parse_args(
        ['async', path1, str(demo), str(Path(tmp) / 'demo_out'), *common]), fn1) == 0,
        'serving_demo async failed')
    check(serving_demo.MODES['sustained'](serving_demo.parse_args(
        ['sustained', path1, str(demo / '1.jpg'), '--iters', '20', *common]), fn1) == 0,
        'serving_demo sustained failed')
    check(len(list((Path(tmp) / 'demo_out').iterdir())) == DEMO_JPEGS,
          'serving_demo async: drawn frames missing')
    demo_s = time.perf_counter() - t0

    trace = profile_step(fn, frames, trace_dir=str(Path(tmp) / 'trace'))
    cost = step_cost(fn, frames)
    check((Path(trace) / 'trace.json').stat().st_size > 0 and cost['flops'] > 0,
          f'export: profile_step / step_cost: {cost}')
    out = dict(export_s=export_s, export_batch1_s=export1_s, load_s=load_s,
               fresh_process_load_s=child['load_s'], fresh_process_s=child_s,
               size_mb=path.stat().st_size / 1e6, served_images_per_s=N_REQUESTS / serve_s,
               served_batches=nb, served_batch_ms_p50=stats['batch_latency_ms_p50'],
               demo_s=demo_s, step_cost_gflops=cost['flops'] / 1e9, **lat)
    print('export: ' + json.dumps(out), flush=True)
    return out


def mspn_export_phase(tmp: str, ckpt: str, seed: int, paths: dict) -> dict:
    """The MSPN trainer's checkpoint_2 (2 stages, full width) through the
    export CLI, loaded in this process and held bit-equal to
    make_inference_fn on seeded frames, 1 decode launch a call and no other."""
    import numpy as np
    import torch
    from hourglass_pose_estimation_torch.serving import load_serving_artifact
    path, export_s = run_export_cli(MSPN_OVERRIDES + [f'COMMON.resume={ckpt}'],
                                    Path(tmp) / 'export_mspn')
    cfg = export_config(*MSPN_OVERRIDES, f'COMMON.resume={ckpt}')
    frames = client_frames(seed + 25, BATCH)
    ref = reference_fn(cfg, ckpt)(frames)
    t0 = time.perf_counter()
    fn, batch, shape, dtype = load_serving_artifact(str(path))
    load_s = time.perf_counter() - t0
    check(batch == BATCH and shape == (RES, RES, 3) and dtype == np.uint8,
          f'mspn export: read batch {batch}, frames {shape} {dtype}')
    fn(frames)
    torch.cuda.synchronize()
    zero_counts()
    got = fn(frames)
    torch.cuda.synchronize()
    paths['mspn_export'] = launches = read_counts()
    expect_counts(launches, 'mspn export: the program, one call', decode_peaks=1)
    check(same_bits(got, ref), 'mspn export: the program differs from make_inference_fn')
    ref_fn = reference_fn(cfg, ckpt)
    out = dict(export_s=export_s, load_s=load_s, size_mb=path.stat().st_size / 1e6,
               program_batch_ms_p50=p50_ms(fn, frames), fn_batch_ms_p50=p50_ms(ref_fn, frames))
    print('mspn export: ' + json.dumps(out), flush=True)
    return out


def eval_launches() -> dict:
    """Launches of one flagship eval forward (running-average BN: the fused
    bottleneck, DEFAULT_IMPL) and its target render."""
    return {fused_name(): 65, 'upsample2x_add': 32, 'maxpool2x2_fwd': 33, 'render_gaussian': 1}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def bn_stats(model):
    """Every BatchNorm's running mean and variance, as one vector."""
    import torch
    from hourglass_pose_estimation_torch.models.norm import BatchNorm
    return torch.cat([t.detach().float().reshape(-1) for m in model.modules()
                      if isinstance(m, BatchNorm) for t in (m.running_mean, m.running_var)])


def grads_of(model) -> dict:
    return {n: p.grad.detach().float().cpu().clone() for n, p in model.named_parameters()}


def dict_rel_l2(got: dict, ref: dict) -> float:
    """Relative L2 of `got`'s tensors against `ref`'s, over all of them."""
    num = sum(float((got[n].double() - t.double()).square().sum()) for n, t in ref.items())
    return (num / sum(float(t.double().square().sum()) for t in ref.values())) ** 0.5


def timed_steps(step, state, raw, seed: int, n: int):
    """n steps -> (state, the loss of each, the seconds of each); each ends
    in a host read of its loss, which waits for the step."""
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, raw, seed)
        losses.append(float(m['loss']))
        times.append(time.perf_counter() - t0)
    return state, losses, times


def p50(times) -> float:
    return sorted(times)[len(times) // 2] * 1e3


def dp_world1_phase(seed: int, raw, spec, paths: dict) -> dict:
    """(a) The flagship train step under DDP over NCCL at world size 1 (a
    process group of this process alone): one step from the same weights
    and draws as the one-process step, held equal (the loss and every
    gradient), then both timed in turns."""
    import os
    import torch
    import torch.distributed as dist
    from hourglass_pose_estimation_torch.parallel import (
        make_mesh, maybe_initialize_distributed, sync_batch_norm)
    from hourglass_pose_estimation_torch.runner import init_state, make_optimizer, make_train_step
    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check(maybe_initialize_distributed('cuda', verbose=False) == (0, 1)
              and dist.get_backend() == 'nccl', 'dp world 1: no NCCL group of one rank')
        tx = make_optimizer(*OPT)
        model = sync_batch_norm(flagship_model(seed))       # as the Trainer builds it
        plain, ddp = init_state(copy.deepcopy(model), tx), init_state(model, tx)
        step_plain, step_ddp = make_train_step(spec), make_train_step(spec, mesh=make_mesh())
        zero_counts()
        ddp, m_ddp = step_ddp(ddp, raw, seed)
        loss_ddp = float(m_ddp['loss'])
        paths['dp_world1'] = counts = read_counts()
        plain, m_plain = step_plain(plain, raw, seed)
        loss_plain = float(m_plain['loss'])
        d_loss = abs(loss_ddp - loss_plain) / abs(loss_plain)
        g_all, g_leaf, g_name = grad_rel_l2(ddp.model, plain.model)
        expect_counts(counts, 'dp world 1: DDP step', **TRAIN_LAUNCHES)
        times = {'plain': [], 'ddp': []}
        for i in range(DP_WORLD1_WARMUP + DP_WORLD1_TIMED):
            for name in (('plain', 'ddp') if i % 2 else ('ddp', 'plain')):
                st, fn = (plain, step_plain) if name == 'plain' else (ddp, step_ddp)
                _, _, t = timed_steps(fn, st, raw, seed, 1)
                if i >= DP_WORLD1_WARMUP:
                    times[name] += t
        out = dict(batch=len(raw['canvas']), loss_ddp=loss_ddp, loss_plain=loss_plain,
                   loss_rel=d_loss, grad_rel_l2=g_all, worst_leaf=g_name, worst_leaf_rel_l2=g_leaf,
                   ddp_step_ms_p50=p50(times['ddp']), plain_step_ms_p50=p50(times['plain']),
                   ddp_step_ms=[t * 1e3 for t in times['ddp']],
                   plain_step_ms=[t * 1e3 for t in times['plain']])
        out['ddp_overhead_ms'] = out['ddp_step_ms_p50'] - out['plain_step_ms_p50']
        print('dp world 1 (NCCL): ' + json.dumps(out), flush=True)
        check(d_loss <= TOL_DP_WORLD1, f'dp world 1: loss DDP vs one process rel {d_loss:.3e}')
        check(g_all <= TOL_DP_WORLD1, f'dp world 1: gradients DDP vs one process {g_all:.3e}')
        return out
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_rank(work: str, seed: int) -> int:
    """One of the DP_RANKS ranks of the data-parallel phase, in a process of
    its own on cuda:0 over gloo: its first use of the kernels builds them
    into a fresh directory while the other rank does the same; DP_STEPS
    implicit (DDP, sync BN) steps on its rows of the global batch, then
    DP_EXPLICIT_STEPS explicit steps with sync_bn off from the same weights,
    one implicit step in f32, then the trainer CLI (one epoch, then a
    resume to epoch 2). Writes
    `<work>/rank<r>.json` (and its parameters and statistics)."""
    import os
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from hourglass_pose_estimation_torch.ops.hopper import _build
    from hourglass_pose_estimation_torch.parallel import (
        make_mesh, make_shard_map_train_step, maybe_initialize_distributed, sync_batch_norm)
    from hourglass_pose_estimation_torch.runner import init_state, make_optimizer, make_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(work)
    rank = int(os.environ['RANK'])
    _build.BUILD_DIR = work / 'kernels'
    t0 = time.time()
    lib = _build.library()
    out = dict(rank=rank, build_s=time.time() - t0, library=Path(lib._name).name)
    maybe_initialize_distributed(DP_DEVICE, backend='gloo', timeout=DP_TIMEOUT_S, verbose=False)
    mesh = make_mesh(0, 1, DP_DEVICE)
    raw, spec = train_data(DP_GLOBAL_BATCH)
    b = DP_GLOBAL_BATCH // DP_RANKS
    mine = {k: v[rank * b:(rank + 1) * b] for k, v in raw.items()}
    tx = make_optimizer(*DP_OPT)

    def run(what, step, state, n, stats_after=None, save_grads=False):
        """n steps; the BatchNorm statistics after step `stats_after` saved,
        and with `save_grads` rank 0's (averaged) gradients of step 1."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, times = [], []
        for i in range(n):
            state, l, t = timed_steps(step, state, mine, seed, 1)
            losses += l
            times += t
            if i + 1 == stats_after:
                torch.save(bn_stats(state.model).cpu(), work / f'stats_{what}{rank}.pt')
            if i == 0 and rank == 0 and save_grads:
                torch.save(grads_of(state.model), work / f'grads_{what}.pt')
        counts = read_counts()
        expect_counts(counts, f'dp rank {rank}: {n} {what} steps',
                      **{k: v * n for k, v in TRAIN_LAUNCHES.items()})
        check(all(abs(v) < float('inf') for v in losses), f'dp rank {rank} {what}: {losses}')
        out[what] = dict(losses=losses, step_ms=[t * 1e3 for t in times], step_ms_p50=p50(times),
                         global_images_per_s=DP_GLOBAL_BATCH / p50(times) * 1e3,
                         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         launches=counts)
        return state

    state = init_state(sync_batch_norm(flagship_model(seed)), tx)
    state = run('implicit', make_train_step(spec, mesh=mesh), state, DP_STEPS,
                stats_after=DP_EXPLICIT_STEPS, save_grads=True)
    if rank == 0:
        torch.save({n: p.detach().cpu() for n, p in state.model.named_parameters()},
                   work / 'implicit_params.pt')
    del state
    torch.cuda.empty_cache()
    state = init_state(flagship_model(seed), tx)
    state = run('explicit', make_shard_map_train_step(spec, mesh, sync_bn=False), state,
                DP_EXPLICIT_STEPS, stats_after=DP_EXPLICIT_STEPS)
    del state
    torch.cuda.empty_cache()
    state = init_state(sync_batch_norm(flagship_model(seed, dtype=torch.float32)), tx)
    state = run('f32', make_train_step(spec, mesh=mesh), state, 1, save_grads=True)
    del state
    torch.cuda.empty_cache()

    runs = []
    argv = [str(REPO / 'configs' / 'train_mpii_8stack.yaml')] + DP_TRAINER + [
        f'COMMON.checkpoint_dir={work / "trainer"}']
    flags = ['--device', DP_DEVICE, '--backend', 'gloo']
    trainer = counting_trainer(runs)
    out['trainer_s'] = run_main(argv + flags, f'dp rank {rank} trainer', Trainer=trainer)
    ckpts = next((work / 'trainer').glob('*/ckpts'))
    out['written'] = sorted(p.name for p in ckpts.iterdir())
    out['resumed_s'] = run_main(
        argv + ['TRAIN.epochs=2', f'COMMON.resume={ckpts / "checkpoint_1"}'] + flags,
        f'dp rank {rank} trainer, resumed', Trainer=trainer)
    out['trainer'] = [dict(history=r.history, counts=r.counts, resumed=r.resumed,
                           steps=r.steps_per_epoch, val_batches=len(r.val_loader)) for r in runs]
    (work / f'rank{rank}.json').write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def wait_ranks(procs, logs, timeout_s: float) -> None:
    """Wait for every rank; the first to fail, or the time limit, stops them
    all and fails the run with their logs' tails."""
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if not all(p.returncode == 0 for p in procs):
        fail('dp: a rank failed\n' + '\n'.join(
            f'--- rank {r} (exit {p.returncode})\n' + Path(log).read_text(errors='replace')[-4000:]
            for r, (p, log) in enumerate(zip(procs, logs))))


def one_process_steps(seed: int, raw, spec, steps: int, dtype=None, swap: bool = False):
    """`steps` one-process train steps (DP_OPT) on the global batch, each on
    the images its step's generator draws (the device pipeline's), with
    the batch's halves swapped when `swap` -> (the losses, the gradients
    of step 1, the parameters after, the parameters before; on the CPU)."""
    import torch
    from hourglass_pose_estimation_torch.data import augment_batch, sample_augmentations, to_device
    from hourglass_pose_estimation_torch.runner import init_state, make_optimizer, make_train_step
    from hourglass_pose_estimation_torch.runner.train_state import step_generator
    model = flagship_model(seed, **({'dtype': dtype} if dtype else {}))
    params = lambda: {n: p.detach().float().cpu().clone() for n, p in model.named_parameters()}
    start = params()
    dev = next(model.parameters()).device
    state = init_state(model, make_optimizer(*DP_OPT))
    step = make_train_step(spec, device_pipeline=False)
    data = to_device(raw, dev)
    losses, grads = [], None
    for s in range(steps):
        staged = augment_batch(data, sample_augmentations(
            step_generator(seed, s, dev), data['scale'], scale_factor=spec.scale_factor,
            rot_factor=spec.rot_factor, train=True), spec, True)
        batch = {k: staged[k].roll(DP_GLOBAL_BATCH // DP_RANKS, 0) if swap else staged[k]
                 for k in ('image', 'target', 'target_weight')}
        state, m = step(state, batch, seed)
        losses.append(float(m['loss']))
        if s == 0:
            grads = grads_of(model)
    return losses, grads, params(), start


def dp_ranks_phase(seed: int, paths: dict, tmp: str) -> dict:
    """(b) DP_RANKS ranks on this one card over gloo (NCCL refuses two ranks
    on one device), each in a process of its own (`dp_rank`), against the
    one-process step on the same global batch of DP_GLOBAL_BATCH, and (c)
    the trainer CLI on them."""
    import os
    import torch
    raw, spec = train_data(DP_GLOBAL_BATCH)
    # one process on the same global batch, and the same with the batch's
    # halves swapped (the same sums in another order: its own noise), in
    # bf16 for every step and in f32 (TF32 off) for step 1
    ref_losses, ref_grads, ref, start = one_process_steps(seed, raw, spec, DP_STEPS)
    sw_losses, sw_grads, sw, _ = one_process_steps(seed, raw, spec, DP_STEPS, swap=True)
    _, ref_grads_f32, _, _ = one_process_steps(seed, raw, spec, 1, dtype=torch.float32)
    _, sw_grads_f32, _, _ = one_process_steps(seed, raw, spec, 1, dtype=torch.float32, swap=True)
    torch.cuda.empty_cache()

    work = Path(tmp) / 'dp'
    work.mkdir()
    env = dict(os.environ, WORLD_SIZE=str(DP_RANKS), MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(free_port()))
    procs, logs = [], []
    t0 = time.time()
    for r in range(DP_RANKS):
        logs.append(work / f'rank{r}.log')
        with open(logs[-1], 'wb') as log:        # files, not pipes: a full pipe blocks a rank
            procs.append(subprocess.Popen(
                [sys.executable, '-c', f'import sys; import chip_smoke; '
                 f'sys.exit(chip_smoke.dp_rank({str(work)!r}, {seed}))'],
                cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT))
    wait_ranks(procs, logs, DP_TIMEOUT_S)
    ranks_s = time.time() - t0
    res = [json.loads((work / f'rank{r}.json').read_text()) for r in range(DP_RANKS)]

    # (b) every rank built and loaded the same library at once
    check(len({r['library'] for r in res}) == 1, f"dp: libraries {[r['library'] for r in res]}")
    # the implicit step: the ranks' losses are the global batch's, equal on
    # every rank, and the one process's within the gate
    losses = [r['implicit']['losses'] for r in res]
    check(all(l == losses[0] for l in losses), f'dp: the ranks report other losses: {losses}')
    loss_rel = lambda got: [abs(a - b) / abs(b) for a, b in zip(got, ref_losses)]
    moves = {n: p - start[n] for n, p in ref.items()}
    update_rel = lambda got: dict_rel_l2({n: p - start[n] for n, p in got.items()}, moves)
    grad_rel = dict_rel_l2(torch.load(work / 'grads_implicit.pt'), ref_grads)
    grad_rel_f32 = dict_rel_l2(torch.load(work / 'grads_f32.pt'), ref_grads_f32)
    sync = [torch.load(work / f'stats_implicit{r}.pt') for r in range(DP_RANKS)]
    local = [torch.load(work / f'stats_explicit{r}.pt') for r in range(DP_RANKS)]
    out = dict(global_batch=DP_GLOBAL_BATCH, ranks=DP_RANKS, ranks_s=ranks_s,
               build_s=[r['build_s'] for r in res], losses=losses[0], one_process_losses=ref_losses,
               loss_rel=loss_rel(losses[0]), loss_rel_halves_swapped=loss_rel(sw_losses),
               step1_grad_rel_l2=grad_rel,
               step1_grad_rel_l2_halves_swapped=dict_rel_l2(sw_grads, ref_grads),
               f32_step1_grad_rel_l2=grad_rel_f32,
               f32_step1_grad_rel_l2_halves_swapped=dict_rel_l2(sw_grads_f32, ref_grads_f32),
               update_rel_l2=update_rel(torch.load(work / 'implicit_params.pt')),
               update_rel_l2_halves_swapped=update_rel(sw),
               sync_stats_equal_across_ranks=bool(torch.equal(sync[0], sync[1])),
               local_stats_rel_across_ranks=float((local[0] - local[1]).norm() / local[1].norm()),
               local_vs_sync_stats_rel=float((local[0] - sync[0]).norm() / sync[0].norm()))
    for r in res:
        for what in ('implicit', 'explicit', 'f32'):
            print(f"dp rank {r['rank']} {what}: step ms p50 {r[what]['step_ms_p50']:.2f} "
                  f"(steps {[round(t, 2) for t in r[what]['step_ms']]}), global "
                  f"{r[what]['global_images_per_s']:.1f} img/s, peak "
                  f"{r[what]['max_memory_allocated_gib']:.2f} GiB, launches {r[what]['launches']}",
                  flush=True)
    print(f'dp {DP_RANKS} ranks (gloo, one card): ' + json.dumps(out) +
          f' (gates: loss {TOL_DP_LOSS}, update {TOL_DP_UPDATE}, f32 step-1 gradients '
          f'{TOL_DP_GRAD_F32})', flush=True)
    check(max(out['loss_rel']) <= TOL_DP_LOSS, f"dp: losses against one process {out['loss_rel']}")
    check(grad_rel_f32 <= TOL_DP_GRAD_F32,
          f'dp: f32 step-1 gradients against one process {grad_rel_f32:.3e}')
    check(out['update_rel_l2'] <= TOL_DP_UPDATE,
          f"dp: update against one process {out['update_rel_l2']:.3e}")
    check(out['sync_stats_equal_across_ranks'], 'dp: synced statistics differ across ranks')
    check(out['local_stats_rel_across_ranks'] > 0 and out['local_vs_sync_stats_rel'] > 0,
          f'dp: per-replica statistics equal to the synced or across ranks: {out}')

    # (c) the trainer on the ranks: one checkpoint written, the resume exact
    for r in res:
        first, resumed = r['trainer']
        check([h['epoch'] for h in first['history']] == [1]
              and [h['epoch'] for h in resumed['history']] == [2],
              f"dp rank {r['rank']} trainer: epochs {first['history']}, {resumed['history']}")
        check(r['written'] == ['best', 'checkpoint_1'] or r['written'] == ['checkpoint_1'],
              f"dp rank {r['rank']} trainer: written {r['written']}")
        res_ = resumed['resumed']
        check(res_['model_equal'] and res_['optimizer_equal'] and res_['step'] == first['steps']
              and res_['start_epoch'] == 1, f"dp rank {r['rank']} trainer resume: {res_}")
        for run in (first, resumed):
            steps, vb = run['steps'], run['val_batches']
            check(steps == DP_TRAINER_STEPS, f"dp rank {r['rank']} trainer: {steps} steps")
            c = run['counts'][0]
            expect_counts(c['train'], f"dp rank {r['rank']} trainer train",
                          **{k: v * steps for k, v in TRAIN_LAUNCHES.items()})
            expect_counts(c['val'], f"dp rank {r['rank']} trainer val",
                          **{k: v * vb for k, v in eval_launches().items()})
        h = first['history'][0]
        print(f"dp rank {r['rank']} trainer: epoch 1 {h['seconds']:.2f} s, train "
              f"{h['images_per_s']:.1f} img/s (every rank's rows), loss {h['train_loss']:.5f}, val "
              f"{h['val_loss']:.5f} / {h['val_acc']:.4f}; written {r['written']}; resumed at step "
              f"{res_['step']}, tensors equal to the file", flush=True)
        total = {}
        for what in ('implicit', 'explicit', 'f32'):
            for k, v in r[what]['launches'].items():
                total[k] = total.get(k, 0) + v
        for run in r['trainer']:
            for c in run['counts']:
                for k in c['train']:
                    total[k] += c['train'][k] + c['val'][k]
        paths[f"dp_rank{r['rank']}"] = total
    out['trainer'] = [dict(written=r['written'], history=r['trainer'][0]['history']) for r in res]
    return out


def pipeline_counting_trainer(runs: list):
    """`counting_trainer` for a pipeline Trainer: a resumed one compares its
    gathered, merged state (a collective of the pipe group) with the
    checkpoint's."""
    import torch
    base = counting_trainer(runs)

    class PipelineCounting(base):
        def _against_checkpoint(self, path: str) -> dict:
            saved = torch.load(path, map_location='cpu', weights_only=True)
            model, opt = self.state.checkpoint_state()

            def equal(a, b):
                if isinstance(a, dict):
                    return a.keys() == b.keys() and all(equal(v, b[k]) for k, v in a.items())
                if isinstance(a, list):
                    return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
                return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            return dict(start_epoch=self.start_epoch, step=self.state.step,
                        saved_step=saved['step'], model_tensors=len(model),
                        model_equal=equal(model, saved['model']),
                        optimizer_tensors=sum(len(st) for o in opt.values()
                                              for st in o['state'].values()),
                        optimizer_equal=equal(opt, saved['optimizer']))

    return PipelineCounting


def pp_stage(seed: int, mesh, dtype=None):
    """This rank's stage of the flagship: the stem and its stacks of the
    standard init (flagship_model's), the model's own modules
    (`pipeline.stage_of`, as the pipeline Trainer takes them)."""
    from hourglass_pose_estimation_torch.parallel.pipeline import PipelineState, stage_of
    from hourglass_pose_estimation_torch.runner import make_optimizer
    model = flagship_model(seed, device=mesh.device, **({'dtype': dtype} if dtype else {}))
    return PipelineState.create(*stage_of(model, mesh), make_optimizer(*DP_OPT), mesh,
                                PP_STACKS)


def pp_rank(work: str, seed: int) -> int:
    """One of the PP_RANKS stages of the pipeline phase, in a process of its
    own on cuda:0 over gloo, with the library phase 2 built (loaded, not
    built again): (a) the f32 parity steps on the batch the parent saved,
    (b) the bf16 timed steps, (c) the pipeline trainer CLI, its resume and
    evaluate_only of its checkpoint_1. Writes `<work>/rank<r>.json` and
    the parity gradients."""
    import os
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from hourglass_pose_estimation_torch.ops.hopper import _build
    from hourglass_pose_estimation_torch.parallel import make_mesh, maybe_initialize_distributed
    from hourglass_pose_estimation_torch.parallel.pipeline import (
        make_pipeline_train_step, make_pipeline_train_step_raw)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(work)
    rank = int(os.environ['RANK'])
    t0 = time.time()
    lib = _build.library()
    out = dict(rank=rank, load_s=time.time() - t0, library=Path(lib._name).name)
    maybe_initialize_distributed(DP_DEVICE, backend='gloo', timeout=PP_TIMEOUT_S, verbose=False)
    mesh = make_mesh(0, 1, DP_DEVICE, pipeline_parallel=PP_RANKS)
    out['stage'] = mesh.stage
    cpu = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}

    # (a) parity, f32
    batch = {k: v.to(mesh.device) for k, v in torch.load(work / 'batch.pt').items()}
    state = pp_stage(seed, mesh, torch.float32)
    for mode in ('eval', 'train'):
        step = make_pipeline_train_step(mesh, num_microbatches=PP_PARITY_M,
                                        train=mode == 'train', update=False)
        _, m = step(state, batch['image'], batch['target'], batch['target_weight'])
        out[f'{mode}_loss'] = float(m['loss'])
        torch.save({'stem': cpu(m['g_stem']), 'stacks': [cpu(g) for g in m['g_stack']]},
                   work / f'grads_{mode}{rank}.pt')
    del state, batch
    torch.cuda.empty_cache()

    # (b) the timed bf16 steps, the main path's launches
    raw, spec = train_data(PP_GLOBAL_BATCH)
    state = pp_stage(seed, mesh)
    step = make_pipeline_train_step_raw(spec, mesh, num_microbatches=PP_M)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times, handoff = [], [], []
    for _ in range(PP_WARMUP + PP_TIMED):
        t0 = time.perf_counter()
        state, m = step(state, raw, seed)
        losses.append(float(m['loss']))
        times.append(time.perf_counter() - t0)
        handoff.append(m['handoff_s'])
    counts = read_counts()
    n = PP_WARMUP + PP_TIMED
    expect_counts(counts, f'pp rank {rank}: {n} steps',
                  **{k: v * n for k, v in PP_LAUNCHES[mesh.stage].items()})
    check(all(abs(v) < float('inf') for v in losses), f'pp rank {rank}: losses {losses}')
    timed = times[PP_WARMUP:]
    out['timed'] = dict(losses=losses, step_ms=[t * 1e3 for t in times], step_ms_p50=p50(timed),
                        global_images_per_s=PP_GLOBAL_BATCH / p50(timed) * 1e3,
                        handoff_ms=[t * 1e3 for t in handoff],
                        handoff_ms_p50=p50(handoff[PP_WARMUP:]),
                        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                        launches=counts)
    del state
    torch.cuda.empty_cache()

    # (c) the trainer CLI, a pipeline resume, evaluate_only
    runs, calls = [], []
    argv = [str(REPO / 'configs' / 'train_mpii_8stack.yaml')] + PP_TRAINER + [
        f'COMMON.checkpoint_dir={work / "trainer"}']
    flags = ['--device', DP_DEVICE, '--backend', 'gloo']
    trainer = pipeline_counting_trainer(runs)
    out['trainer_s'] = run_main(argv + flags, f'pp rank {rank} trainer', Trainer=trainer)
    ckpts = next((work / 'trainer').glob('*/ckpts'))
    out['written'] = sorted(p.name for p in ckpts.iterdir())
    resume = f'COMMON.resume={ckpts / "checkpoint_1"}'
    out['resumed_s'] = run_main(argv + [resume] + flags, f'pp rank {rank} trainer, resumed',
                                Trainer=trainer)
    out['evaluate_only_s'] = run_main(
        argv + ['COMMON.evaluate_only=true', 'EVAL.official=true', resume] + flags,
        f'pp rank {rank} evaluate_only', Evaluator=counting_evaluator(calls))
    out['evaluate_only'] = {c['what']: dict(counts=c['counts'], s=c['s'],
                                            out=c['out'] if c['what'] == 'evaluate' else None)
                            for c in calls}
    out['trainer'] = [dict(history=r.history, counts=r.counts, resumed=r.resumed,
                           steps=r.steps_per_epoch, val_batches=len(r.val_loader)) for r in runs]
    (work / f'rank{rank}.json').write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def pp_ranks_phase(seed: int, paths: dict, tmp: str) -> dict:
    """19. Pipeline parallelism: the flagship's 8 stacks over PP_RANKS
    stages on this one card over gloo (`pp_rank`), against one process."""
    import os
    import torch
    from hourglass_pose_estimation_torch.data import augment_batch, sample_augmentations, to_device
    from hourglass_pose_estimation_torch.loss import heatmap_mse_loss
    from hourglass_pose_estimation_torch.parallel.pipeline import merge_hourglass_variables
    from hourglass_pose_estimation_torch.runner.train_state import step_generator
    work = Path(tmp) / 'pp'
    work.mkdir()
    # (a) one process on the parity batch: HourglassNet in f32, the eval-mode
    # loss and gradients, then the train-mode sequential oracle of the same
    # microbatch slices
    raw, spec = train_data(PP_PARITY_BATCH)
    model = flagship_model(seed, dtype=torch.float32)
    dev = next(model.parameters()).device
    data = to_device(raw, dev)
    data = augment_batch(data, sample_augmentations(
        step_generator(seed, 0, dev), data['scale'], scale_factor=spec.scale_factor,
        rot_factor=spec.rot_factor, train=True), spec, True)
    batch = {k: data[k] for k in ('image', 'target', 'target_weight')}
    torch.save({k: v.cpu() for k, v in batch.items()}, work / 'batch.pt')
    ref = {}
    mb = PP_PARITY_BATCH // PP_PARITY_M
    for mode in ('eval', 'train'):
        model.zero_grad(set_to_none=True)
        if mode == 'eval':
            loss = heatmap_mse_loss(model(batch['image'], train=False), batch['target'],
                                    batch['target_weight'])
        else:
            loss = sum(heatmap_mse_loss(model(batch['image'][sl], train=True),
                                        batch['target'][sl], batch['target_weight'][sl])
                       for sl in (slice(m * mb, (m + 1) * mb) for m in range(PP_PARITY_M)))
            loss = loss / PP_PARITY_M
        loss.backward()
        ref[mode] = (float(loss), grads_of(model))
    del model, data, batch
    torch.cuda.empty_cache()

    env = dict(os.environ, WORLD_SIZE=str(PP_RANKS), MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(free_port()))
    procs, logs = [], []
    t0 = time.time()
    for r in range(PP_RANKS):
        logs.append(work / f'rank{r}.log')
        with open(logs[-1], 'wb') as log:        # files, not pipes: a full pipe blocks a rank
            procs.append(subprocess.Popen(
                [sys.executable, '-c', f'import sys; import chip_smoke; '
                 f'sys.exit(chip_smoke.pp_rank({str(work)!r}, {seed}))'],
                cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT))
    wait_ranks(procs, logs, PP_TIMEOUT_S)
    ranks_s = time.time() - t0
    res = [json.loads((work / f'rank{r}.json').read_text()) for r in range(PP_RANKS)]
    check([r['stage'] for r in res] == list(range(PP_RANKS)), 'pp: stages')
    check(len({r['library'] for r in res}) == 1, f"pp: libraries {[r['library'] for r in res]}")

    # (a) the stages' loss and merged gradients against one process's
    parity = {}
    for mode in ('eval', 'train'):
        files = [torch.load(work / f'grads_{mode}{r}.pt') for r in range(PP_RANKS)]
        merged = merge_hourglass_variables(
            files[0]['stem'], [g for f in files for g in f['stacks']], PP_STACKS)
        loss, grads = ref[mode]
        losses = [r[f'{mode}_loss'] for r in res]
        check(all(v == losses[0] for v in losses), f'pp {mode}: the ranks report {losses}')
        parity[mode] = dict(loss=losses[0], one_process_loss=loss,
                            loss_rel=abs(losses[0] - loss) / abs(loss),
                            grad_rel_l2=dict_rel_l2(merged, grads),
                            stem_grads_equal_across_ranks=all(
                                torch.equal(files[0]['stem'][k], v)
                                for k, v in files[1]['stem'].items()))
    out = dict(ranks=PP_RANKS, stacks_per_stage=PP_STACKS // PP_RANKS, ranks_s=ranks_s,
               load_s=[r['load_s'] for r in res], parity=parity)
    print(f'pp {PP_RANKS} stages (gloo, one card), parity f32 at batch {PP_PARITY_BATCH} in '
          f'{PP_PARITY_M} microbatches: ' + json.dumps(parity) +
          f' (gates: loss {TOL_PP_LOSS}, gradients {TOL_PP_GRAD})', flush=True)
    for mode, p in parity.items():
        check(p['loss_rel'] <= TOL_PP_LOSS[mode], f"pp {mode}: loss rel {p['loss_rel']:.3e}")
        check(p['grad_rel_l2'] <= TOL_PP_GRAD[mode],
              f"pp {mode}: gradients rel L2 {p['grad_rel_l2']:.3e}")
        check(p['stem_grads_equal_across_ranks'], f'pp {mode}: stem gradients differ')

    # (b) the timed steps: the same losses on both stages, finite
    losses = [r['timed']['losses'] for r in res]
    check(all(l == losses[0] for l in losses), f'pp: the stages report other losses: {losses}')
    out['timed'] = {r['stage']: {k: v for k, v in r['timed'].items() if k != 'launches'}
                    for r in res}
    for r in res:
        t = r['timed']
        print(f"pp stage {r['stage']} (bf16, global batch {PP_GLOBAL_BATCH}, {PP_M} "
              f"microbatches): step ms p50 {t['step_ms_p50']:.2f} (steps "
              f"{[round(v, 2) for v in t['step_ms']]}), global {t['global_images_per_s']:.1f} "
              f"img/s, hand-off host ms p50 {t['handoff_ms_p50']:.2f}, peak "
              f"{t['max_memory_allocated_gib']:.2f} GiB, launches {t['launches']} "
              '(two ranks on one card: shared SMs, hand-offs through host memory)', flush=True)

    # (c) the trainer: rank 0 alone writes, the standard layout, the resume
    # exact, evaluate_only equal to the trainer's validation
    ckpt = torch.load(next((work / 'trainer').glob('*/ckpts')) / 'checkpoint_1',
                      map_location='cpu', weights_only=True)
    names = set(flagship_model(seed, device='cpu').state_dict())
    check(set(ckpt['model']) == names and set(ckpt['optimizer']) == {'stem', 'stack'},
          'pp trainer: checkpoint_1 is not in the standard layout')
    for r in res:
        first, resumed = r['trainer']
        check([h['epoch'] for h in first['history']] == [1] and resumed['history'] == [],
              f"pp stage {r['stage']} trainer: epochs {first['history']}, {resumed['history']}")
        check(r['written'] in (['best', 'checkpoint_1'], ['checkpoint_1']),
              f"pp stage {r['stage']} trainer: written {r['written']}")
        res_ = resumed['resumed']
        check(res_['model_equal'] and res_['optimizer_equal'] and res_['step'] == first['steps']
              and res_['start_epoch'] == 1, f"pp stage {r['stage']} trainer resume: {res_}")
        c = first['counts'][0]
        check(first['steps'] == DP_TRAINER_STEPS, f"pp stage {r['stage']}: {first['steps']} steps")
        expect_counts(c['train'], f"pp stage {r['stage']} trainer train",
                      **{k: v * first['steps'] for k, v in PP_LAUNCHES[r['stage']].items()})
        expect_counts(c['val'], f"pp stage {r['stage']} trainer val",
                      **{k: v * first['val_batches'] for k, v in eval_launches().items()})
        h = first['history'][0]
        ev = r['evaluate_only']
        e_loss, e_acc = ev['evaluate']['out']
        rel = dict(loss=abs(e_loss - h['val_loss']) / abs(h['val_loss']),
                   pck=abs(e_acc - h['val_acc']))
        print(f"pp stage {r['stage']} trainer: epoch 1 {h['seconds']:.2f} s, train "
              f"{h['images_per_s']:.1f} img/s, loss {h['train_loss']:.5f}, val {h['val_loss']:.5f}"
              f" / {h['val_acc']:.4f}; written {r['written']}; resumed at step {res_['step']}, "
              f"tensors equal to the file; evaluate_only {e_loss:.5f} / {e_acc:.4f} (apart "
              f"{rel}) in {r['evaluate_only_s']:.1f} s", flush=True)
        check(rel['loss'] <= TOL_PP_EVALUATE_ONLY and rel['pck'] <= TOL_PP_EVALUATE_ONLY,
              f"pp stage {r['stage']}: evaluate_only against the trainer's validation {rel}")
        total = dict(r['timed']['launches'])
        for k in total:
            total[k] += c['train'][k] + c['val'][k] + sum(
                e['counts'][k] for w, e in ev.items() if w != 'evaluate_official')
        paths[f"pp_stage{r['stage']}"] = total
    out['trainer'] = [dict(written=r['written'], history=r['trainer'][0]['history'],
                           evaluate_only=r['evaluate_only']['evaluate']['out']) for r in res]
    return out


def overlap_phase(seed: int, raw, spec, paths: dict) -> dict:
    """20. The overlapped train step (`make_overlapped_train_step`) on the
    flagship at batch 64: the prime, OVERLAP_STEPS overlapped steps and the
    drain against the sequential step from the same weights, then both
    timed in turns."""
    import torch
    from hourglass_pose_estimation_torch.runner import init_state, make_optimizer, make_train_step
    from hourglass_pose_estimation_torch.runner.train_state import (
        STAGED_KEYS, make_overlapped_train_step, make_stage_fn)
    tx = make_optimizer(*OPT)
    model = flagship_model(seed)
    seq_state, state = init_state(copy.deepcopy(model), tx), init_state(model, tx)
    seq = make_train_step(spec)
    stage = make_stage_fn(spec, device=next(model.parameters()).device)
    ostep, drain = make_overlapped_train_step(spec), make_train_step(spec, device_pipeline=False)
    n = OVERLAP_STEPS + 1
    seq_losses = [float(seq(seq_state, raw, seed)[1]['loss']) for _ in range(n)]
    zero_counts()
    staged = stage(raw, seed, state.step)
    kept, losses = [{k: v.clone() for k, v in staged.items()}], []
    for _ in range(OVERLAP_STEPS):
        state, staged, m = ostep(state, staged, raw, seed)
        losses.append(float(m['loss']))
        kept.append({k: v.clone() for k, v in staged.items()})
    state, m = drain(state, staged, seed)
    losses.append(float(m['loss']))
    paths['overlap'] = counts = read_counts()
    # n steps; n renders: the prime's and each overlapped step's staging
    expect_counts(counts, f'overlapped: prime, {OVERLAP_STEPS} steps, drain',
                  **{k: v * n for k, v in TRAIN_LAUNCHES.items()})
    equal = [all(torch.equal(st[k], ref[k]) for k in STAGED_KEYS)
             for st, ref in zip(kept, (stage(raw, seed, i) for i in range(n)))]
    del kept
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, seq_losses)]

    times = {'sequential': [], 'overlapped': []}
    staged = stage(raw, seed, state.step)
    for i in range(OVERLAP_WARMUP + OVERLAP_TIMED):
        for name in (('sequential', 'overlapped') if i % 2 else ('overlapped', 'sequential')):
            t0 = time.perf_counter()
            if name == 'sequential':
                seq_state, m = seq(seq_state, raw, seed)
            else:
                state, staged, m = ostep(state, staged, raw, seed)
            float(m['loss'])                              # waits for the step
            if i >= OVERLAP_WARMUP:
                times[name].append(time.perf_counter() - t0)
    out = dict(batch=len(raw['canvas']), staged_equal=equal, losses=losses,
               sequential_losses=seq_losses, loss_rel=rel,
               overlapped_step_ms_p50=p50(times['overlapped']),
               sequential_step_ms_p50=p50(times['sequential']),
               overlapped_step_ms=[t * 1e3 for t in times['overlapped']],
               sequential_step_ms=[t * 1e3 for t in times['sequential']])
    out['overlapped_images_per_s'] = out['batch'] / out['overlapped_step_ms_p50'] * 1e3
    out['sequential_images_per_s'] = out['batch'] / out['sequential_step_ms_p50'] * 1e3
    print('overlapped step: ' + json.dumps(out) + f' (gate: every loss {TOL_OVERLAP_LOSS}; '
          f'launches {counts})', flush=True)
    check(all(equal), f'overlapped: staged batches equal to the sequential ones: {equal}')
    check(all(v == v and abs(v) < float('inf') for v in losses), f'overlapped: {losses}')
    check(max(rel) <= TOL_OVERLAP_LOSS, f'overlapped: losses rel {rel}')
    return out


def tp_counting_trainer(runs: list):
    """`counting_trainer` for a tensor-parallel Trainer: a resumed one
    compares its gathered state (a collective of the model group) with the
    checkpoint's and counts the leaves that hold a shard."""
    import torch
    base = counting_trainer(runs)

    class TensorParallelCounting(base):
        def _against_checkpoint(self, path: str) -> dict:
            saved = torch.load(path, map_location='cpu', weights_only=True)
            model, opt = self.state.checkpoint_state()
            full = {k: v.shape for k, v in self.state.standard.state_dict().items()}
            sopt = saved['optimizer']['state']
            return dict(
                start_epoch=self.start_epoch, step=self.state.step, saved_step=saved['step'],
                model_tensors=len(model),
                model_equal=model.keys() == saved['model'].keys() and all(
                    torch.equal(v, saved['model'][k]) for k, v in model.items()),
                optimizer_tensors=sum(len(st) for st in opt['state'].values()),
                optimizer_equal=len(opt['state']) == len(sopt) > 0 and all(
                    torch.equal(v, sopt[i][k]) for i, st in opt['state'].items()
                    for k, v in st.items()),
                sharded_leaves=sum(1 for k, v in self.state.model.state_dict().items()
                                   if v.shape != full[k]))

    return TensorParallelCounting


def tp_rank(work: str, seed: int) -> int:
    """One of the TP_RANKS model ranks of the tensor-parallel phase, in a
    process of its own on cuda:0 over gloo, with the library phase 2 built
    (loaded, not built again): (a) the f32 parity steps on the batch the parent saved, (b)
    the bf16 timed steps and a frozen-BN step, (c) the trainer CLI, its
    resume and evaluate_only of its checkpoint_1. Writes
    `<work>/rank<r>.json` and the parity tensors."""
    import os
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from hourglass_pose_estimation_torch.ops.hopper import _build
    from hourglass_pose_estimation_torch.parallel import (
        ShardedTrainState, gather_params, make_mesh, maybe_initialize_distributed,
        sync_batch_norm)
    from hourglass_pose_estimation_torch.runner import make_optimizer, make_train_step
    from hourglass_pose_estimation_torch.utils import tracing
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(work)
    rank = int(os.environ['RANK'])
    t0 = time.time()
    lib = _build.library()
    out = dict(rank=rank, load_s=time.time() - t0, library=Path(lib._name).name)
    maybe_initialize_distributed(DP_DEVICE, backend='gloo', timeout=TP_TIMEOUT_S, verbose=False)
    mesh = make_mesh(1, TP_RANKS, DP_DEVICE)
    out['model_rank'] = mesh.model_rank

    def sharded_state(dtype=None):
        model = flagship_model(seed, device=mesh.device, **({'dtype': dtype} if dtype else {}))
        sync_batch_norm(model, global_rows=True, group=mesh.group)
        return ShardedTrainState.create(model, make_optimizer(*DP_OPT), mesh)

    # (a) parity, f32
    batch = {k: v.to(mesh.device) for k, v in torch.load(work / 'batch.pt').items()}
    cpu = lambda d: {k: v.detach().float().cpu().clone() for k, v in d.items()}
    for mode in ('eval', 'train'):
        state = sharded_state(torch.float32)
        shapes = {k: v.shape for k, v in state.standard.state_dict().items()}
        step = make_train_step(None, device_pipeline=False, freeze_bn=mode == 'eval', mesh=mesh)
        state, m = step(state, batch, seed)
        out[f'{mode}_loss'] = float(m['loss'])
        spread = state.replicated_spread.cpu()
        out[f'{mode}_spread'] = dict(max=float(spread.max()),
                                     worst=state.replicated[int(spread.argmax())],
                                     nonzero=int(torch.count_nonzero(spread)),
                                     leaves=len(state.replicated))
        params = dict(state.model.named_parameters())
        grads = cpu(gather_params({n: p.grad for n, p in params.items()}, mesh, shapes))
        after = cpu(gather_params(params, mesh, shapes))
        if rank == 0:
            torch.save({'grads': grads, 'after': after}, work / f'parity_{mode}.pt')
        torch.save(cpu({n: p for n, p in params.items() if p.shape == shapes[n]}),
                   work / f'replicated_{mode}{rank}.pt')
        del state, params
        torch.cuda.empty_cache()

    # (b) the timed bf16 steps, the main path's launches
    raw, spec = train_data(TP_GLOBAL_BATCH)
    state = sharded_state()
    full = {k: v.shape for k, v in state.standard.state_dict().items()}
    out['sharded_leaves'] = sum(1 for k, v in state.model.state_dict().items()
                                if v.shape != full[k])
    step = make_train_step(spec, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    # the collectives' spans give their host time (those of the backward
    # open on autograd's device thread, outside the step's spans: taken by
    # their host interval)
    tracing.enable()
    losses, times, traffic = [], [], []
    for _ in range(TP_WARMUP + TP_TIMED):
        before, ns0 = tracing.counters(), time.time_ns()
        t0 = time.perf_counter()
        state, m = step(state, raw, seed)
        losses.append(float(m['loss']))
        times.append(time.perf_counter() - t0)
        after, ns1 = tracing.counters(), time.time_ns()
        traffic.append(dict(
            calls=after['tp.collective_calls'] - before.get('tp.collective_calls', 0),
            bytes=after['tp.collective_bytes'] - before.get('tp.collective_bytes', 0),
            ms=sum(x['end_ns'] - x['start_ns'] for x in tracing.spans()
                   if x['name'] == 'tp.collective' and ns0 <= x['start_ns'] <= ns1) * 1e-6))
    tracing.disable()
    counts = read_counts()
    n = TP_WARMUP + TP_TIMED
    expect_counts(counts, f'tp rank {rank}: {n} steps',
                  **{k: v * n for k, v in TRAIN_LAUNCHES.items()})
    check(all(abs(v) < float('inf') for v in losses), f'tp rank {rank}: losses {losses}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    zero_counts()
    state, m = make_train_step(spec, freeze_bn=True, mesh=mesh)(state, raw, seed)
    frozen = dict(loss=float(m['loss']), launches=read_counts())
    expect_counts(frozen['launches'], f'tp rank {rank}: frozen-BN step', **TRAIN_LAUNCHES)
    timed = times[TP_WARMUP:]
    out['timed'] = dict(losses=losses, step_ms=[t * 1e3 for t in times], step_ms_p50=p50(timed),
                        global_images_per_s=TP_GLOBAL_BATCH / p50(timed) * 1e3,
                        traffic=traffic,
                        model_axis_mb_per_step=traffic[-1]['bytes'] / 1e6,
                        collectives_per_step=traffic[-1]['calls'],
                        collective_host_ms_p50=sorted(t['ms'] for t in traffic[TP_WARMUP:])[
                            TP_TIMED // 2],
                        max_memory_allocated_gib=peak, launches=counts, frozen=frozen)
    del state
    torch.cuda.empty_cache()

    # (c) the trainer CLI, a TP resume, evaluate_only
    runs, calls = [], []
    argv = [str(REPO / 'configs' / 'train_mpii_8stack.yaml')] + TP_TRAINER + [
        f'COMMON.checkpoint_dir={work / "trainer"}']
    flags = ['--device', DP_DEVICE, '--backend', 'gloo']
    trainer = tp_counting_trainer(runs)
    out['trainer_s'] = run_main(argv + flags, f'tp rank {rank} trainer', Trainer=trainer)
    ckpts = next((work / 'trainer').glob('*/ckpts'))
    out['written'] = sorted(p.name for p in ckpts.iterdir())
    resume = f'COMMON.resume={ckpts / "checkpoint_1"}'
    out['resumed_s'] = run_main(argv + [resume, 'TRAIN.epochs=1'] + flags,
                                f'tp rank {rank} trainer, resumed', Trainer=trainer)
    out['evaluate_only_s'] = run_main(
        argv + ['COMMON.evaluate_only=true', 'EVAL.official=true', resume] + flags,
        f'tp rank {rank} evaluate_only', Evaluator=counting_evaluator(calls))
    out['evaluate_only'] = {c['what']: dict(counts=c['counts'], s=c['s'],
                                            out=c['out'] if c['what'] == 'evaluate' else None)
                            for c in calls}
    out['trainer'] = [dict(history=r.history, counts=r.counts, resumed=r.resumed,
                           steps=r.steps_per_epoch, val_batches=len(r.val_loader)) for r in runs]
    (work / f'rank{rank}.json').write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def tp_ranks_phase(seed: int, paths: dict, tmp: str) -> dict:
    """21. Tensor parallelism: the flagship over a (data 1 x model 2) layout
    on this one card over gloo (`tp_rank`), against one process."""
    import os
    import torch
    from hourglass_pose_estimation_torch.data import augment_batch, sample_augmentations, to_device
    from hourglass_pose_estimation_torch.runner import init_state, make_optimizer, make_train_step
    from hourglass_pose_estimation_torch.runner.train_state import step_generator
    work = Path(tmp) / 'tp'
    work.mkdir()
    # (a) one process on the parity batch, f32: a step in eval mode (frozen
    # BN) and one in train mode, each from the seed's weights
    raw, spec = train_data(TP_PARITY_BATCH)
    dev = torch.device(DP_DEVICE)
    data = to_device(raw, dev)
    data = augment_batch(data, sample_augmentations(
        step_generator(seed, 0, dev), data['scale'], scale_factor=spec.scale_factor,
        rot_factor=spec.rot_factor, train=True), spec, True)
    batch = {k: data[k] for k in ('image', 'target', 'target_weight')}
    torch.save({k: v.cpu() for k, v in batch.items()}, work / 'batch.pt')
    ref = {}
    for mode in ('eval', 'train'):
        model = flagship_model(seed, dtype=torch.float32)
        start = {n: p.detach().float().cpu().clone() for n, p in model.named_parameters()}
        state = init_state(model, make_optimizer(*DP_OPT))
        step = make_train_step(None, device_pipeline=False, freeze_bn=mode == 'eval')
        state, m = step(state, batch, seed)
        ref[mode] = dict(loss=float(m['loss']), grads=grads_of(model), start=start,
                         after={n: p.detach().float().cpu().clone()
                                for n, p in model.named_parameters()})
        del state, model
    del data, batch
    torch.cuda.empty_cache()

    env = dict(os.environ, WORLD_SIZE=str(TP_RANKS), MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(free_port()))
    procs, logs = [], []
    t0 = time.time()
    for r in range(TP_RANKS):
        logs.append(work / f'rank{r}.log')
        with open(logs[-1], 'wb') as log:        # files, not pipes: a full pipe blocks a rank
            procs.append(subprocess.Popen(
                [sys.executable, '-c', f'import sys; import chip_smoke; '
                 f'sys.exit(chip_smoke.tp_rank({str(work)!r}, {seed}))'],
                cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT))
    wait_ranks(procs, logs, TP_TIMEOUT_S)
    ranks_s = time.time() - t0
    res = [json.loads((work / f'rank{r}.json').read_text()) for r in range(TP_RANKS)]
    check([r['model_rank'] for r in res] == list(range(TP_RANKS)), 'tp: model ranks')
    check(len({r['library'] for r in res}) == 1, f"tp: libraries {[r['library'] for r in res]}")

    # (a) the ranks' loss, gathered gradients and update against one process
    parity = {}
    for mode in ('eval', 'train'):
        got = torch.load(work / f'parity_{mode}.pt')
        one = ref[mode]
        losses = [r[f'{mode}_loss'] for r in res]
        reps = [torch.load(work / f'replicated_{mode}{r}.pt') for r in range(TP_RANKS)]
        moves = lambda after: {n: p - one['start'][n] for n, p in after.items()}
        parity[mode] = dict(
            loss=losses[0], one_process_loss=one['loss'],
            loss_rel=abs(losses[0] - one['loss']) / abs(one['loss']),
            grad_rel_l2=dict_rel_l2(got['grads'], one['grads']),
            update_rel_l2=dict_rel_l2(moves(got['after']), moves(one['after'])),
            losses_equal_across_ranks=all(v == losses[0] for v in losses),
            replicated=len(reps[0]),
            replicated_spread=max(r[f'{mode}_spread']['max'] for r in res),
            spread_by_rank=[r[f'{mode}_spread'] for r in res],
            replicated_equal_across_ranks=all(
                torch.equal(reps[0][k], v) for rep in reps[1:] for k, v in rep.items()))
    out = dict(ranks=TP_RANKS, ranks_s=ranks_s, load_s=[r['load_s'] for r in res],
               sharded_leaves=res[0]['sharded_leaves'], parity=parity)
    print(f'tp {TP_RANKS} model ranks (gloo, one card), parity f32 at batch {TP_PARITY_BATCH}: '
          + json.dumps(parity) + f' (gates: loss {TOL_TP_LOSS}, gradients {TOL_TP_GRAD}, '
          f"update {TOL_TP_UPDATE}, replicated spread {TOL_TP_SPREAD})", flush=True)
    for mode, p in parity.items():
        check(p['losses_equal_across_ranks'], f'tp {mode}: the ranks report other losses')
        check(p['replicated'] > 0 and p['replicated_equal_across_ranks'],
              f'tp {mode}: replicated parameters differ across the ranks')
        check(p['replicated_spread'] <= TOL_TP_SPREAD[mode],
              f"tp {mode}: the ranks' replicated gradients apart {p['spread_by_rank']}")
        check(p['loss_rel'] <= TOL_TP_LOSS[mode], f"tp {mode}: loss rel {p['loss_rel']:.3e}")
        check(p['grad_rel_l2'] <= TOL_TP_GRAD[mode],
              f"tp {mode}: gradients rel L2 {p['grad_rel_l2']:.3e}")
        check(p['update_rel_l2'] <= TOL_TP_UPDATE[mode],
              f"tp {mode}: update rel L2 {p['update_rel_l2']:.3e}")

    # (b) the timed steps: the same losses on both ranks, finite
    losses = [r['timed']['losses'] for r in res]
    check(all(l == losses[0] for l in losses), f'tp: the ranks report other losses: {losses}')
    out['timed'] = {r['model_rank']: {k: v for k, v in r['timed'].items()
                                      if k not in ('launches', 'traffic')} for r in res}
    for r in res:
        t = r['timed']
        print(f"tp rank {r['model_rank']} (bf16, global batch {TP_GLOBAL_BATCH}): step ms p50 "
              f"{t['step_ms_p50']:.2f} (steps {[round(v, 2) for v in t['step_ms']]}), global "
              f"{t['global_images_per_s']:.1f} img/s, model axis {t['model_axis_mb_per_step']:.1f} "
              f"MB in {t['collectives_per_step']} collectives a step, their host ms p50 "
              f"{t['collective_host_ms_p50']:.2f}, peak {t['max_memory_allocated_gib']:.2f} GiB, "
              f"launches {t['launches']}, frozen-BN step {t['frozen']} (two ranks on one card: "
              'shared SMs, collectives through host memory)', flush=True)

    # (c) the trainer: rank 0 alone writes the standard layout, the TP
    # resume exact, evaluate_only equal to the trainer's validation
    ckpt = torch.load(next((work / 'trainer').glob('*/ckpts')) / 'checkpoint_1',
                      map_location='cpu', weights_only=True)
    standard = flagship_model(seed, device='cpu')
    check({k: v.shape for k, v in ckpt['model'].items()}
          == {k: v.shape for k, v in standard.state_dict().items()}
          and [st['square_avg'].shape for _, st in sorted(ckpt['optimizer']['state'].items())]
          == [p.shape for p in standard.parameters()],
          'tp trainer: checkpoint_1 is not in the standard layout')
    for r in res:
        first, resumed = r['trainer']
        check([h['epoch'] for h in first['history']] == [1, 2] and resumed['history'] == [],
              f"tp rank {r['model_rank']} trainer: epochs {first['history']}, "
              f"{resumed['history']}")
        check(r['written'] in (['best', 'checkpoint_1', 'checkpoint_2'],
                               ['checkpoint_1', 'checkpoint_2']),
              f"tp rank {r['model_rank']} trainer: written {r['written']}")
        res_ = resumed['resumed']
        check(res_['model_equal'] and res_['optimizer_equal'] and res_['step'] == first['steps']
              and res_['start_epoch'] == 1 and res_['sharded_leaves'] == r['sharded_leaves'],
              f"tp rank {r['model_rank']} trainer resume: {res_}")
        check(first['steps'] == DP_TRAINER_STEPS,
              f"tp rank {r['model_rank']}: {first['steps']} steps")
        total = dict(r['timed']['launches'])
        for run in (first, resumed):
            for c in run['counts']:
                expect_counts(c['train'], f"tp rank {r['model_rank']} trainer train",
                              **{k: v * run['steps'] for k, v in TRAIN_LAUNCHES.items()})
                expect_counts(c['val'], f"tp rank {r['model_rank']} trainer val",
                              **{k: v * run['val_batches'] for k, v in eval_launches().items()})
                for k in total:
                    total[k] += c['train'][k] + c['val'][k]
        h = first['history'][0]
        ev = r['evaluate_only']
        e_loss, e_acc = ev['evaluate']['out']
        rel = dict(loss=abs(e_loss - h['val_loss']) / abs(h['val_loss']),
                   pck=abs(e_acc - h['val_acc']))
        print(f"tp rank {r['model_rank']} trainer: epoch 1 {h['seconds']:.2f} s, train "
              f"{h['images_per_s']:.1f} img/s, loss {h['train_loss']:.5f}, val {h['val_loss']:.5f}"
              f" / {h['val_acc']:.4f}; epoch 2 (BN frozen) {first['history'][1]['seconds']:.2f} s;"
              f" written {r['written']}; resumed at step {res_['step']}, tensors equal to the "
              f"file, {res_['sharded_leaves']} leaves sharded again; evaluate_only "
              f"{e_loss:.5f} / {e_acc:.4f} (apart {rel}) in {r['evaluate_only_s']:.1f} s",
              flush=True)
        check(rel['loss'] <= TOL_TP_EVALUATE_ONLY and rel['pck'] <= TOL_TP_EVALUATE_ONLY,
              f"tp rank {r['model_rank']}: evaluate_only against the trainer's validation {rel}")
        for k in total:
            total[k] += r['timed']['frozen']['launches'][k] + sum(
                e['counts'][k] for w, e in ev.items() if w != 'evaluate_official')
        paths[f"tp_rank{r['model_rank']}"] = total
    out['trainer'] = [dict(written=r['written'], history=r['trainer'][0]['history'],
                           evaluate_only=r['evaluate_only']['evaluate']['out']) for r in res]
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
        # 16. export and the serving tools on the same checkpoint
        export = export_phase(tmp, trainer['checkpoint'], args.seed, paths)
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
        torch.cuda.empty_cache()
        mspn_export = mspn_export_phase(tmp, mspn_trainer['checkpoint'], args.seed, paths)
    torch.cuda.empty_cache()

    # 15. the host data layer: MPII and COCO trees of JPEG files through the
    # readers, both pipelines, whole-image canvases, the official metrics
    with tempfile.TemporaryDirectory() as tmp:
        host = host_data_phase(tmp, args.seed, paths, card)
    torch.cuda.empty_cache()

    # 18. data parallelism: DDP over NCCL at world size 1, two ranks on this
    # card over gloo against one process, the trainer CLI on the two ranks
    raw, spec = train_data(TRAIN_BATCH)
    dp_world1 = dp_world1_phase(args.seed, raw, spec, paths)
    del raw
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dp = dp_ranks_phase(args.seed, paths, tmp)
    torch.cuda.empty_cache()

    # 19. pipeline parallelism: the flagship's stacks over two stages on this
    # card over gloo, parity, timing, the trainer CLI and evaluate_only
    with tempfile.TemporaryDirectory() as tmp:
        pp = pp_ranks_phase(args.seed, paths, tmp)

    # 20. the overlapped train step on the flagship at batch 64
    raw, spec = train_data(TRAIN_BATCH)
    overlap = overlap_phase(args.seed, raw, spec, paths)
    del raw
    torch.cuda.empty_cache()

    # 21. tensor parallelism: the flagship over two model ranks on this card
    # over gloo, parity, timing, the trainer CLI and evaluate_only
    with tempfile.TemporaryDirectory() as tmp:
        tp = tp_ranks_phase(args.seed, paths, tmp)

    # 22. the kernels, with their launches on the main paths
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
    t = host['timings']
    print(f"card: {card}; host data: cv2 {host['loader']['cv2']}, native loader "
          f"{'available' if host['loader']['native_available'] else 'unavailable'} "
          f"({host['loader']['native_unavailable_reason']}), slots {host['slots']}; decode "
          f"{t['decode_ms']:.2f} ms per {t['image'][1]}x{t['image'][0]} JPEG, canvas_batch "
          f"{t['canvas_batch_ms']:.1f} ms and host_batch {t['host_batch_ms']:.1f} ms per "
          f"{t['batch']}; file-fed epoch: producer {host['producer_s_per_epoch']:.2f} s of "
          f"{host['epoch_train_s']:.2f} s (device pipeline), "
          f"{host['host_pipeline_producer_s']:.2f} s of {host['host_pipeline_epoch_train_s']:.2f} s "
          '(host pipeline)', flush=True)
    print(f"card: {card}; export (hg, batch {BATCH}): {export['export_s']:.1f} s to export, "
          f"{export['load_s']:.1f} s to load ({export['fresh_process_load_s']:.1f} s in a fresh "
          f"process), {export['size_mb']:.1f} MB; batch-{BATCH} p50 "
          f"{export['program_batch_ms_p50']:.2f} ms (in process "
          f"{export['fn_batch_ms_p50']:.2f}), batch-1 p50 {export['program_batch1_ms_p50']:.2f} "
          f"ms (in process {export['fn_batch1_ms_p50']:.2f}); served "
          f"{export['served_images_per_s']:.1f} img/s; mspn {mspn_export['export_s']:.1f} s to "
          f"export, {mspn_export['load_s']:.1f} s to load, {mspn_export['size_mb']:.1f} MB, "
          f"batch-{BATCH} p50 {mspn_export['program_batch_ms_p50']:.2f} ms (in process "
          f"{mspn_export['fn_batch_ms_p50']:.2f})", flush=True)
    print(f"card: {card}; data parallel: DDP at world size 1 (NCCL) step p50 "
          f"{dp_world1['ddp_step_ms_p50']:.2f} ms against {dp_world1['plain_step_ms_p50']:.2f} ms "
          f"in one process (batch {TRAIN_BATCH}); {DP_RANKS} ranks on this card (gloo), global "
          f"batch {DP_GLOBAL_BATCH}: losses {dp['losses']} against {dp['one_process_losses']}, "
          f"update rel L2 {dp['update_rel_l2']:.3e}, ranks' run {dp['ranks_s']:.1f} s", flush=True)
    print(f"card: {card}; pipeline parallel ({PP_RANKS} stages of {pp['stacks_per_stage']} "
          f"stacks on this card, gloo): parity f32 eval/train gradients rel L2 "
          f"{pp['parity']['eval']['grad_rel_l2']:.3e} / {pp['parity']['train']['grad_rel_l2']:.3e}; "
          f"bf16 step p50 {pp['timed'][0]['step_ms_p50']:.2f} / {pp['timed'][1]['step_ms_p50']:.2f} "
          f"ms, global {pp['timed'][0]['global_images_per_s']:.1f} img/s at batch "
          f"{PP_GLOBAL_BATCH} ({PP_M} microbatches); ranks' run {pp['ranks_s']:.1f} s", flush=True)
    print(f"card: {card}; overlapped step (batch {TRAIN_BATCH}): p50 "
          f"{overlap['overlapped_step_ms_p50']:.2f} ms against "
          f"{overlap['sequential_step_ms_p50']:.2f} ms sequential", flush=True)
    print(f"card: {card}; tensor parallel ({TP_RANKS} model ranks on this card, gloo, collectives "
          f"through host memory): parity f32 eval/train gradients rel L2 "
          f"{tp['parity']['eval']['grad_rel_l2']:.3e} / {tp['parity']['train']['grad_rel_l2']:.3e};"
          f" bf16 step p50 {tp['timed'][0]['step_ms_p50']:.2f} / "
          f"{tp['timed'][1]['step_ms_p50']:.2f} ms, global "
          f"{tp['timed'][0]['global_images_per_s']:.1f} img/s at batch {TP_GLOBAL_BATCH}, "
          f"{tp['timed'][0]['model_axis_mb_per_step']:.1f} MB a step over the model axis; "
          f"ranks' run {tp['ranks_s']:.1f} s", flush=True)
    print(json.dumps({'kernels': rows}), flush=True)
    print(f'total {time.time() - t_start:.1f} s', flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
