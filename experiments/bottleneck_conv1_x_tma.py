#!/usr/bin/env python3
"""Experiment: conv1's x through TMA in the fused bottleneck kernel.

    python3 experiments/bottleneck_conv1_x_tma.py [--out FILE]

Builds two versions of `hourglass_pose_estimation_torch/csrc/bottleneck.cu`
side by side (one nvcc each, started together) and times them in turns on
one card, at batch 64 and the flagship shapes (C 256, P 128):

  present  the source as it is: conv1's A read from x in device memory by
           4-byte loads per lane, one weight tile ahead;
  tma_x    the same core with conv1's x staged by TMA: each ring stage
           holds a weight tile and, in phase A, the chunk's 128 pixels x
           64 channels of x (16 KB, 128-byte swizzle, boxes over the
           flattened pixel axis [B*H*W, C] with zero fill outside it),
           which the consumers read with `ldmatrix` and put through BN1 +
           ReLU in registers. Stages of 32 KB leave room for the t2 window
           of 4 rows at 64^2, not 8.

Each version's row tile is the largest that fits its shared memory, halved
while the grid would leave SMs idle (the chunked schedule's own rule), and
`present` is also timed at the row tile `tma_x` takes. The image schedule
is timed where a cluster of at most 8 blocks holds the image. Every output
is held equal to `present`'s (the same products in the same k-order). Each
time is one call's device time from a CUDA graph of 20 calls, the median
of 5 replays, in the order present, tma_x, tma_x, present.

Prints one JSON line per shape, the card's name and power limit, and the
ptxas registers and spills of each version; writes them to --out as JSON.
Needs a Hopper card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCE = REPO / 'hourglass_pose_estimation_torch' / 'csrc' / 'bottleneck.cu'
BUILD = REPO / 'hourglass_pose_estimation_torch' / 'ops' / 'hopper' / 'build' / 'experiments'
BATCH = 64
MAX_SMEM = 232448
MAX_CLUSTER = 8

# (old, new): each old text occurs exactly once in the source
TMA_X = [
    ("constexpr int kTileBytes = kP * kTileK * 2;   // 128 output channels x 64 input channels, bf16\n",
     "constexpr int kTileBytes = kP * kTileK * 2;   // 128 output channels x 64 input channels, bf16\n"
     "constexpr int kStageBytes = 2 * kTileBytes;  // a weight tile, then phase A's x tile\n"),
    # wait for the stage first where A comes from it
    ("template <class LoadA>\n__device__ __forceinline__ void mma_tiles(",
     "template <bool kAFromStage = false, class LoadA>\n__device__ __forceinline__ void mma_tiles("),
    ("      load_a(i + b, b, a[b]);\n      mbar_wait(rg.full + 8 * rg.stage, rg.phase);\n",
     "      if (!kAFromStage) load_a(i + b, b, a[b]);\n"
     "      mbar_wait(rg.full + 8 * rg.stage, rg.phase);\n"
     "      if (kAFromStage) load_a(i + b, b, a[b]);\n"),
    ("      const uint64_t desc = desc_sw128(rg.tiles + rg.stage * kTileBytes);\n",
     "      const uint64_t desc = desc_sw128(rg.tiles + rg.stage * kStageBytes);\n"),
    # conv1's A: ldmatrix from the stage's swizzled x tile
    ("""    const __nv_bfloat16* xrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int q = min(m0 + 8 * h, npix - 1);
      int row = min(max(row0 + q / W, 0), H - 1);
      xrow[h] = ximg + ((size_t)row * W + q % W) * kC;
    }
    // x one tile ahead: tile kt+1's values are read while tile kt's
    // products run (two ahead, the extra registers spill: slower)
    uint32_t xa[4][4];
    auto load_x = [&](int kt) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k0 = kt * kTileK + s * 16 + 2 * t;
          xa[s][h] = ld_u32(xrow[h] + k0);
          xa[s][2 + h] = ld_u32(xrow[h] + k0 + 8);
        }
    };
    load_x(0);
    zero_acc(acc);
    mma_tiles(acc, kConv1Tiles, rg, [&](int kt, int, uint32_t (&a)[4][4]) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k0 = kt * kTileK + s * 16 + 2 * t;
        const float2 slo = ld_f2(p.a1 + k0), shi = ld_f2(p.a1 + k0 + 8);
        const float2 tlo = ld_f2(p.b1 + k0), thi = ld_f2(p.b1 + k0 + 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[s][h] = bn_relu_bf16(xa[s][h], slo, tlo);
          a[s][2 + h] = bn_relu_bf16(xa[s][2 + h], shi, thi);
        }
      }
      if (kt + 1 < kConv1Tiles) load_x(kt + 1);
    });
""",
     """    // this lane's ldmatrix row of the x tile (128-byte rows, 16-byte
    // pieces swizzled by the row's low 3 bits)
    const int pr = wg * 64 + w * 16 + (lane & 15);
    const uint32_t xoff = kTileBytes + pr * 128, xsw = pr & 7, half = lane >> 4;
    zero_acc(acc);
    mma_tiles<true>(acc, kConv1Tiles, rg, [&](int kt, int, uint32_t (&a)[4][4]) {
      const uint32_t xs = rg.tiles + rg.stage * kStageBytes + xoff;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k0 = kt * kTileK + s * 16 + 2 * t;
        const float2 slo = ld_f2(p.a1 + k0), shi = ld_f2(p.a1 + k0 + 8);
        const float2 tlo = ld_f2(p.b1 + k0), thi = ld_f2(p.b1 + k0 + 8);
        uint32_t r[4];
        ldmatrix_x4(r, xs + (((2 * s + half) ^ xsw) << 4));
        a[s][0] = bn_relu_bf16(r[0], slo, tlo);
        a[s][1] = bn_relu_bf16(r[1], slo, tlo);
        a[s][2] = bn_relu_bf16(r[2], shi, thi);
        a[s][3] = bn_relu_bf16(r[3], shi, thi);
      }
    });
"""),
    # the producer loads phase A's x tiles beside the weight tiles
    ("""                                        const TileSeq& seq, int total, int sync_at,
                                        uint32_t rank, uint32_t R) {""",
     """                                        const TileSeq& seq, int total, int sync_at,
                                        uint32_t rank, uint32_t R, int xpix0) {"""),
    ("""      mbar_expect_tx(full + 8 * stage, kTileBytes);
      if (!kCluster || rank == 0) {
        int m, c0, c1;
        seq.coords(i, m, c0, c1);
        const uint32_t dst = tiles + stage * kTileBytes, bar = full + 8 * stage;""",
     """      const bool xa = i < seq.nA;
      mbar_expect_tx(full + 8 * stage, xa ? kStageBytes : kTileBytes);
      if (xa)
        tma_load(tiles + stage * kStageBytes + kTileBytes, maps + 3, full + 8 * stage,
                 (i % seq.kA) * kTileK, xpix0 + (i / seq.kA) * kChunk);
      if (!kCluster || rank == 0) {
        int m, c0, c1;
        seq.coords(i, m, c0, c1);
        const uint32_t dst = tiles + stage * kStageBytes, bar = full + 8 * stage;"""),
    ("""  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kTileBytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + kStages * kTileBytes + (size_t)(TR + 2) * Wp * kLd * 2);""",
     """  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + (size_t)(TR + 2) * Wp * kLd * 2);"""),
    ("""    produce<kCluster>(maps, ring, seq, total, min(seq.nA + kStages, total), rank, R);""",
     """    produce<kCluster>(maps, ring, seq, total, min(seq.nA + kStages, total), rank, R,
                      (b * p.H + (kCluster ? r0 : r0 - 1)) * W);"""),
    ("""  CUtensorMap m[3];""", """  CUtensorMap m[4];"""),
    ("""// the weight ring, the t2 window, the barriers and room to align the ring
int smem_bytes(int W, int TR) {
  return 1023 + kStages * kTileBytes + (TR + 2) * (W + 2) * kLd * 2 + 3 * kStages * 8;
}""",
     """// x [B*H*W][C] bf16 in boxes of 128 pixels x 64 channels, 128-byte swizzle,
// zero fill outside the tensor
int encode_x(CUtensorMap* map, const void* x, long long npix) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kEncodeFailed;
  const cuuint64_t dims[2] = {(cuuint64_t)kC, (cuuint64_t)npix};
  const cuuint64_t strides[1] = {(cuuint64_t)kC * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTileK, (cuuint32_t)kChunk};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides,
                   box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// the ring (weight and x tiles), the t2 window, the barriers and room to align the ring
int smem_bytes(int W, int TR) {
  return 1023 + kStages * kStageBytes + (TR + 2) * (W + 2) * kLd * 2 + 3 * kStages * 8;
}"""),
    ("""                const void* w3t, const void* c3, int H, int W, int TR) {
  int err = encode_weight(&maps->m[0], w1t, kC, kP);""",
     """                const void* w3t, const void* c3, int B, int H, int W, int TR) {
  int err = encode_weight(&maps->m[0], w1t, kC, kP);
  if (err == 0) err = encode_x(&maps->m[3], x, (long long)B * H * W);"""),
]
# both entry points pass B on to make_launch
CALL = ("""  int e = make_launch(&maps, &args, x, out, a1, b1, w1t, c1, a2, b2, w2t, c2, a3, b3, w3t, c3,
                      H, W, TR);""",
        """  int e = make_launch(&maps, &args, x, out, a1, b1, w1t, c1, a2, b2, w2t, c2, a3, b3, w3t, c3,
                      B, H, W, TR);""")


def patched(text: str) -> str:
    for old, new in TMA_X:
        if text.count(old) != 1:
            raise SystemExit(f'patch does not apply once: {old[:70]!r}')
        text = text.replace(old, new)
    if text.count(CALL[0]) != 2:
        raise SystemExit('make_launch calls not found')
    return text.replace(CALL[0], CALL[1])


def build_all(sources: dict) -> dict:
    """{name: source text} -> {name: (ctypes library, ptxas log)}, one nvcc
    per version, all started together."""
    from hourglass_pose_estimation_torch.ops.hopper import _build
    nvcc = _build.find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = BUILD / f'{name}.cu'
        src.write_text(text)
        so = BUILD / f'lib{name}.so'
        cmd = [nvcc, *_build.NVCC_FLAGS, '-shared', str(src), '-o', str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f'nvcc failed on {name}:\n{log}')
        lib = ctypes.CDLL(str(so))
        for fn in ('hpe_bottleneck_fwd', 'hpe_bottleneck_smem_bytes', 'hpe_bottleneck_image_fwd'):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


def ptxas(log: str) -> dict:
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = 'image' if 'image' in m.group(1) else 'chunked'
            out[name] = {}
        m = re.search(r'Used (\d+) registers', ln)
        if m and name:
            out[name]['registers'] = int(m.group(1))
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', ln)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
    return out


def fill(height: int, tr: int, sms: int, ok) -> int:
    while BATCH * (height // tr) < sms - 4 and tr % 2 == 0 and tr > 2 and ok(tr // 2):
        tr //= 2
    return tr


def chunked_tr(lib, hw: int, sms: int) -> int:
    fits = [d for d in range(1, hw + 1)
            if hw % d == 0 and lib.hpe_bottleneck_smem_bytes(hw, d) <= MAX_SMEM]
    return fill(hw, fits[-1], sms, lambda tr: True)


def image_tr(lib, hw: int, sms: int):
    ok = lambda d: hw // d <= MAX_CLUSTER
    fits = [d for d in range(1, hw + 1)
            if hw % d == 0 and ok(d) and lib.hpe_bottleneck_smem_bytes(hw, d) <= MAX_SMEM]
    return fill(hw, fits[-1], sms, ok) if fits else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=str(REPO / 'chiprun_out' / 'bottleneck_conv1_x_tma.json'))
    args = ap.parse_args(argv)
    import torch
    from hourglass_pose_estimation_torch.models.modules import Bottleneck
    from hourglass_pose_estimation_torch.ops.hopper import _build, bottleneck_reference
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()
    print(f'card: {card}', flush=True)
    text = SOURCE.read_text()
    libs = build_all({'present': text, 'tma_x': patched(text)})
    usage = {name: ptxas(log) for name, (_, log) in libs.items()}
    print('ptxas: ' + json.dumps(usage), flush=True)

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    blk = Bottleneck(256, 128, fuse_block=True)
    with torch.no_grad():
        for m in (blk.bn1, blk.bn2, blk.bn3):
            n = m.weight.numel()
            m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
            m.bias.copy_(0.1 * torch.randn(n, generator=gen))
            m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
            m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    prm = blk.to(dev).fused_params()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launcher(name, entry, x, out, tr):
        lib = libs[name][0]
        ptrs = [t.data_ptr() for t in (x, out, prm.a1, prm.b1, prm.w1, prm.c1, prm.a2, prm.b2,
                                       prm.w2, prm.c2, prm.a3, prm.b3, prm.w3, prm.c3)]
        fn = getattr(lib, entry)
        B, H, W, C = x.shape

        def run():
            _build.check(fn(*ptrs, B, H, W, C, 128, tr, torch.cuda.current_stream().cuda_stream),
                         f'{name} {entry}')
        return run

    def graph_ms(run, iters=20, replays=5):
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                run()
        g.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(replays):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e) / iters)
        return statistics.median(times)

    results = dict(card=card, ptxas=usage, shapes=[])
    for hw in (64, 32, 16):
        x = torch.randn(BATCH, hw, hw, 256, generator=gen).to(dev, torch.bfloat16)
        ref = bottleneck_reference(x, prm)
        trs = {name: chunked_tr(libs[name][0], hw, sms) for name in libs}
        cases = [('present', 'hpe_bottleneck_fwd', trs['present']),
                 ('tma_x', 'hpe_bottleneck_fwd', trs['tma_x'])]
        if trs['tma_x'] != trs['present']:
            cases.append(('present', 'hpe_bottleneck_fwd', trs['tma_x']))
        for name in libs:
            itr = image_tr(libs[name][0], hw, sms)
            if itr is not None:
                cases.append((name, 'hpe_bottleneck_image_fwd', itr))
        entry = dict(hw=hw, batch=BATCH)
        outs = {}
        for name, fn, tr in cases:
            out = torch.empty_like(x)
            launcher(name, fn, x, out, tr)()
            torch.cuda.synchronize()
            outs[(name, fn, tr)] = out
        base = outs[cases[0]]
        for key, out in outs.items():
            name, fn, tr = key
            label = f"{name}_{'image' if 'image' in fn else 'chunked'}_TR{tr}"
            branch = float((out.float() - x.float() - (ref.float() - x.float())).norm()
                           / (ref.float() - x.float()).norm())
            if not torch.equal(out, base) or branch > 1e-2:
                raise SystemExit(f'{hw}^2 {label}: differs from present (branch rel L2 {branch:.3e})')
            entry[f'{label}_branch_rel_l2'] = branch
            entry[f'{label}_smem_bytes'] = libs[name][0].hpe_bottleneck_smem_bytes(hw, tr)
        # in turns: present, tma_x, tma_x, present (each key twice)
        order = [k for k in outs if k[0] == 'present'] + [k for k in outs if k[0] == 'tma_x']
        order = order + order[::-1]
        times = {}
        for key in order:
            name, fn, tr = key
            out = outs[key]
            times.setdefault(key, []).append(graph_ms(launcher(name, fn, x, out, tr)))
        for (name, fn, tr), ts in times.items():
            label = f"{name}_{'image' if 'image' in fn else 'chunked'}_TR{tr}"
            entry[f'{label}_ms'] = ts
            entry[f'{label}_ms_mean'] = sum(ts) / len(ts)
        print(f'conv1 x tma {hw}x{hw}: ' + json.dumps(entry), flush=True)
        results['shapes'].append(entry)
        del x, ref, outs
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
