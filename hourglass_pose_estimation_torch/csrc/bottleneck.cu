// Fused pre-activation bottleneck forward (affine BN), bf16 tensor cores.
//
// Replaces the TPU kernels of `hourglass_pose_estimation_tpu/ops/pallas/
// bottleneck.py`, one CUDA kernel for each of its two schedules of the same
// function:
//
//   t1 = bf16(relu(x * a1 + b1))            x [B,H,W,C] bf16, NHWC
//   t2 = bf16(relu((t1 @ w1 + c1) * a2 + b2))          1x1, C -> P
//   t3 = bf16(relu((conv3x3(t2) + c2) * a3 + b3))      zero pad 1, P -> P
//   out = bf16(bf16(t3 @ w3 + c3) + x)                  1x1, P -> C
//
//   bottleneck_image_kernel  `fused_bottleneck_pallas` (`_kernel`, impl
//       'image'): conv1 once per pixel of the image, then conv2, conv3 and
//       the residual from the whole image's t2;
//   bottleneck_fwd_kernel    `fused_bottleneck_pallas_chunked`
//       (`_kernel_chunked`, impl 'chunked'): independent row tiles, each
//       recomputing conv1 for the one-row halo above and below it.
//
// What bounds them: at the flagship shapes (C=256, P=128) the function does
// about 426 kFLOP per pixel against 1 KB of device-memory traffic (read x,
// write out), so the tensor cores, not the memory, are the limit, and only
// `wgmma` reaches their rate on Hopper. The weights (416 KB at C=256) are
// read once per 128-pixel chunk, so what feeds the products is L2 traffic
// of about 3.3 KB of weights per pixel. Both kernels keep t2 and t3 out of
// device memory, as the TPU kernels do.
//
// Schedules. The TPU's `_kernel` holds a whole 64x64 image in VMEM; an SM
// has 227 KB of shared memory, and t2 alone is 1 MB at 64x64. A block takes
// one image and a tile of TR output rows and keeps the zero-padded
// (TR+2) x (W+2) x P t2 window in shared memory as bf16.
//   * chunked: the block computes conv1 for its TR rows and the halo rows
//     r0-1 and r0+TR itself (2/TR extra conv1 rows).
//   * image: the R = H/TR blocks of one image form a thread-block cluster
//     (R <= 8, the portable size), so the cluster holds the whole image's
//     t2, as `_kernel`'s scratch does. Each block computes conv1 for its own
//     TR rows only; after a cluster barrier it copies its halo rows from the
//     neighbouring blocks' shared memory (distributed shared memory), and a
//     second barrier keeps every block resident until its neighbours have
//     read it. Every weight tile is loaded once per cluster and multicast to
//     all R blocks (one L2 read feeds the image).
//
// The core both schedules share (phase A: conv1 into the window; phase B:
// conv2, conv3 and the residual), warp-specialised, 3 warpgroups a block:
//   * a producer warpgroup (registers lowered with `setmaxnreg`) whose one
//     thread streams the weights through a ring of 3 shared-memory stages
//     with TMA (`cp.async.bulk.tensor`, 128-byte swizzle), one tile of 128
//     output channels x 64 input channels (16 KB) per stage, in the order
//     the consumers use them; `mbarrier`s mark each stage full (the TMA's
//     bytes arrived) and empty (every consumer warp is done with it);
//   * two consumer warpgroups, 64 pixels each of a 128-pixel chunk, that run
//     `wgmma.mma_async` m64n128k16 (bf16 in, f32 accumulate) with B from the
//     ring through a shared-memory descriptor and A from registers, one tile
//     in flight while the next one's A is loaded:
//       conv1: A straight from x (4-byte loads per lane, one tile ahead)
//         with BN1 + ReLU in registers;
//       conv2: `ldmatrix` from the padded t2 window at per-lane addresses
//         (a one-pixel tap shift breaks the alignment a swizzled A
//         descriptor needs; per-lane addresses do not care);
//       conv3: t3 straight from conv2's accumulators after +c2, BN3 and
//         ReLU, rounded to bf16 and re-laid out as the A fragment, so t3
//         never goes to shared memory and phase B has no block barrier.
// Epilogues (bias, BN affine, ReLU, bf16 rounding, residual add) run in
// registers on the accumulator fragments. conv3's reads x and writes out in
// 16-byte pieces (a shuffle inside each quad of lanes regroups the
// fragment), with the residual read before conv3's products start: with
// 4-byte accesses this epilogue took about a third of the kernel's time.
// Every pixel sees the same products in the same k-order under both
// schedules, so the two kernels give the same bits.
//
// Measured on an H100 (PERF.md): about 0.43 ms at 64 images of 64x64,
// a quarter of the bf16 tensor peak. Half of it is conv1 (15% of the
// work): a third of that is its reads of x from device memory (one tile
// ahead; further ahead spills registers), the rest its short runs of 4
// tiles between epilogues, which both consumer warpgroups reach at once,
// leaving the tensor cores idle. Warpgroups that take turns (one computes
// while the other runs its epilogue) are the next step.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kP = 128;           // bottleneck width (planes)
constexpr int kC = 2 * kP;        // block width: an identity residual needs C = 2P
constexpr int kLd = kP + 8;       // smem pitch of one window pixel, bf16 elements (272 B)
constexpr int kChunk = 128;       // pixels per GEMM chunk: 64 per consumer warpgroup
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // + one producer warpgroup
constexpr int kMaxCluster = 8;    // portable thread-block cluster size
// weight ring stages. Measured on an H100 at the flagship shapes, 4 to 8
// stages were within 2% of 3, which leaves the most shared memory to the t2
// window; the tile choosers take only row tiles whose window fits beside 3.
constexpr int kStages = 3;
constexpr int kTileK = 64;        // input channels per weight tile (128 bytes: the swizzle span)
constexpr int kTileBytes = kP * kTileK * 2;   // 128 output channels x 64 input channels, bf16
constexpr int kConv2Tiles = 9 * (kP / kTileK);
constexpr int kConsumerBar = 1;   // named barrier of the consumer warpgroups
constexpr int kConv1Tiles = kC / kTileK;
constexpr int kConv3Tiles = 2 * (kC / kP);

struct BneckArgs {
  const __nv_bfloat16* x;    // [B][H][W][C]
  __nv_bfloat16* out;        // [B][H][W][C]
  const float* a1;
  const float* b1;
  const float* c1;
  const float* a2;
  const float* b2;
  const float* c2;
  const float* a3;
  const float* b3;
  const float* c3;
  int H, W, TR;
};

// ---- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait for the phase of parity `parity` to complete; a wait that cannot end
// (a fault in the tile order) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();   // seconds of polling: no real wait lasts a millisecond
}

// arrive on the barrier at the same offset in the shared memory of block
// `rank` of the cluster (the block's own when rank is its own)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBar), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same tile into the same offset of every block of the cluster in
// `mask`, each block's barrier at `bar` counting the bytes that reach it
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, uint16_t mask, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory descriptor of a K-major weight tile written by TMA with
// 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64] (m64 x n128 f32 fragment) += A (m64 x k16 bf16, registers) * B (desc)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// bf16 pair -> relu(v * s + t) -> bf16 pair (the BN1 affine of t1)
__device__ __forceinline__ uint32_t bn_relu_bf16(uint32_t v, float2 s, float2 t) {
  float2 f = unpack_bf16(v);
  return pack_bf16(fmaxf(f.x * s.x + t.x, 0.f), fmaxf(f.y * s.y + t.y, 0.f));
}

__device__ __forceinline__ uint32_t sel4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// A quad (lanes t = 0..3 of one accumulator row) holds n8 blocks j0..j0+3
// as v[k] = its 2 channels 8(j0+k)+2t, +1. Returns, for lane t, the 8
// channels of block j0+t (the pairs of lanes 0..3), so that the lane reads
// and writes 16 contiguous bytes of a pixel.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int t) {
  uint32_t r[4];   // r[x]: from lane t^x, its pair of block j0+t
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const uint32_t send = sel4(v[0], v[1], v[2], v[3], t ^ x);
    r[x] = x == 0 ? send : __shfl_xor_sync(0xffffffffu, send, x);
  }
  return make_uint4(sel4(r[0], r[1], r[2], r[3], t), sel4(r[0], r[1], r[2], r[3], t ^ 1),
                    sel4(r[0], r[1], r[2], r[3], t ^ 2), sel4(r[0], r[1], r[2], r[3], t ^ 3));
}

// bf16 pairs: a + b rounded to bf16
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float2 fa = unpack_bf16(a), fb = unpack_bf16(b);
  return pack_bf16(fa.x + fb.x, fa.y + fb.y);
}

__device__ __forceinline__ void zero_acc(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}

// ---- the weight ring, as the consumers walk it

struct Ring {
  uint32_t tiles;    // smem address of stage 0
  uint32_t full;     // smem address of full[0] (8 bytes per stage)
  uint32_t empty;    // smem address of empty[0]: this block's consumer warps
  uint32_t cempty;   // cempty[0]: every consumer warp of the cluster (block 0's is read)
  bool cluster;      // a cluster of more than one block
  int stage;
  uint32_t phase;

  __device__ __forceinline__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) {
      mbar_arrive(empty + 8 * s);
      if (cluster) mbar_arrive_cluster(cempty + 8 * s, 0);
    }
  }
};

// acc += sum over `ntiles` (even) ring tiles of A_i (registers, from
// load_a(i, buf, a)) times the tile; one tile's products in flight while
// the next one's A is loaded, each stage released once its products are done
template <class LoadA>
__device__ __forceinline__ void mma_tiles(float (&acc)[64], int ntiles, Ring& rg,
                                          const LoadA& load_a) {
  uint32_t a[2][4][4];
  int prev = -1;
  for (int i = 0; i < ntiles; i += 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      load_a(i + b, b, a[b]);
      mbar_wait(rg.full + 8 * rg.stage, rg.phase);
      __syncwarp();   // the warp converged again for the aligned wgmma instructions
      wgmma_fence();
      const uint64_t desc = desc_sw128(rg.tiles + rg.stage * kTileBytes);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_m64n128k16(acc, a[b][s], desc + 2 * s);   // +32 bytes: next k16
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) rg.release(prev);
      prev = rg.stage;
      if (++rg.stage == kStages) {
        rg.stage = 0;
        rg.phase ^= 1u;
      }
    }
  }
  wgmma_wait<0>();
  rg.release(prev);
}

// zero the two pad columns of window rows 0 .. nrows-1 (consumer threads)
__device__ __forceinline__ void zero_pad_columns(__nv_bfloat16* win, int nrows, int W) {
  const int Wp = W + 2;
  for (int e = threadIdx.x; e < nrows * 2 * (kP / 2); e += kConsumers) {
    int wr = e / kP, side = (e / (kP / 2)) & 1, k2 = e % (kP / 2);
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        win + ((size_t)wr * Wp + (side ? W + 1 : 0)) * kLd);
    dst[k2] = 0u;
  }
}

// ---- phase A: t2 of image rows row0 .. row0+nrows-1 into window rows
// wr0 .. wr0+nrows-1 (zero for rows outside the image)
__device__ __forceinline__ void conv1_rows(const BneckArgs& p, const __nv_bfloat16* ximg,
                                           __nv_bfloat16* win, int row0, int wr0, int nrows,
                                           Ring& rg) {
  const int H = p.H, W = p.W, Wp = W + 2;
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[64];
  const int npix = nrows * W;
  for (int q0 = 0; q0 < npix; q0 += kChunk) {
    const int m0 = q0 + wg * 64 + w * 16 + g;   // this thread's rows m0 and m0 + 8
    const __nv_bfloat16* xrow[2];
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
    // epilogue: +c1, BN2 affine, ReLU, bf16 -> window
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = j * 8 + 2 * t;
      const float2 cc = ld_f2(p.c1 + n), ss = ld_f2(p.a2 + n), tt = ld_f2(p.b2 + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m0 + 8 * h;
        if (q >= npix) continue;
        const int row = row0 + q / W;
        uint32_t v = 0u;
        if (row >= 0 && row < H)
          v = pack_bf16(fmaxf((acc[4 * j + 2 * h] + cc.x) * ss.x + tt.x, 0.f),
                        fmaxf((acc[4 * j + 2 * h + 1] + cc.y) * ss.y + tt.y, 0.f));
        *reinterpret_cast<uint32_t*>(win + ((size_t)(wr0 + q / W) * Wp + q % W + 1) * kLd + n) = v;
      }
    }
  }
}

// ---- phase B: conv2 (9 taps) from window rows 0 .. rows+1 -> t3 (registers)
// -> conv3 + residual -> output rows r0 .. r0+rows-1
__device__ __forceinline__ void conv2_conv3_rows(const BneckArgs& p, const __nv_bfloat16* ximg,
                                                 __nv_bfloat16* oimg, const __nv_bfloat16* win,
                                                 int r0, int rows, Ring& rg) {
  const int W = p.W, Wp = W + 2;
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[64];
  uint32_t ta[8][4];   // t3 as the A fragments of conv3's 8 k16 steps
  const int npixB = rows * W;
  for (int p0 = 0; p0 < npixB; p0 += kChunk) {
    const int m0 = p0 + wg * 64 + w * 16 + g;
    const int qa = min(p0 + wg * 64 + w * 16 + (lane & 15), npixB - 1);
    const uint32_t a_addr =
        smem_u32(win + ((size_t)(qa / W) * Wp + qa % W) * kLd + (lane >> 4) * 8);
    // this thread's two output pixels (rows m0, m0 + 8), clamped for the
    // reads; conv3's epilogue reads x and writes out 16 bytes a lane
    size_t off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = min(m0 + 8 * h, npixB - 1);
      off[h] = ((size_t)(r0 + q / W) * W + q % W) * kC + 8 * t;
    }
    zero_acc(acc);
    mma_tiles(acc, kConv2Tiles, rg, [&](int i, int, uint32_t (&a)[4][4]) {
      const int tap = i >> 1, dy = tap / 3, dx = tap - 3 * dy;
      const uint32_t base = a_addr + (uint32_t)(((dy * Wp + dx) * kLd + (i & 1) * kTileK) * 2);
#pragma unroll
      for (int s = 0; s < 4; ++s) ldmatrix_x4(a[s], base + s * 32);
    });
    // epilogue: +c2, BN3 affine, ReLU, bf16 -> the A fragments of conv3
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * s + half, n = j * 8 + 2 * t;
        const float2 cc = ld_f2(p.c2 + n), ss = ld_f2(p.a3 + n), tt = ld_f2(p.b3 + n);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ta[s][2 * half + h] =
              pack_bf16(fmaxf((acc[4 * j + 2 * h] + cc.x) * ss.x + tt.x, 0.f),
                        fmaxf((acc[4 * j + 2 * h + 1] + cc.y) * ss.y + tt.y, 0.f));
      }

    // conv3, kP output channels at a time; the residual (xr[h][grp]:
    // channels nb + 32 * grp + 8 * t .. +7 of pixel h) read while its
    // products run. Read earlier (before conv2), it holds 64 more
    // registers through conv2 and they spill: slower on an H100.
#pragma unroll
    for (int nh = 0; nh < kC / kP; ++nh) {
      const int nb = nh * kP;
      uint4 xr[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int grp = 0; grp < 4; ++grp)
          xr[h][grp] = *reinterpret_cast<const uint4*>(ximg + off[h] + nb + 32 * grp);
      zero_acc(acc);
      mma_tiles(acc, kP / kTileK, rg, [&](int, int kh, uint32_t (&a)[4][4]) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[s][e] = ta[kh * 4 + s][e];
      });
      // epilogue: +c3, bf16, + x, bf16 -> out
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        float2 cc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) cc[k] = ld_f2(p.c3 + nb + 8 * (4 * grp + k) + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * grp + k;
            v[k] = pack_bf16(acc[4 * j + 2 * h] + cc[k].x, acc[4 * j + 2 * h + 1] + cc[k].y);
          }
          const uint4 hv = quad_transpose(v, t), xv = xr[h][grp];
          if (m0 + 8 * h < npixB)
            *reinterpret_cast<uint4*>(oimg + off[h] + nb + 32 * grp) =
                make_uint4(add_bf16x2(hv.x, xv.x), add_bf16x2(hv.y, xv.y),
                           add_bf16x2(hv.z, xv.z), add_bf16x2(hv.w, xv.w));
        }
      }
    }
  }
}

// ---- the producer: every weight tile the consumers use, in their order:
// phase A, per chunk, w1's C/64 tiles; phase B, per chunk, w2's 18 tiles
// (tap-major, then the input-channel half) and w3's 2 tiles per 128 output
// channels. In a cluster, block 0 loads each tile for all R blocks.
struct TileSeq {
  int nA, kA, kB;
  __device__ __forceinline__ void coords(int i, int& map, int& c0, int& c1) const {
    if (i < nA) {
      map = 0;
      c0 = (i % kA) * kTileK;
      c1 = 0;
      return;
    }
    int j = (i - nA) % kB;
    map = j < kConv2Tiles ? 1 : 2;
    if (j >= kConv2Tiles) j -= kConv2Tiles;
    c0 = (j & 1) * kTileK;
    c1 = (j >> 1) * kP;
  }
};

// Block 0 of a cluster refills a stage once every consumer warp of the
// cluster released it (cempty); every block's producer arms its own full
// barrier once its own consumers released the stage (empty).
template <bool kCluster>
__device__ __forceinline__ void produce(const CUtensorMap* maps, const Ring& rg,
                                        const TileSeq& seq, int total, int sync_at,
                                        uint32_t rank, uint32_t R) {
  const bool leader = threadIdx.x == kConsumers;
  const uint32_t tiles = rg.tiles, full = rg.full;
  const uint32_t empty = kCluster && R > 1 && rank == 0 ? rg.cempty : rg.empty;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < total; ++i) {
    // the image schedule's two halo barriers, once the ring holds the
    // first phase-B tiles (waiting for more would wait on the barriers)
    if (kCluster && i == sync_at) {
      cluster_sync_all();
      cluster_sync_all();
    }
    if (leader) {
      mbar_wait(empty + 8 * stage, phase ^ 1u);
      mbar_expect_tx(full + 8 * stage, kTileBytes);
      if (!kCluster || rank == 0) {
        int m, c0, c1;
        seq.coords(i, m, c0, c1);
        const uint32_t dst = tiles + stage * kTileBytes, bar = full + 8 * stage;
        if (kCluster && R > 1)
          tma_load_multicast(dst, maps + m, bar, (uint16_t)((1u << R) - 1u), c0, c1);
        else
          tma_load(dst, maps + m, bar, c0, c1);
      }
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  if (kCluster) {
    if (sync_at >= total) {
      cluster_sync_all();
      cluster_sync_all();
    }
    cluster_sync_all();   // no block leaves while a neighbour may still arrive on its barriers
  }
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// the window after the ring (1024-byte aligned for the swizzle), then the barriers
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

template <bool kCluster>
__device__ __forceinline__ void bottleneck_block(const CUtensorMap* maps, const BneckArgs& p,
                                                 int b, int r0, int rank, int R) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);
  const int TR = p.TR, W = p.W, Wp = W + 2;
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kTileBytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + kStages * kTileBytes + (size_t)(TR + 2) * Wp * kLd * 2);
  const uint32_t full = smem_u32(bars);
  const Ring ring{smem_u32(smem), full, full + 8 * kStages, full + 16 * kStages, R > 1, 0, 0u};
  const size_t img = (size_t)b * p.H * W * kC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 8);        // this block's consumer warps
      mbar_init(ring.cempty + 8 * s, 8 * R);   // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kCluster)
    cluster_sync_all();
  else
    __syncthreads();

  const int rowsA = kCluster ? TR : TR + 2;
  const int rowsB = kCluster ? TR : min(TR, p.H - r0);
  TileSeq seq{cdiv(rowsA * W, kChunk) * kConv1Tiles, kConv1Tiles, kConv2Tiles + kConv3Tiles};
  const int total = seq.nA + cdiv(rowsB * W, kChunk) * seq.kB;

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<40>();
    produce<kCluster>(maps, ring, seq, total, min(seq.nA + kStages, total), rank, R);
  } else {
    setmaxnreg_inc<232>();
    Ring rg = ring;
    zero_pad_columns(win, TR + 2, W);
    if (!kCluster) {
      conv1_rows(p, p.x + img, win, r0 - 1, 0, TR + 2, rg);
      consumer_bar();
    } else {
      conv1_rows(p, p.x + img, win, r0, 1, TR, rg);
      cluster_sync_all();   // every block's t2 rows (and pad columns) written
      // halo: window row 0 <- rank-1's row TR, row TR+1 <- rank+1's row 1,
      // in 16-byte vectors over whole window rows (pad columns included,
      // zero in every block); zeros above and below the image
      cg::cluster_group cluster = cg::this_cluster();
      const int vrow = Wp * kLd * 2 / 16;
      for (int e = threadIdx.x; e < 2 * vrow; e += kConsumers) {
        const int below = e >= vrow, v = e - (below ? vrow : 0);
        const int nb = below ? rank + 1 : rank - 1;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (nb >= 0 && nb < R) {
          const __nv_bfloat16* src = win + (size_t)(below ? 1 : TR) * Wp * kLd;
          val = reinterpret_cast<const uint4*>(cluster.map_shared_rank(src, nb))[v];
        }
        reinterpret_cast<uint4*>(win + (size_t)(below ? TR + 1 : 0) * Wp * kLd)[v] = val;
      }
      cluster_sync_all();   // halos in place; no block leaves while read
    }
    conv2_conv3_rows(p, p.x + img, p.out + img, win, r0, rowsB, rg);
    if (kCluster) cluster_sync_all();   // matches the producer's last barrier
  }
}


// the weights' tensor maps (w1t, w2t, w3t), one kernel parameter
struct Maps {
  CUtensorMap m[3];
};

// impl 'chunked': grid (ceil(H/TR), B); each block recomputes its halo rows.
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_fwd_kernel(const __grid_constant__ Maps maps, const BneckArgs p) {
  bottleneck_block<false>(maps.m, p, blockIdx.y, blockIdx.x * p.TR, 0, 1);
}

// impl 'image': grid (R, B), one cluster of R = H/TR blocks per image; block
// `rank` owns rows rank*TR .. rank*TR+TR-1 and computes conv1 for them only.
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_image_kernel(const __grid_constant__ Maps maps, const BneckArgs p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  bottleneck_block<true>(maps.m, p, blockIdx.y, rank * p.TR, rank, (int)cluster.num_blocks());
}

// ---- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// Returned where a tensor map cannot be made: kEncodeFailed + the CUresult
// (kEncodeFailed alone where the CUDA driver lacks cuTensorMapEncodeTiled).
constexpr int kEncodeFailed = 10000;

// a [N][K] bf16 weight, K contiguous, in tiles of 128 rows x 64 columns
// with 128-byte swizzle (what desc_sw128 reads)
int encode_weight(CUtensorMap* map, const void* w, int K, int N) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kEncodeFailed;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTileK, (cuuint32_t)kP};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
                   box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// the weight ring, the t2 window, the barriers and room to align the ring
int smem_bytes(int W, int TR) {
  return 1023 + kStages * kTileBytes + (TR + 2) * (W + 2) * kLd * 2 + 3 * kStages * 8;
}

int make_launch(Maps* maps, BneckArgs* args, const void* x, void* out, const void* a1,
                const void* b1, const void* w1t, const void* c1, const void* a2, const void* b2,
                const void* w2t, const void* c2, const void* a3, const void* b3,
                const void* w3t, const void* c3, int H, int W, int TR) {
  int err = encode_weight(&maps->m[0], w1t, kC, kP);
  if (err == 0) err = encode_weight(&maps->m[1], w2t, kP, 9 * kP);
  if (err == 0) err = encode_weight(&maps->m[2], w3t, kP, kC);
  *args = BneckArgs{(const __nv_bfloat16*)x, (__nv_bfloat16*)out,
                    (const float*)a1, (const float*)b1, (const float*)c1,
                    (const float*)a2, (const float*)b2, (const float*)c2,
                    (const float*)a3, (const float*)b3, (const float*)c3,
                    H, W, TR};
  return err;
}

// launch configuration of the cluster kernel: grid (R, B), clusters (R, 1, 1)
cudaError_t image_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                         int B, int W, int TR, int R, void* stream) {
  int smem = smem_bytes(W, TR);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_image_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(R, B, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = R;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int hpe_bottleneck_smem_bytes(int W, int TR) { return smem_bytes(W, TR); }

// Returns cudaGetLastError() after the launch (0 = launched), or
// kEncodeFailed + CUresult where a weight's tensor map cannot be made.
extern "C" int hpe_bottleneck_fwd(const void* x, void* out,
                                  const void* a1, const void* b1, const void* w1t,
                                  const void* c1, const void* a2, const void* b2,
                                  const void* w2t, const void* c2, const void* a3,
                                  const void* b3, const void* w3t, const void* c3,
                                  int B, int H, int W, int C, int P, int TR,
                                  void* stream) {
  if (P != kP || C != kC || TR < 1 || B < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  BneckArgs args;
  int e = make_launch(&maps, &args, x, out, a1, b1, w1t, c1, a2, b2, w2t, c2, a3, b3, w3t, c3,
                      H, W, TR);
  if (e != 0) return e;
  int smem = smem_bytes(W, TR);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + TR - 1) / TR, B);
  bottleneck_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(maps, args);
  return (int)cudaGetLastError();
}

// Clusters of R blocks of the image kernel at (W, TR) that can be resident
// at once on the current device, into *n; returns the CUDA error.
extern "C" int hpe_bottleneck_image_max_clusters(int W, int TR, int R, int* n) {
  if (TR < 1 || W < 1 || R < 1 || R > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = image_config(&cfg, &attr, 1, W, TR, R, nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(n, (const void*)bottleneck_image_kernel, &cfg);
}

// The cluster kernel: TR must divide H, with H / TR <= 8 blocks per cluster.
// Returns as hpe_bottleneck_fwd does.
extern "C" int hpe_bottleneck_image_fwd(const void* x, void* out,
                                        const void* a1, const void* b1, const void* w1t,
                                        const void* c1, const void* a2, const void* b2,
                                        const void* w2t, const void* c2, const void* a3,
                                        const void* b3, const void* w3t, const void* c3,
                                        int B, int H, int W, int C, int P, int TR,
                                        void* stream) {
  if (P != kP || C != kC || TR < 1 || B < 1 || H < 1 || W < 1 || H % TR != 0 ||
      H / TR > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  BneckArgs args;
  int e = make_launch(&maps, &args, x, out, a1, b1, w1t, c1, a2, b2, w2t, c2, a3, b3, w3t, c3,
                      H, W, TR);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = image_config(&cfg, &attr, B, W, TR, H / TR, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, bottleneck_image_kernel, maps, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
