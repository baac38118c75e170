// Fused pre-activation bottleneck forward (affine BN), bf16 tensor cores.
//
// Replaces the TPU kernel `hourglass_pose_estimation_tpu/ops/pallas/
// bottleneck.py::fused_bottleneck_pallas` (`_kernel`, and the one-row
// halo recompute of `_kernel_chunked`):
//
//   t1 = bf16(relu(x * a1 + b1))            x [B,H,W,C] bf16, NHWC
//   t2 = bf16(relu((t1 @ w1 + c1) * a2 + b2))          1x1, C -> P
//   t3 = bf16(relu((conv3x3(t2) + c2) * a3 + b3))      zero pad 1, P -> P
//   out = bf16(bf16(t3 @ w3 + c3) + x)                  1x1, P -> C
//
// What bounds it: at the flagship shapes (C=256, P=128) it does about 426
// kFLOP per pixel against 1 KB of device-memory traffic (read x, write
// out), so the tensor cores, not the memory, are the limit. The design
// therefore keeps t2 and t3 out of device memory, as the TPU kernel does.
//
// Design. The TPU version holds a whole 64x64 image in VMEM; a Hopper SM
// has 227 KB of shared memory, and t2 alone is 1 MB at 64x64. So each
// block takes one image and a tile of TR output rows. It recomputes
// conv1 for the one-row halo above and below the tile and keeps the
// zero-padded (TR+2) x (W+2) x P t2 window in shared memory as bf16.
// Products run on bf16 tensor cores with f32 accumulation through
// `mma.sync.m16n8k16`: A tiles come from shared memory through
// `ldmatrix` (conv2, conv3) or straight from x with BN1+ReLU applied in
// registers (conv1); B fragments come from the weights in device memory
// through L1/L2 (0.4 MB in all), stored output-channel-major so that each
// fragment register is one aligned 32-bit load. Epilogues (bias, BN
// affine, ReLU, bf16 rounding, residual add) run in registers on the
// accumulator fragments, whose element layout mma.sync fixes.
// Eight warps as 2 (pixels) x 4 (channels); a warp owns a 64 x 32 tile.
// A later version moves to wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 128;           // bottleneck width (planes)
constexpr int kLd = kP + 8;       // smem pitch of one pixel, bf16 elements (272 B)
constexpr int kChunk = 128;       // pixels per GEMM chunk
constexpr int kThreads = 256;     // 8 warps: 2 along pixels x 4 along channels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 ldg_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// bf16 pair -> relu(v * s + t) -> bf16 pair (the BN1 affine of t1)
__device__ __forceinline__ uint32_t bn_relu_bf16(uint32_t v, float2 s, float2 t) {
  float2 f = unpack_bf16(v);
  return pack_bf16(fmaxf(f.x * s.x + t.x, 0.f), fmaxf(f.y * s.y + t.y, 0.f));
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc[i][j] += A_i (16 x 16 from smem rows a_addr[i] + koff) * B_j, for one
// k16 step. w points at the weight row block of this warp: output channel
// n0 + j*8 + g, input channel k0, row stride K.
__device__ __forceinline__ void mma_step_smem(float (&acc)[4][4][4],
                                              const uint32_t (&a_addr)[4],
                                              uint32_t koff_bytes,
                                              const __nv_bfloat16* w, int K,
                                              int tig) {
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], a_addr[i] + koff_bytes);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat16* wr = w + (size_t)(j * 8) * K;
    uint32_t b0 = ldg_u32(wr + 2 * tig);
    uint32_t b1 = ldg_u32(wr + 8 + 2 * tig);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma16816(acc[i][j], a[i], b0, b1);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bottleneck_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ out,
                      const float* __restrict__ a1, const float* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ w1t,  // [P][C]
                      const float* __restrict__ c1,
                      const float* __restrict__ a2, const float* __restrict__ b2,
                      const __nv_bfloat16* __restrict__ w2t,  // [3][3][P][P] (out, in)
                      const float* __restrict__ c2,
                      const float* __restrict__ a3, const float* __restrict__ b3,
                      const __nv_bfloat16* __restrict__ w3t,  // [C][P]
                      const float* __restrict__ c3,
                      int H, int W, int C, int TR) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);   // [(TR+2)*(W+2)][kLd]
  const int Wp = W + 2;
  __nv_bfloat16* t3s = win + (size_t)(TR + 2) * Wp * kLd;          // [kChunk][kLd]

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, H - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;          // 0..1: 64-pixel half of a chunk
  const int wn = warp & 3;           // 0..3: 32-channel quarter of 128
  const int g = lane >> 2;
  const int tig = lane & 3;
  const __nv_bfloat16* ximg = x + (size_t)b * H * W * C;
  __nv_bfloat16* oimg = out + (size_t)b * H * W * C;

  // zero the two pad columns of every window row
  for (int e = threadIdx.x; e < (TR + 2) * 2 * (kP / 2); e += kThreads) {
    int wr = e / kP, side = (e / (kP / 2)) & 1, k2 = e % (kP / 2);
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        win + ((size_t)wr * Wp + (side ? W + 1 : 0)) * kLd);
    dst[k2] = 0u;
  }

  float acc[4][4][4];

  // ---- phase A: t2 for window rows r0-1 .. r0+TR (zero outside the image)
  const int npixA = (TR + 2) * W;
  for (int q0 = 0; q0 < npixA; q0 += kChunk) {
    const __nv_bfloat16* xrow[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int q = min(q0 + wm * 64 + i * 16 + g + 8 * h, npixA - 1);
        int row = min(max(r0 - 1 + q / W, 0), H - 1);
        xrow[i][h] = ximg + ((size_t)row * W + q % W) * C;
      }
    zero_acc(acc);
    const __nv_bfloat16* wblk = w1t + (size_t)(wn * 32 + g) * C;
    for (int k0 = 0; k0 < C; k0 += 16) {
      float2 slo = ldg_f2(a1 + k0 + 2 * tig), shi = ldg_f2(a1 + k0 + 8 + 2 * tig);
      float2 tlo = ldg_f2(b1 + k0 + 2 * tig), thi = ldg_f2(b1 + k0 + 8 + 2 * tig);
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[i][h] = bn_relu_bf16(ldg_u32(xrow[i][h] + k0 + 2 * tig), slo, tlo);
          a[i][2 + h] = bn_relu_bf16(ldg_u32(xrow[i][h] + k0 + 8 + 2 * tig), shi, thi);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* wr = wblk + (size_t)(j * 8) * C + k0;
        uint32_t b0 = ldg_u32(wr + 2 * tig);
        uint32_t b1v = ldg_u32(wr + 8 + 2 * tig);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma16816(acc[i][j], a[i], b0, b1v);
      }
    }
    // epilogue: +c1, BN2 affine, ReLU, bf16 -> window
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = wn * 32 + j * 8 + 2 * tig;
      float2 cc = ldg_f2(c1 + n), ss = ldg_f2(a2 + n), tt = ldg_f2(b2 + n);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int q = q0 + wm * 64 + i * 16 + g + 8 * h;
          if (q >= npixA) continue;
          int wr = q / W, col = q % W;
          int row = r0 - 1 + wr;
          uint32_t v = 0u;
          if (row >= 0 && row < H)
            v = pack_bf16(fmaxf((acc[i][j][2 * h] + cc.x) * ss.x + tt.x, 0.f),
                          fmaxf((acc[i][j][2 * h + 1] + cc.y) * ss.y + tt.y, 0.f));
          *reinterpret_cast<uint32_t*>(win + ((size_t)wr * Wp + col + 1) * kLd + n) = v;
        }
    }
  }
  __syncthreads();

  // ---- phase B: conv2 (9 taps) -> t3 (smem) -> conv3 + residual -> out
  const int npixB = rows * W;
  for (int p0 = 0; p0 < npixB; p0 += kChunk) {
    uint32_t a_addr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int p = min(p0 + wm * 64 + i * 16 + (lane & 15), npixB - 1);
      a_addr[i] = smem_u32(win + ((size_t)(p / W) * Wp + p % W) * kLd + (lane >> 4) * 8);
    }
    zero_acc(acc);
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t tap = (uint32_t)((dy * Wp + dx) * kLd * 2);
        const __nv_bfloat16* wblk = w2t + ((size_t)(dy * 3 + dx) * kP + wn * 32 + g) * kP;
#pragma unroll 2
        for (int k0 = 0; k0 < kP; k0 += 16)
          mma_step_smem(acc, a_addr, tap + k0 * 2, wblk + k0, kP, tig);
      }
    // epilogue: +c2, BN3 affine, ReLU, bf16 -> t3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = wn * 32 + j * 8 + 2 * tig;
      float2 cc = ldg_f2(c2 + n), ss = ldg_f2(a3 + n), tt = ldg_f2(b3 + n);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int m = wm * 64 + i * 16 + g + 8 * h;
          *reinterpret_cast<uint32_t*>(t3s + (size_t)m * kLd + n) =
              pack_bf16(fmaxf((acc[i][j][2 * h] + cc.x) * ss.x + tt.x, 0.f),
                        fmaxf((acc[i][j][2 * h + 1] + cc.y) * ss.y + tt.y, 0.f));
        }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
      a_addr[i] = smem_u32(t3s + (size_t)(wm * 64 + i * 16 + (lane & 15)) * kLd + (lane >> 4) * 8);
    for (int nb = 0; nb < C; nb += kP) {
      zero_acc(acc);
      const __nv_bfloat16* wblk = w3t + (size_t)(nb + wn * 32 + g) * kP;
#pragma unroll 2
      for (int k0 = 0; k0 < kP; k0 += 16)
        mma_step_smem(acc, a_addr, k0 * 2, wblk + k0, kP, tig);
      // epilogue: +c3, bf16, + x, bf16 -> out
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int n = nb + wn * 32 + j * 8 + 2 * tig;
        float2 cc = ldg_f2(c3 + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int p = p0 + wm * 64 + i * 16 + g + 8 * h;
            if (p >= npixB) continue;
            size_t off = ((size_t)(r0 + p / W) * W + p % W) * C + n;
            float2 hv = unpack_bf16(pack_bf16(acc[i][j][2 * h] + cc.x,
                                              acc[i][j][2 * h + 1] + cc.y));
            float2 xv = unpack_bf16(ldg_u32(ximg + off));
            *reinterpret_cast<uint32_t*>(oimg + off) = pack_bf16(hv.x + xv.x, hv.y + xv.y);
          }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int hpe_bottleneck_smem_bytes(int W, int TR) {
  return ((TR + 2) * (W + 2) + kChunk) * kLd * 2;
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_bottleneck_fwd(const void* x, void* out,
                                  const void* a1, const void* b1, const void* w1t,
                                  const void* c1, const void* a2, const void* b2,
                                  const void* w2t, const void* c2, const void* a3,
                                  const void* b3, const void* w3t, const void* c3,
                                  int B, int H, int W, int C, int P, int TR,
                                  void* stream) {
  if (P != kP || C % kP != 0 || TR < 1 || B < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  int smem = hpe_bottleneck_smem_bytes(W, TR);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + TR - 1) / TR, B);
  bottleneck_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
      (const float*)a1, (const float*)b1, (const __nv_bfloat16*)w1t, (const float*)c1,
      (const float*)a2, (const float*)b2, (const __nv_bfloat16*)w2t, (const float*)c2,
      (const float*)a3, (const float*)b3, (const __nv_bfloat16*)w3t, (const float*)c3,
      H, W, C, TR);
  return (int)cudaGetLastError();
}
