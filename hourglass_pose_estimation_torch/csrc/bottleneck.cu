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
// write out), so the tensor cores, not the memory, are the limit. Both
// kernels keep t2 and t3 out of device memory, as the TPU kernels do.
//
// Design. The TPU's `_kernel` holds a whole 64x64 image in VMEM; a Hopper SM
// has 227 KB of shared memory, and t2 alone is 1 MB at 64x64. A block takes
// one image and a tile of TR output rows and keeps the zero-padded
// (TR+2) x (W+2) x P t2 window in shared memory as bf16.
//   * chunked: the block computes conv1 for its TR rows and the halo rows
//     r0-1 and r0+TR itself (2/TR extra conv1 rows).
//   * image: the R = H/TR blocks of one image form a thread-block cluster
//     (R <= 8, the portable size), so the cluster holds the whole image's
//     t2, as `_kernel`'s scratch does. Each block computes conv1 for its own
//     TR rows only; after a cluster barrier it copies its halo rows from the
//     neighbouring blocks' shared memory (distributed shared memory:
//     `ldmatrix` reads only the block's own), and a second barrier keeps
//     every block resident until its neighbours have read it.
// Both then run the same phase B. Products run on bf16 tensor cores with
// f32 accumulation through `mma.sync.m16n8k16`: A tiles come from shared
// memory through `ldmatrix` (conv2, conv3) or straight from x with BN1+ReLU
// applied in registers (conv1); B fragments come from the weights in device
// memory through L1/L2 (0.4 MB in all), stored output-channel-major so that
// each fragment register is one aligned 32-bit load. Epilogues (bias, BN
// affine, ReLU, bf16 rounding, residual add) run in registers on the
// accumulator fragments, whose element layout mma.sync fixes. Every pixel
// sees the same products in the same k-order under both schedules, so the
// two kernels give the same bits. Eight warps as 2 (pixels) x 4
// (channels); a warp owns a 64 x 32 tile. A later version moves to
// wgmma/TMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kP = 128;           // bottleneck width (planes)
constexpr int kLd = kP + 8;       // smem pitch of one pixel, bf16 elements (272 B)
constexpr int kChunk = 128;       // pixels per GEMM chunk
constexpr int kThreads = 256;     // 8 warps: 2 along pixels x 4 along channels
constexpr int kMaxCluster = 8;    // portable thread-block cluster size

struct BneckArgs {
  const __nv_bfloat16* x;    // [B][H][W][C]
  __nv_bfloat16* out;        // [B][H][W][C]
  const float* a1;
  const float* b1;
  const __nv_bfloat16* w1t;  // [P][C]
  const float* c1;
  const float* a2;
  const float* b2;
  const __nv_bfloat16* w2t;  // [3][3][P][P] (out, in)
  const float* c2;
  const float* a3;
  const float* b3;
  const __nv_bfloat16* w3t;  // [C][P]
  const float* c3;
  int H, W, C, TR;
};

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

// zero the two pad columns of window rows 0 .. nrows-1
__device__ __forceinline__ void zero_pad_columns(__nv_bfloat16* win, int nrows, int W) {
  const int Wp = W + 2;
  for (int e = threadIdx.x; e < nrows * 2 * (kP / 2); e += kThreads) {
    int wr = e / kP, side = (e / (kP / 2)) & 1, k2 = e % (kP / 2);
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        win + ((size_t)wr * Wp + (side ? W + 1 : 0)) * kLd);
    dst[k2] = 0u;
  }
}

// ---- phase A: t2 of image rows row0 .. row0+nrows-1 into window rows
// wr0 .. wr0+nrows-1 (zero for rows outside the image)
__device__ __forceinline__ void conv1_rows(const BneckArgs& p,
                                           const __nv_bfloat16* ximg,
                                           __nv_bfloat16* win, int row0,
                                           int wr0, int nrows) {
  const int H = p.H, W = p.W, C = p.C, Wp = W + 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tig = lane & 3;
  float acc[4][4][4];
  const int npix = nrows * W;
  for (int q0 = 0; q0 < npix; q0 += kChunk) {
    const __nv_bfloat16* xrow[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int q = min(q0 + wm * 64 + i * 16 + g + 8 * h, npix - 1);
        int row = min(max(row0 + q / W, 0), H - 1);
        xrow[i][h] = ximg + ((size_t)row * W + q % W) * C;
      }
    zero_acc(acc);
    const __nv_bfloat16* wblk = p.w1t + (size_t)(wn * 32 + g) * C;
    for (int k0 = 0; k0 < C; k0 += 16) {
      float2 slo = ldg_f2(p.a1 + k0 + 2 * tig), shi = ldg_f2(p.a1 + k0 + 8 + 2 * tig);
      float2 tlo = ldg_f2(p.b1 + k0 + 2 * tig), thi = ldg_f2(p.b1 + k0 + 8 + 2 * tig);
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
      float2 cc = ldg_f2(p.c1 + n), ss = ldg_f2(p.a2 + n), tt = ldg_f2(p.b2 + n);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int q = q0 + wm * 64 + i * 16 + g + 8 * h;
          if (q >= npix) continue;
          int col = q % W;
          int row = row0 + q / W;
          uint32_t v = 0u;
          if (row >= 0 && row < H)
            v = pack_bf16(fmaxf((acc[i][j][2 * h] + cc.x) * ss.x + tt.x, 0.f),
                          fmaxf((acc[i][j][2 * h + 1] + cc.y) * ss.y + tt.y, 0.f));
          *reinterpret_cast<uint32_t*>(win + ((size_t)(wr0 + q / W) * Wp + col + 1) * kLd + n) = v;
        }
    }
  }
}

// ---- phase B: conv2 (9 taps) from window rows 0 .. rows+1 -> t3 (smem)
// -> conv3 + residual -> output rows r0 .. r0+rows-1
__device__ __forceinline__ void conv2_conv3_rows(const BneckArgs& p,
                                                 const __nv_bfloat16* ximg,
                                                 __nv_bfloat16* oimg,
                                                 const __nv_bfloat16* win,
                                                 __nv_bfloat16* t3s, int r0,
                                                 int rows) {
  const int W = p.W, C = p.C, Wp = W + 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tig = lane & 3;
  float acc[4][4][4];
  const int npixB = rows * W;
  for (int p0 = 0; p0 < npixB; p0 += kChunk) {
    uint32_t a_addr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int q = min(p0 + wm * 64 + i * 16 + (lane & 15), npixB - 1);
      a_addr[i] = smem_u32(win + ((size_t)(q / W) * Wp + q % W) * kLd + (lane >> 4) * 8);
    }
    zero_acc(acc);
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t tap = (uint32_t)((dy * Wp + dx) * kLd * 2);
        const __nv_bfloat16* wblk = p.w2t + ((size_t)(dy * 3 + dx) * kP + wn * 32 + g) * kP;
#pragma unroll 2
        for (int k0 = 0; k0 < kP; k0 += 16)
          mma_step_smem(acc, a_addr, tap + k0 * 2, wblk + k0, kP, tig);
      }
    // epilogue: +c2, BN3 affine, ReLU, bf16 -> t3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = wn * 32 + j * 8 + 2 * tig;
      float2 cc = ldg_f2(p.c2 + n), ss = ldg_f2(p.a3 + n), tt = ldg_f2(p.b3 + n);
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
      const __nv_bfloat16* wblk = p.w3t + (size_t)(nb + wn * 32 + g) * kP;
#pragma unroll 2
      for (int k0 = 0; k0 < kP; k0 += 16)
        mma_step_smem(acc, a_addr, k0 * 2, wblk + k0, kP, tig);
      // epilogue: +c3, bf16, + x, bf16 -> out
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int n = nb + wn * 32 + j * 8 + 2 * tig;
        float2 cc = ldg_f2(p.c3 + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int q = p0 + wm * 64 + i * 16 + g + 8 * h;
            if (q >= npixB) continue;
            size_t off = ((size_t)(r0 + q / W) * W + q % W) * C + n;
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

// impl 'chunked': grid (H/TR, B); each block recomputes its halo rows.
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_fwd_kernel(const BneckArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TR = p.TR, Wp = p.W + 2;
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);   // [(TR+2)*(W+2)][kLd]
  __nv_bfloat16* t3s = win + (size_t)(TR + 2) * Wp * kLd;         // [kChunk][kLd]
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const size_t img = (size_t)b * p.H * p.W * p.C;

  zero_pad_columns(win, TR + 2, p.W);
  conv1_rows(p, p.x + img, win, r0 - 1, 0, TR + 2);
  __syncthreads();
  conv2_conv3_rows(p, p.x + img, p.out + img, win, t3s, r0, min(TR, p.H - r0));
}

// impl 'image': grid (R, B), one cluster of R = H/TR blocks per image; block
// `rank` owns rows rank*TR .. rank*TR+TR-1 and computes conv1 for them only.
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_image_kernel(const BneckArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int TR = p.TR, Wp = p.W + 2;
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);   // [(TR+2)*(W+2)][kLd]
  __nv_bfloat16* t3s = win + (size_t)(TR + 2) * Wp * kLd;         // [kChunk][kLd]
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int r0 = rank * TR;
  const size_t img = (size_t)b * p.H * p.W * p.C;

  zero_pad_columns(win, TR + 2, p.W);
  conv1_rows(p, p.x + img, win, r0, 1, TR);
  cluster.sync();              // every block's t2 rows (and pad columns) written

  // halo: window row 0 <- rank-1's row TR, row TR+1 <- rank+1's row 1, in
  // 16-byte vectors over whole window rows (pad columns included, zero in
  // every block); zeros above and below the image
  const int vrow = Wp * kLd * 2 / 16;
  for (int e = threadIdx.x; e < 2 * vrow; e += kThreads) {
    const int below = e >= vrow, v = e - (below ? vrow : 0);
    const int nb = below ? rank + 1 : rank - 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (nb >= 0 && nb < R) {
      const __nv_bfloat16* src = win + (size_t)(below ? 1 : TR) * Wp * kLd;
      val = reinterpret_cast<const uint4*>(cluster.map_shared_rank(src, nb))[v];
    }
    reinterpret_cast<uint4*>(win + (size_t)(below ? TR + 1 : 0) * Wp * kLd)[v] = val;
  }
  cluster.sync();              // halos in place; no block leaves while read

  conv2_conv3_rows(p, p.x + img, p.out + img, win, t3s, r0, TR);
}

BneckArgs make_args(const void* x, void* out, const void* a1, const void* b1,
                    const void* w1t, const void* c1, const void* a2,
                    const void* b2, const void* w2t, const void* c2,
                    const void* a3, const void* b3, const void* w3t,
                    const void* c3, int H, int W, int C, int TR) {
  return BneckArgs{
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
      (const float*)a1, (const float*)b1, (const __nv_bfloat16*)w1t, (const float*)c1,
      (const float*)a2, (const float*)b2, (const __nv_bfloat16*)w2t, (const float*)c2,
      (const float*)a3, (const float*)b3, (const __nv_bfloat16*)w3t, (const float*)c3,
      H, W, C, TR};
}

int smem_bytes(int W, int TR) { return ((TR + 2) * (W + 2) + kChunk) * kLd * 2; }

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
  int smem = smem_bytes(W, TR);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + TR - 1) / TR, B);
  bottleneck_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      make_args(x, out, a1, b1, w1t, c1, a2, b2, w2t, c2, a3, b3, w3t, c3, H, W, C, TR));
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
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_bottleneck_image_fwd(const void* x, void* out,
                                        const void* a1, const void* b1, const void* w1t,
                                        const void* c1, const void* a2, const void* b2,
                                        const void* w2t, const void* c2, const void* a3,
                                        const void* b3, const void* w3t, const void* c3,
                                        int B, int H, int W, int C, int P, int TR,
                                        void* stream) {
  if (P != kP || C % kP != 0 || TR < 1 || B < 1 || H < 1 || W < 1 || H % TR != 0 ||
      H / TR > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = image_config(&cfg, &attr, B, W, TR, H / TR, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, bottleneck_image_kernel,
                           make_args(x, out, a1, b1, w1t, c1, a2, b2, w2t, c2, a3,
                                     b3, w3t, c3, H, W, C, TR));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
