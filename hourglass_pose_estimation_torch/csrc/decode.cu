// Batched heatmap peak decode: first row-major argmax + quarter offset.
//
// Replaces the TPU kernel `hourglass_pose_estimation_tpu/ops/pallas/
// decode.py::decode_peaks_pallas` (`_decode_kernel`). Per (b, j):
//   maxval = max over (y, x) of hm[b, y, x, j]
//   (px, py) = first row-major position holding maxval
//   gx = hm[py, px+1] - hm[py, px-1], gy = hm[py+1, px] - hm[py-1, px]
//        (zero outside the map)
//   coords = (px, py) + 0.25 * (sign gx, sign gy) when 0 < px < W-1 and
//            0 < py < H-1, else (px, py)
// hm [B, H, W, J] f32 (NHWC) -> coords [B, J, 2], maxvals [B, J] f32.
// NaN follows torch.argmax and jnp.argmax (the XLA decoder the JAX
// serving function runs): NaN ranks above every number and the first NaN
// wins, its maxval is NaN, and a NaN gradient gives a NaN sign.
//
// What bounds it: device-memory bytes, the read of the maps (16.8 MB at
// [64, 64, 64, 16]: 5.0 us at 3.35 TB/s); the outputs are tiny. So the
// read has to reach every SM and keep enough bytes in flight:
//   * Each image is a thread-block cluster of K blocks (K <= 8, the
//     portable size); block k reads its slab of `rows` contiguous rows
//     (the last may be shorter) with 16-byte loads, a thread issuing 8
//     loads before it uses the first. K, the rows and the block size are
//     the Python wrapper's choice (`ops/hopper/decode.py::
//     decode_schedule`): about 256 blocks a launch, so 8 a cluster at
//     batch 1 (8 SMs read the image) and 4 at batch 64.
//   * A thread's lanes always meet the same joints: L * T (L = 4 floats a
//     load, 1 where W * J is not a multiple of 4; T threads) is a multiple
//     of J, so lane c of thread t meets joint (L * t + c) % J at every
//     step. Each lane keeps its running (max, first index).
//   * The block merges its lanes per joint (16 lanes a joint, shuffles)
//     and reads its winner's four neighbours. After a cluster barrier
//     block 0 reads the K partials of every joint at once from the other
//     blocks' shared memory (distributed shared memory), merges them by
//     shuffles and writes the outputs; a second barrier keeps every
//     block's shared memory alive until then. One launch, no atomics, no
//     scratch in device memory.
// The merge is a total order (NaN, then the larger value, then the
// smaller index), so the result does not depend on the order of merges.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kUnroll = 8;   // loads a thread issues before using the first

struct DecodeArgs {
  const float* hm;
  float* coords;
  float* maxvals;
  int H, W, J, rows;
};

// (v, i) ranks before (bv, bi): NaN above every number, then the larger
// value, then the smaller index
__device__ __forceinline__ bool ranks_before(float v, int i, float bv, int bi) {
  const bool n = v != v, bn = bv != bv;
  if (n || bn) return n && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// torch.sign: NaN for NaN
__device__ __forceinline__ float sign_nan(float g) {
  return g > 0.f ? 1.f : (g < 0.f ? -1.f : g);
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared memory of a block: the lanes' partials, then the block's
// per-joint partial (value, index, gx, gy) that block 0 of the cluster
// reads.
struct Parts {
  float* lane_v;
  int* lane_i;
  float* v;
  int* i;
  float* gx;
  float* gy;
};

__host__ __device__ inline size_t smem_bytes(int slots, int J) {
  return (size_t)slots * 8 + (size_t)J * 16;
}

__device__ __forceinline__ Parts carve(unsigned char* smem, int slots, int J) {
  Parts p;
  p.lane_v = reinterpret_cast<float*>(smem);
  p.lane_i = reinterpret_cast<int*>(p.lane_v + slots);
  p.v = reinterpret_cast<float*>(p.lane_i + slots);
  p.i = reinterpret_cast<int*>(p.v + J);
  p.gx = reinterpret_cast<float*>(p.i + J);
  p.gy = p.gx + J;
  return p;
}

// lane c's value x[c] at pixel q0[c] + q
template <int kL>
__device__ __forceinline__ void take(const float (&x)[kL], int q, const int (&q0)[kL],
                                     float (&best)[kL], int (&bi)[kL]) {
#pragma unroll
  for (int c = 0; c < kL; ++c)
    if (ranks_before(x[c], q0[c] + q, best[c], bi[c])) {
      best[c] = x[c];
      bi[c] = q0[c] + q;
    }
}

// This thread's running (max, first index) for each of its lanes over the
// rows [r0, r1) of image b: lane c meets joint (L t + c) % J at pixel
// q0[c] + s * qs of its s-th load.
template <int kJ, int kL>
__device__ __forceinline__ void scan_slab(const DecodeArgs& a, int b, int r0, int r1,
                                          float (&best)[kL], int (&bi)[kL]) {
  const int J = kJ ? kJ : a.J;
  const int T = blockDim.x, t = threadIdx.x;
  const int nl = (r1 - r0) * a.W * J / kL;   // loads of the slab
  const float* slab = a.hm + ((size_t)b * a.H + r0) * a.W * J;
  const int qs = kL * T / J;
  int q0[kL];
#pragma unroll
  for (int c = 0; c < kL; ++c) {
    q0[c] = r0 * a.W + (kL * t + c) / J;
    best[c] = -INFINITY;
    bi[c] = INT_MAX;
  }
  int l = t, s = 0;
  if constexpr (kL == 4) {
    const float4* s4 = reinterpret_cast<const float4*>(slab);
    for (; l + (kUnroll - 1) * T < nl; l += kUnroll * T, s += kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(s4 + l + u * T);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float v[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        take<4>(v, (s + u) * qs, q0, best, bi);
      }
    }
    for (; l < nl; l += T, ++s) {
      const float4 x = __ldg(s4 + l);
      const float v[4] = {x.x, x.y, x.z, x.w};
      take<4>(v, s * qs, q0, best, bi);
    }
  } else {
    for (; l + (kUnroll - 1) * T < nl; l += kUnroll * T, s += kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(slab + l + u * T);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float v[1] = {x[u]};
        take<1>(v, (s + u) * qs, q0, best, bi);
      }
    }
    for (; l < nl; l += T, ++s) {
      const float v[1] = {__ldg(slab + l)};
      take<1>(v, s * qs, q0, best, bi);
    }
  }
}

// (v, i, gx, gy) of the lane `o` away (xor) replaces this lane's when it
// ranks before it
__device__ __forceinline__ void merge_from(int o, float& v, int& i, float& gx, float& gy) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, o);
  const int oi = __shfl_xor_sync(0xffffffffu, i, o);
  const float ogx = __shfl_xor_sync(0xffffffffu, gx, o);
  const float ogy = __shfl_xor_sync(0xffffffffu, gy, o);
  if (ranks_before(ov, oi, v, i)) {
    v = ov;
    i = oi;
    gx = ogx;
    gy = ogy;
  }
}

// The block's lanes -> its per-joint partial in p.v and p.i, and its
// winner's gradients in p.gx and p.gy (zero where the edge gate is shut). A group of 16 lanes per joint (whole warps only: a partial
// last warp sits out) merges the slots j, j + J, ... by shuffles; its
// first lane reads the winner's four neighbours at once. Not synchronised
// at the end.
template <int kJ, int kL>
__device__ __forceinline__ void block_merge(const DecodeArgs& a, const Parts& p, int b,
                                            const float (&best)[kL], const int (&bi)[kL]) {
  const int J = kJ ? kJ : a.J;
  const int T = blockDim.x, t = threadIdx.x;
  const int slots = kL * T;
#pragma unroll
  for (int c = 0; c < kL; ++c) {
    p.lane_v[kL * t + c] = best[c];
    p.lane_i[kL * t + c] = bi[c];
  }
  __syncthreads();
  const int groups = (T >> 5) * 2, group = t >> 4, g = t & 15;
  const int per_joint = slots / J;
  const float* img = a.hm + (size_t)b * a.H * a.W * J;
  for (int j0 = 0; group < groups && j0 < J; j0 += groups) {
    const int j = j0 + group;
    float v = -INFINITY, gx = 0.f, gy = 0.f;
    int i = INT_MAX;
    for (int s = g; j < J && s < per_joint; s += 16) {
      const float sv = p.lane_v[j + J * s];
      const int si = p.lane_i[j + J * s];
      if (ranks_before(sv, si, v, i)) {
        v = sv;
        i = si;
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) merge_from(o, v, i, gx, gy);
    if (g == 0 && j < J) {
      if (i != INT_MAX) {
        const int px = i % a.W, py = i / a.W;
        if (px > 0 && px < a.W - 1 && py > 0 && py < a.H - 1) {
          const float* at = img + (size_t)i * J + j;
          gx = __ldg(at + J) - __ldg(at - J);
          gy = __ldg(at + (size_t)a.W * J) - __ldg(at - (size_t)a.W * J);
        }
      }
      p.v[j] = v;
      p.i[j] = i;
      p.gx[j] = gx;
      p.gy[j] = gy;
    }
  }
}

// The cluster's K partials -> outputs: after a cluster barrier, block 0
// reads every block's partial of every joint at once from distributed
// shared memory (8 lanes a joint, lane r reading block r) and merges them
// by shuffles; a second barrier keeps every block's shared memory alive
// until then.
template <int kJ>
__device__ __forceinline__ void cluster_merge(const DecodeArgs& a, const Parts& p, int b) {
  const int J = kJ ? kJ : a.J;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  if (K > 1) cluster_sync_all();
  else __syncthreads();
  if (cluster.block_rank() == 0) {
    const int t = threadIdx.x, warps = blockDim.x >> 5;
    for (int s0 = (t >> 5) * 32; t >> 5 < warps && s0 < 8 * J; s0 += warps * 32) {
      const int s = s0 + (t & 31), j = s >> 3, r = s & 7;
      float v = -INFINITY, gx = 0.f, gy = 0.f;
      int i = INT_MAX;
      if (j < J && r < K) {
        v = cluster.map_shared_rank(p.v, r)[j];
        i = cluster.map_shared_rank(p.i, r)[j];
        gx = cluster.map_shared_rank(p.gx, r)[j];
        gy = cluster.map_shared_rank(p.gy, r)[j];
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) merge_from(o, v, i, gx, gy);
      if (r == 0 && j < J) {
        if (i == INT_MAX) i = 0;   // no element: H * W == 0 is refused
        const int px = i % a.W, py = i / a.W;
        const bool ok = px > 0 && px < a.W - 1 && py > 0 && py < a.H - 1;
        const size_t o = (size_t)b * J + j;
        a.coords[2 * o + 0] = (float)px + (ok ? sign_nan(gx) * 0.25f : 0.f);
        a.coords[2 * o + 1] = (float)py + (ok ? sign_nan(gy) * 0.25f : 0.f);
        a.maxvals[o] = v;
      }
    }
  }
  if (K > 1) cluster_sync_all();
}

template <int kJ, int kL>
__global__ void __launch_bounds__(kJ ? 512 : 1024) decode_peaks_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const Parts p = carve(decode_smem, kL * blockDim.x, kJ ? kJ : a.J);
  float best[kL];
  int bi[kL];
  scan_slab<kJ, kL>(a, b, rank * a.rows, min(a.H, (rank + 1) * a.rows), best, bi);
  block_merge<kJ, kL>(a, p, b, best, bi);
  cluster_merge<kJ>(a, p, b);
}

// grid K * B blocks of T threads, clusters of K
cudaError_t launch(void (*fn)(DecodeArgs), const DecodeArgs& a, int B, int K, int T, size_t smem,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * B, 1, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fn, a);
}

}  // namespace

// K blocks an image (a cluster), `rows` rows a block, T threads a block,
// L floats a load (4 or 1): `ops/hopper/decode.py::decode_schedule`.
// Returns the launch's error (0 = launched).
extern "C" int hpe_decode_peaks(const void* hm, void* coords, void* maxvals,
                                int B, int H, int W, int J, int K, int rows, int T, int L,
                                void* stream) {
  if (J < 1 || J > 1024 || H < 1 || W < 1 || B < 0 || K < 1 || K > kMaxCluster || rows < 1 ||
      (long long)K * rows < H || (long long)(K - 1) * rows >= H || T < 32 || T > 1024 ||
      (L != 4 && L != 1) || (L * T) % J != 0 || (L == 4 && (W * J) % 4 != 0) ||
      (long long)H * W * J >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (L == 4 && (reinterpret_cast<uintptr_t>(hm) & 15u)) return (int)cudaErrorMisalignedAddress;
  const DecodeArgs a{(const float*)hm, (float*)coords, (float*)maxvals, H, W, J, rows};
  auto fn = L == 4 ? (J == 16 ? decode_peaks_kernel<16, 4>
                      : J == 17 ? decode_peaks_kernel<17, 4> : decode_peaks_kernel<0, 4>)
                   : (J == 16 ? decode_peaks_kernel<16, 1>
                      : J == 17 ? decode_peaks_kernel<17, 1> : decode_peaks_kernel<0, 1>);
  // at most 48 KB (L T <= 4096 slots, J <= 1024): no opt-in needed
  const cudaError_t err = launch(fn, a, B, K, T, smem_bytes(L * T, J), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
