// Variants of the render and decode kernels, timed against the package's
// kernels by `experiments/render_decode_probe.py`; none is on a package
// path. The package's sources are included, so a variant shares their
// helpers and differs only where it says.
//
//   hpe_fill_zero_cs         float4 stores of zeros with the evict-first
//                            hint (st.global.cs.v4) over n4 vectors: the
//                            floor of a kernel that only writes, the
//                            render's store stream without its arithmetic.
//   hpe_render_gaussian_tma  the render with its row tile built in shared
//                            memory and written by one TMA bulk store
//                            (cp.async.bulk.global.shared::cta) instead of
//                            st.global.cs.v4 from registers; W * J a
//                            multiple of 4.
//   hpe_decode_peaks_bulk    the decode with each block's slab copied into
//                            shared memory by one TMA bulk copy under an
//                            mbarrier, then scanned there, instead of
//                            unrolled 16-byte loads; L = 4 only.
//   hpe_decode_peaks_push    the decode with every other block pushing its
//                            partials into block 0's shared memory and
//                            arriving on block 0's mbarrier (one wait on
//                            the critical path, none before leaving)
//                            instead of block 0 pulling them between two
//                            cluster barriers.
//   hpe_decode_peaks_serial  the pull with block 0 walking the blocks one
//                            after another (one thread a joint) instead
//                            of reading them at once.
//   hpe_decode_peaks_l2hint  the decode with a 256-byte L2 prefetch hint on
//                            each 16-byte load.
//   hpe_decode_scan_only     the read and each block's merge (its
//                            winner's neighbours read), without the
//                            cluster barriers and merge: what the rest
//                            costs. maxvals and coords hold B * K * J
//                            floats each; no output.

#include "../hourglass_pose_estimation_torch/csrc/decode.cu"
#include "../hourglass_pose_estimation_torch/csrc/render.cu"

namespace {

__global__ void fill_zero_cs_kernel(float4* __restrict__ out, long long n4) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x)
    __stcs(out + i, z);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kJ>
__global__ void __launch_bounds__(kThreads) render_tma_kernel(RenderArgs a) {
  extern __shared__ __align__(128) float4 stage[];
  const int J = kJ ? kJ : a.J;
  const int b = blockIdx.x, y0 = blockIdx.y * a.TR;
  const int rows = min(a.TR, a.H - y0);
  const int nv = a.W * J / 4;
  const Tile t = load_tile<kJ>(a, reinterpret_cast<int*>(stage + a.TR * nv), b, y0, rows);
  for (int r = 0; r < rows; ++r) {
    const uint32_t* m = t.mask + r * t.NW;
    for (int v = threadIdx.x; v < nv; v += kThreads)
      stage[r * nv + v] = value4<kJ>(a, t, m, y0 + r, 4 * v);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    float* dst = a.out + ((size_t)b * a.H + y0) * nv * 4;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(smem_addr(stage)), "r"(rows * nv * 16)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int kJ>
__global__ void __launch_bounds__(512) decode_bulk_kernel(DecodeArgs a) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  const int J = kJ ? kJ : a.J;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const int T = blockDim.x, t = threadIdx.x;
  const int r0 = rank * a.rows, r1 = min(a.H, r0 + a.rows);
  const int nl = (r1 - r0) * a.W * J / 4;
  const float4* slab = reinterpret_cast<const float4*>(a.hm + ((size_t)b * a.H + r0) * a.W * J);
  float4* buf = reinterpret_cast<float4*>(dsmem);
  const int cap = a.rows * a.W * J / 4;   // the largest slab's vectors
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + cap);
  const uint32_t b_addr = smem_addr(bar);
  const Parts p = carve(reinterpret_cast<unsigned char*>(bar + 1), 4 * T, J);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b_addr),
                 "r"(nl * 16)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(buf)), "l"(slab), "r"(nl * 16), "r"(b_addr)
        : "memory");
  }
  // a wait that cannot end traps, so the launch fails instead of hanging
  for (uint32_t ok = 0, n = 0; !ok; ++n) {
    if (n == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], 0;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(ok)
        : "r"(b_addr)
        : "memory");
  }
  const int qs = 4 * T / J;
  int q0[4];
  float best[4];
  int bi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q0[c] = r0 * a.W + (4 * t + c) / J;
    best[c] = -INFINITY;
    bi[c] = INT_MAX;
  }
  for (int l = t, s = 0; l < nl; l += T, ++s) {
    const float4 x = buf[l];
    const float v[4] = {x.x, x.y, x.z, x.w};
    take<4>(v, s * qs, q0, best, bi);
  }
  block_merge<kJ, 4>(a, p, b, best, bi);
  cluster_merge<kJ>(a, p, b);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Block 0's inbox: a barrier, then kMaxCluster rows of J partials (value,
// index, gx, gy), row r block r's.
struct Inbox {
  uint64_t* bar;
  float* v;
  int* i;
  float* gx;
  float* gy;
};

__device__ __forceinline__ Inbox carve_inbox(unsigned char* at, int J) {
  Inbox x;
  x.bar = reinterpret_cast<uint64_t*>(at);
  x.v = reinterpret_cast<float*>(at + 16);
  x.i = reinterpret_cast<int*>(x.v + kMaxCluster * J);
  x.gx = reinterpret_cast<float*>(x.i + kMaxCluster * J);
  x.gy = x.gx + kMaxCluster * J;
  return x;
}

template <int kJ>
__global__ void __launch_bounds__(512) decode_push_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char usmem[];
  const int J = kJ ? kJ : a.J;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const Parts p = carve(usmem, 4 * blockDim.x, J);
  const Inbox box = carve_inbox(usmem + smem_bytes(4 * blockDim.x, J), J);
  // block 0 readies its barrier for the (K - 1) * J partials before every
  // thread arrives at the cluster barrier; the wait comes after the scan
  if (K > 1) {
    if (rank == 0 && threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(box.bar)),
                   "r"((K - 1) * J)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive();
  }
  float best[4];
  int bi[4];
  scan_slab<kJ, 4>(a, b, rank * a.rows, min(a.H, (rank + 1) * a.rows), best, bi);
  block_merge<kJ, 4>(a, p, b, best, bi);
  __syncthreads();
  if (K > 1) cluster_wait();
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const int o = rank * J + j;
    cluster.map_shared_rank(box.v, 0)[o] = p.v[j];
    cluster.map_shared_rank(box.i, 0)[o] = p.i[j];
    cluster.map_shared_rank(box.gx, 0)[o] = p.gx[j];
    cluster.map_shared_rank(box.gy, 0)[o] = p.gy[j];
    if (rank != 0)
      asm volatile(
          "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, 0;\n"
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
              smem_addr(box.bar))
          : "memory");
  }
  if (rank != 0) return;
  __syncthreads();
  if (K > 1)
    for (uint32_t ok = 0, n = 0; !ok; ++n) {
      if (n == (1u << 24)) __trap();
      asm volatile(
          "{\n.reg .pred P1;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], 0;\n"
          "selp.u32 %0, 1, 0, P1;\n}\n"
          : "=r"(ok)
          : "r"(smem_addr(box.bar))
          : "memory");
    }
  const int t = threadIdx.x, warps = blockDim.x >> 5;
  for (int s0 = (t >> 5) * 32; t >> 5 < warps && s0 < 8 * J; s0 += warps * 32) {
    const int s = s0 + (t & 31), j = s >> 3, r = s & 7;
    float v = -INFINITY, gx = 0.f, gy = 0.f;
    int i = INT_MAX;
    if (j < J && r < K) {
      v = box.v[r * J + j];
      i = box.i[r * J + j];
      gx = box.gx[r * J + j];
      gy = box.gy[r * J + j];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) merge_from(o, v, i, gx, gy);
    if (r == 0 && j < J) {
      if (i == INT_MAX) i = 0;
      const int px = i % a.W, py = i / a.W;
      const bool ok = px > 0 && px < a.W - 1 && py > 0 && py < a.H - 1;
      const size_t o = (size_t)b * J + j;
      a.coords[2 * o + 0] = (float)px + (ok ? sign_nan(gx) * 0.25f : 0.f);
      a.coords[2 * o + 1] = (float)py + (ok ? sign_nan(gy) * 0.25f : 0.f);
      a.maxvals[o] = v;
    }
  }
}

// the package's scan with a 256-byte L2 prefetch on each 16-byte load
// (ld.global.nc.L2::256B.v4), then its merges
template <int kJ>
__global__ void __launch_bounds__(512) decode_l2hint_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char hsmem[];
  const int J = kJ ? kJ : a.J;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const Parts p = carve(hsmem, 4 * blockDim.x, J);
  const int T = blockDim.x, t = threadIdx.x;
  const int r0 = rank * a.rows, r1 = min(a.H, r0 + a.rows);
  const int nl = (r1 - r0) * a.W * J / 4;
  const float4* s4 = reinterpret_cast<const float4*>(a.hm + ((size_t)b * a.H + r0) * a.W * J);
  const int qs = 4 * T / J;
  int q0[4];
  float best[4];
  int bi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q0[c] = r0 * a.W + (4 * t + c) / J;
    best[c] = -INFINITY;
    bi[c] = INT_MAX;
  }
  int l = t, s = 0;
  for (; l + (kUnroll - 1) * T < nl; l += kUnroll * T, s += kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x[u].x), "=f"(x[u].y), "=f"(x[u].z), "=f"(x[u].w)
                   : "l"(s4 + l + u * T));
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
  block_merge<kJ, 4>(a, p, b, best, bi);
  cluster_merge<kJ>(a, p, b);
}

// the pull with one thread a joint walking blocks 1..K-1 in turn
template <int kJ>
__device__ __forceinline__ void cluster_merge_serial(const DecodeArgs& a, const Parts& p, int b) {
  const int J = kJ ? kJ : a.J;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  if (K > 1) cluster_sync_all();
  else __syncthreads();
  if (cluster.block_rank() == 0) {
    for (int j = threadIdx.x; j < J; j += blockDim.x) {
      float v = p.v[j], gx = p.gx[j], gy = p.gy[j];
      int i = p.i[j];
      for (int r = 1; r < K; ++r) {
        const float rv = cluster.map_shared_rank(p.v, r)[j];
        const int ri = cluster.map_shared_rank(p.i, r)[j];
        if (ranks_before(rv, ri, v, i)) {
          v = rv;
          i = ri;
          gx = cluster.map_shared_rank(p.gx, r)[j];
          gy = cluster.map_shared_rank(p.gy, r)[j];
        }
      }
      if (i == INT_MAX) i = 0;
      const int px = i % a.W, py = i / a.W;
      const bool ok = px > 0 && px < a.W - 1 && py > 0 && py < a.H - 1;
      const size_t o = (size_t)b * J + j;
      a.coords[2 * o + 0] = (float)px + (ok ? sign_nan(gx) * 0.25f : 0.f);
      a.coords[2 * o + 1] = (float)py + (ok ? sign_nan(gy) * 0.25f : 0.f);
      a.maxvals[o] = v;
    }
  }
  if (K > 1) cluster_sync_all();
}

template <int kJ>
__global__ void __launch_bounds__(512) decode_serial_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char ssmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const Parts p = carve(ssmem, 4 * blockDim.x, kJ ? kJ : a.J);
  float best[4];
  int bi[4];
  scan_slab<kJ, 4>(a, b, rank * a.rows, min(a.H, (rank + 1) * a.rows), best, bi);
  block_merge<kJ, 4>(a, p, b, best, bi);
  cluster_merge_serial<kJ>(a, p, b);
}

// the read and the block's merge alone: each block writes its partial
// maxval of each joint to maxvals[blockIdx.x * J + j] and its index to
// coords (as bits); no cluster barrier, no output (a timing probe)
template <int kJ>
__global__ void __launch_bounds__(512) decode_scan_only_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char osmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const int J = kJ ? kJ : a.J;
  const Parts p = carve(osmem, 4 * blockDim.x, J);
  float best[4];
  int bi[4];
  scan_slab<kJ, 4>(a, b, rank * a.rows, min(a.H, (rank + 1) * a.rows), best, bi);
  block_merge<kJ, 4>(a, p, b, best, bi);
  __syncthreads();
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    a.maxvals[(size_t)blockIdx.x * J + j] = p.v[j];
    a.coords[(size_t)blockIdx.x * J + j] = __int_as_float(p.i[j]);
  }
}

}  // namespace

extern "C" int hpe_fill_zero_cs(void* out, long long n4, int blocks, void* stream) {
  if (n4 <= 0) return (int)cudaSuccess;
  fill_zero_cs_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((float4*)out, n4);
  return (int)cudaGetLastError();
}

// the arguments of hpe_render_gaussian
extern "C" int hpe_render_gaussian_tma(const void* mu, const void* weight, void* out, int B,
                                       int H, int W, int J, int tmp, float two_sigma2,
                                       int num_sms, void* stream) {
  if (H < 1 || W < 1 || J < 1 || tmp < 0 || (W * J) % 4 != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  RenderArgs a{(const int*)mu, (const float*)weight, (float*)out, H, W, J, 0, tmp, two_sigma2};
  a.TR = tile_rows(B, H, num_sms);
  const dim3 grid(B, (H + a.TR - 1) / a.TR);
  const size_t smem = (size_t)a.TR * W * J * 4 + (size_t)(2 * J + a.TR * ((J + 31) / 32)) * 4;
  auto fn = J == 16 ? render_tma_kernel<16> : J == 17 ? render_tma_kernel<17> : render_tma_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the arguments of hpe_decode_peaks (L must be 4)
extern "C" int hpe_decode_peaks_bulk(const void* hm, void* coords, void* maxvals, int B, int H,
                                     int W, int J, int K, int rows, int T, int L, void* stream) {
  if (L != 4 || (W * J) % 4 != 0 || (4 * T) % J != 0 || K < 1 || K > kMaxCluster || B < 1 ||
      T > 512)
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{(const float*)hm, (float*)coords, (float*)maxvals, H, W, J, rows};
  const size_t smem = (size_t)rows * W * J * 4 + 16 + smem_bytes(4 * T, J);
  auto fn = J == 16 ? decode_bulk_kernel<16> : J == 17 ? decode_bulk_kernel<17>
                                                       : decode_bulk_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = launch(fn, a, B, K, T, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the arguments of hpe_decode_peaks (L must be 4)
extern "C" int hpe_decode_peaks_serial(const void* hm, void* coords, void* maxvals, int B, int H,
                                       int W, int J, int K, int rows, int T, int L,
                                       void* stream) {
  if (L != 4 || (W * J) % 4 != 0 || (4 * T) % J != 0 || K < 1 || K > kMaxCluster || B < 1 ||
      T > 512)
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{(const float*)hm, (float*)coords, (float*)maxvals, H, W, J, rows};
  auto fn = J == 16 ? decode_serial_kernel<16> : J == 17 ? decode_serial_kernel<17>
                                                         : decode_serial_kernel<0>;
  const cudaError_t err = launch(fn, a, B, K, T, smem_bytes(4 * T, J),
                                 (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the arguments of hpe_decode_peaks (L must be 4); see decode_scan_only_kernel
extern "C" int hpe_decode_scan_only(const void* hm, void* coords, void* maxvals, int B, int H,
                                    int W, int J, int K, int rows, int T, int L, void* stream) {
  if (L != 4 || (W * J) % 4 != 0 || (4 * T) % J != 0 || K < 1 || K > kMaxCluster || B < 1 ||
      T > 512)
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{(const float*)hm, (float*)coords, (float*)maxvals, H, W, J, rows};
  auto fn = J == 16 ? decode_scan_only_kernel<16> : J == 17 ? decode_scan_only_kernel<17>
                                                            : decode_scan_only_kernel<0>;
  const cudaError_t err = launch(fn, a, B, K, T, smem_bytes(4 * T, J),
                                 (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the arguments of hpe_decode_peaks (L must be 4)
extern "C" int hpe_decode_peaks_push(const void* hm, void* coords, void* maxvals, int B, int H,
                                     int W, int J, int K, int rows, int T, int L, void* stream) {
  if (L != 4 || (W * J) % 4 != 0 || (4 * T) % J != 0 || K < 1 || K > kMaxCluster || B < 1 ||
      T > 512)
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{(const float*)hm, (float*)coords, (float*)maxvals, H, W, J, rows};
  auto fn = J == 16 ? decode_push_kernel<16> : J == 17 ? decode_push_kernel<17>
                                                       : decode_push_kernel<0>;
  const size_t smem = smem_bytes(4 * T, J) + 16 + (size_t)kMaxCluster * J * 16;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = launch(fn, a, B, K, T, smem, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the arguments of hpe_decode_peaks (L must be 4)
extern "C" int hpe_decode_peaks_l2hint(const void* hm, void* coords, void* maxvals, int B, int H,
                                       int W, int J, int K, int rows, int T, int L,
                                       void* stream) {
  if (L != 4 || (W * J) % 4 != 0 || (4 * T) % J != 0 || K < 1 || K > kMaxCluster || B < 1 ||
      T > 512)
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{(const float*)hm, (float*)coords, (float*)maxvals, H, W, J, rows};
  auto fn = J == 16 ? decode_l2hint_kernel<16> : J == 17 ? decode_l2hint_kernel<17>
                                                         : decode_l2hint_kernel<0>;
  const cudaError_t err = launch(fn, a, B, K, T, smem_bytes(4 * T, J), (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
