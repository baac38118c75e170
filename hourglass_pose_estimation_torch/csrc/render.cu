// Gaussian heatmap target render.
//
// Replaces the TPU kernel `hourglass_pose_estimation_tpu/ops/pallas/
// render.py::render_gaussian_targets_pallas` (`_render_kernel`). From the
// integer peaks and weights of the shared preamble (`ops/heatmap.py::
// render_preamble`), per (b, y, x, j):
//   dx = x - mu[b, j, 0], dy = y - mu[b, j, 1]             (int32)
//   target = exp(-(dy*dy + dx*dx) / (2 sigma^2))  when |dx| <= tmp,
//            |dy| <= tmp and weight[b, j] > 0.5, else 0  (tmp = int(3 sigma))
// mu [B, J, 2] int32, weight [B, J] f32 -> target [B, H, W, J] f32 (NHWC).
//
// What bounds it: device-memory bytes, the write of the target (16.8 MB
// at [64, 64, 64, 16]: 5.0 us at 3.35 TB/s); the inputs are J * 3 words an
// image. So the kernel does little besides storing:
//   * grid (B, row tiles of TR rows), 256 threads. A block loads its
//     image's peaks into shared memory, then one warp per row ballots, for
//     each row of its tile, the joints whose window the row crosses
//     (weight > 0.5 and |y - mu_y| <= tmp): a row mask of J bits.
//   * Each thread writes 16-byte vectors of the row's W * J contiguous
//     floats with evict-first stores (st.global.cs.v4: the target is read
//     by the loss later, not by this kernel). A vector whose joints' bits
//     are all clear is a zero store; expf runs only inside a window (about
//     49 * J values an image at sigma 1).
//   * All index arithmetic is 32-bit: x = k / J and j = k - x * J within a
//     row, J a compile-time constant for 16 (MPII) and 17 (COCO), any
//     other J at run time. A row that does not start on 16 bytes (W * J
//     not a multiple of 4) writes its first and last floats one by one.
// The square is taken in int32 only inside the window (outside it a
// far-off peak could overflow), then in f32 like the plain version; expf
// (not __expf) keeps full single precision: at most 1 ulp from it, equal
// at sigma = 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFar = -(1 << 29);   // the row peak of an inactive joint: no row is within tmp of it

struct RenderArgs {
  const int* mu;
  const float* weight;
  float* out;
  int H, W, J, TR, tmp;
  float two_sigma2;
};

// Shared memory of a block: the peaks (mx, my; my = kFar where the joint
// is inactive) and the tile's row masks, NW = ceil(J / 32) words a row.
struct Tile {
  const int* mx;
  const int* my;
  const uint32_t* mask;
  int NW;
};

template <int kJ>
__device__ __forceinline__ Tile load_tile(const RenderArgs& a, int* smem, int b, int y0,
                                          int rows) {
  const int J = kJ ? kJ : a.J;
  const int NW = (J + 31) >> 5;
  int* mx = smem;
  int* my = mx + J;
  uint32_t* mask = reinterpret_cast<uint32_t*>(my + J);
  for (int j = threadIdx.x; j < J; j += kThreads) {
    const int2 m = __ldg(reinterpret_cast<const int2*>(a.mu) + b * J + j);
    mx[j] = m.x;
    my[j] = __ldg(a.weight + b * J + j) > 0.5f ? m.y : kFar;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const int y = y0 + r;
    for (int w = 0; w < NW; ++w) {
      const int j = 32 * w + lane;
      const bool in = j < J && abs(y - my[j]) <= a.tmp;
      const uint32_t bits = __ballot_sync(0xffffffffu, in);
      if (lane == 0) mask[r * NW + w] = bits;
    }
  }
  __syncthreads();
  return Tile{mx, my, mask, NW};
}

// the target at (y, x, j) of a row whose mask is `m`
__device__ __forceinline__ float value(const RenderArgs& a, const Tile& t, const uint32_t* m,
                                       int y, int x, int j) {
  if (!((m[j >> 5] >> (j & 31)) & 1u)) return 0.f;
  const int dx = x - t.mx[j];
  if (abs(dx) > a.tmp) return 0.f;
  const int dy = y - t.my[j];
  const float d2 = (float)(dy * dy) + (float)(dx * dx);
  return expf(-d2 / a.two_sigma2);
}

// the 4 floats of a row starting at element k (pixel k / J, joint k % J)
template <int kJ>
__device__ __forceinline__ float4 value4(const RenderArgs& a, const Tile& t, const uint32_t* m,
                                         int y, int k) {
  const int J = kJ ? kJ : a.J;
  int x = k / J;
  int j = k - x * J;
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = value(a, t, m, y, x, j);
    if (++j == J) {
      j = 0;
      ++x;
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int kJ>
__global__ void __launch_bounds__(kThreads) render_gaussian_kernel(RenderArgs a) {
  extern __shared__ int render_smem[];
  const int J = kJ ? kJ : a.J;
  const int b = blockIdx.x, y0 = blockIdx.y * a.TR;
  const int rows = min(a.TR, a.H - y0);
  const Tile t = load_tile<kJ>(a, render_smem, b, y0, rows);
  const int WJ = a.W * J;
  for (int r = 0; r < rows; ++r) {
    const int y = y0 + r;
    const uint32_t* m = t.mask + r * t.NW;
    bool any = false;
    for (int w = 0; w < t.NW; ++w) any |= m[w] != 0u;
    float* row = a.out + ((size_t)b * a.H + y) * WJ;
    // floats before the row's first 16-byte boundary, then vectors, then the rest
    const int head = min(WJ, (int)((16u - ((uint32_t)(uintptr_t)row & 15u)) & 15u) >> 2);
    const int nv = (WJ - head) >> 2;
    float4* vec = reinterpret_cast<float4*>(row + head);
    if (!any) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int v = threadIdx.x; v < nv; v += kThreads) __stcs(vec + v, z);
      for (int k = threadIdx.x; k < head; k += kThreads) __stcs(row + k, 0.f);
      for (int k = head + 4 * nv + threadIdx.x; k < WJ; k += kThreads) __stcs(row + k, 0.f);
      continue;
    }
    for (int v = threadIdx.x; v < nv; v += kThreads)
      __stcs(vec + v, value4<kJ>(a, t, m, y, head + 4 * v));
    for (int k = threadIdx.x; k < head; k += kThreads)
      __stcs(row + k, value(a, t, m, y, k / J, k % J));
    for (int k = head + 4 * nv + threadIdx.x; k < WJ; k += kThreads)
      __stcs(row + k, value(a, t, m, y, k / J, k % J));
  }
}

// rows a block writes: the most that still gives every SM 8 blocks
int tile_rows(int B, int H, int num_sms) {
  const long long want = (long long)num_sms * 8;
  int tr = (int)(((long long)B * H + want - 1) / want);
  return tr < 1 ? 1 : (tr > H ? H : tr);
}

}  // namespace

// two_sigma2 = 2 * sigma^2 as f32, tmp = int(3 * sigma).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_render_gaussian(const void* mu, const void* weight,
                                   void* out, int B, int H, int W, int J,
                                   int tmp, float two_sigma2, int num_sms,
                                   void* stream) {
  if (H < 1 || W < 1 || J < 1 || tmp < 0 || (long long)H * W * J >= (1LL << 31) ||
      (long long)B * J >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  RenderArgs a{(const int*)mu, (const float*)weight, (float*)out, H, W, J, 0, tmp, two_sigma2};
  a.TR = tile_rows(B, H, num_sms);
  const dim3 grid(B, (H + a.TR - 1) / a.TR);
  const size_t smem = (size_t)(2 * J + a.TR * ((J + 31) / 32)) * 4;   // 8 KB at J = 1024
  cudaStream_t s = (cudaStream_t)stream;
  if (J == 16)
    render_gaussian_kernel<16><<<grid, kThreads, smem, s>>>(a);
  else if (J == 17)
    render_gaussian_kernel<17><<<grid, kThreads, smem, s>>>(a);
  else
    render_gaussian_kernel<0><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
