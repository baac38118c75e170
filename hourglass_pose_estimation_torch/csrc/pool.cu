// 2x2 stride-2 max-pool, forward and backward (ties share the gradient, or
// the first maximum takes it).
//
// Replaces the TPU kernel `hourglass_pose_estimation_tpu/ops/pallas/
// pool.py::maxpool2x2_pallas`:
//   forward (`_fwd_kernel`):
//     out[b, y, x, c] = max_{i, j in {0, 1}} x[b, 2y + i, 2x + j, c]
//   backward (`_bwd_kernel`): recompute the window max m from x, then
//     dx[b, 2y + i, 2x + j, c] = g[b, y, x, c] / ties * [x == m]
//     with ties = how many of the four equal m: the gradient is split
//     equally among tied maxima, the Pallas convention.
//   backward, first-maximum mode: dx = g at the first of the window's four
//     elements in row-major order ((0,0), (0,1), (1,0), (1,1)) that equals m,
//     0 at the other three. That is the gradient of the JAX model's
//     `nn.max_pool` (XLA's select-and-scatter) and of `F.max_pool2d`, on
//     finite inputs; the model's pools take this mode. Without ties the two
//     modes agree.
// x/dx [B, H, W, C], out/g [B, H/2, W/2, C], NHWC, bf16 or f32, H and W even.
//
// What bounds it: device-memory bytes; both directions do a handful of
// comparisons per element. Forward: read x once, write out (a quarter of
// x) once. Backward: read x and g once, write dx once. Each thread owns one
// 16-byte vector along C of the pooled grid (8 bf16 or 4 f32 channels) and
// the four matching vectors of the window, so neighbouring threads touch
// neighbouring addresses. Values are compared in f32 (exact for bf16); the
// split backward divides in f32 and rounds once to the storage type, which
// is what the Pallas kernel's bf16 division gives; the first-maximum one
// copies g.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// lane k of a 16-byte vector as f32, and back
template <bool kBf16>
struct Lanes;

template <>
struct Lanes<true> {
  static constexpr int N = 8;
  __device__ static float get(const uint4& v, int k) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&v)[k]);
  }
  __device__ static void set(uint4& v, int k, float f) {
    reinterpret_cast<__nv_bfloat16*>(&v)[k] = __float2bfloat16_rn(f);
  }
};

template <>
struct Lanes<false> {
  static constexpr int N = 4;
  __device__ static float get(const uint4& v, int k) {
    return reinterpret_cast<const float*>(&v)[k];
  }
  __device__ static void set(uint4& v, int k, float f) {
    reinterpret_cast<float*>(&v)[k] = f;
  }
};

// vector index of the top-left tap of pooled vector v, and its pooled pixel
__device__ __forceinline__ long long window_origin(long long v, int Ho, int Wo,
                                                   int CV) {
  int c = (int)(v % CV);
  long long pix = v / CV;
  int x = (int)(pix % Wo);
  long long t = pix / Wo;
  int y = (int)(t % Ho);
  long long b = t / Ho;
  return ((b * 2 * Ho + 2 * y) * (2LL * Wo) + 2 * x) * CV + c;
}

template <bool kBf16>
__global__ void maxpool2x2_fwd_kernel(const uint4* __restrict__ x,
                                      uint4* __restrict__ out, long long nvec,
                                      int Ho, int Wo, int CV) {
  using L = Lanes<kBf16>;
  const long long row = 2LL * Wo * CV;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    long long o = window_origin(v, Ho, Wo, CV);
    uint4 t[4] = {__ldg(x + o), __ldg(x + o + CV), __ldg(x + o + row),
                  __ldg(x + o + row + CV)};
    uint4 r;
#pragma unroll
    for (int k = 0; k < L::N; ++k) {
      float m = L::get(t[0], k);
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        float f = L::get(t[i], k);
        m = f > m ? f : m;
      }
      L::set(r, k, m);
    }
    out[v] = r;
  }
}

template <bool kBf16, bool kFirstMax>
__global__ void maxpool2x2_bwd_kernel(const uint4* __restrict__ x,
                                      const uint4* __restrict__ g,
                                      uint4* __restrict__ dx, long long nvec,
                                      int Ho, int Wo, int CV) {
  using L = Lanes<kBf16>;
  const long long row = 2LL * Wo * CV;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    long long o = window_origin(v, Ho, Wo, CV);
    const long long at[4] = {o, o + CV, o + row, o + row + CV};
    uint4 t[4] = {__ldg(x + at[0]), __ldg(x + at[1]), __ldg(x + at[2]),
                  __ldg(x + at[3])};
    uint4 gv = __ldg(g + v);
    uint4 r[4];
#pragma unroll
    for (int k = 0; k < L::N; ++k) {
      float f[4];
      float m = L::get(t[0], k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[i] = L::get(t[i], k);
        m = f[i] > m ? f[i] : m;
      }
      if (kFirstMax) {
        bool taken = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool first = !taken && f[i] == m;
          taken = taken || first;
          L::set(r[i], k, first ? L::get(gv, k) : 0.f);
        }
      } else {
        float ties = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) ties += (f[i] == m) ? 1.f : 0.f;
        float share = L::get(gv, k) / ties;
#pragma unroll
        for (int i = 0; i < 4; ++i) L::set(r[i], k, f[i] == m ? share : 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dx[at[i]] = r[i];
  }
}

int grid_for(long long nvec, int num_sms) {
  long long blocks = (nvec + 255) / 256;
  long long cap = (long long)num_sms * 16;
  return (int)(blocks > cap ? cap : blocks);
}

}  // namespace

// x [B, H, W, C] -> out [B, H/2, W/2, C]. elem_bytes: 2 (bf16) or 4 (f32);
// C * elem_bytes must be a multiple of 16; H and W even.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_maxpool2x2_fwd(const void* x, void* out, int B, int H,
                                  int W, int C, int elem_bytes, int num_sms,
                                  void* stream) {
  if ((elem_bytes != 2 && elem_bytes != 4) || (C * elem_bytes) % 16 != 0 ||
      H % 2 != 0 || W % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int CV = C * elem_bytes / 16, Ho = H / 2, Wo = W / 2;
  const long long nvec = (long long)B * Ho * Wo * CV;
  if (nvec == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2)
    maxpool2x2_fwd_kernel<true><<<grid_for(nvec, num_sms), 256, 0, s>>>(
        (const uint4*)x, (uint4*)out, nvec, Ho, Wo, CV);
  else
    maxpool2x2_fwd_kernel<false><<<grid_for(nvec, num_sms), 256, 0, s>>>(
        (const uint4*)x, (uint4*)out, nvec, Ho, Wo, CV);
  return (int)cudaGetLastError();
}

// (x [B, H, W, C], g [B, H/2, W/2, C]) -> dx [B, H, W, C]; the same
// conditions as the forward; first_max: 1 for the first-maximum mode, 0 to
// split ties. Every element of dx is written.
extern "C" int hpe_maxpool2x2_bwd(const void* x, const void* g, void* dx,
                                  int B, int H, int W, int C, int elem_bytes,
                                  int first_max, int num_sms, void* stream) {
  if ((elem_bytes != 2 && elem_bytes != 4) || (C * elem_bytes) % 16 != 0 ||
      H % 2 != 0 || W % 2 != 0 || (first_max != 0 && first_max != 1))
    return (int)cudaErrorInvalidValue;
  const int CV = C * elem_bytes / 16, Ho = H / 2, Wo = W / 2;
  const long long nvec = (long long)B * Ho * Wo * CV;
  if (nvec == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(nvec, num_sms);
  const uint4 *xv = (const uint4*)x, *gv = (const uint4*)g;
  uint4* dxv = (uint4*)dx;
  if (elem_bytes == 2 && first_max)
    maxpool2x2_bwd_kernel<true, true><<<grid, 256, 0, s>>>(xv, gv, dxv, nvec, Ho, Wo, CV);
  else if (elem_bytes == 2)
    maxpool2x2_bwd_kernel<true, false><<<grid, 256, 0, s>>>(xv, gv, dxv, nvec, Ho, Wo, CV);
  else if (first_max)
    maxpool2x2_bwd_kernel<false, true><<<grid, 256, 0, s>>>(xv, gv, dxv, nvec, Ho, Wo, CV);
  else
    maxpool2x2_bwd_kernel<false, false><<<grid, 256, 0, s>>>(xv, gv, dxv, nvec, Ho, Wo, CV);
  return (int)cudaGetLastError();
}
