// Fused nearest-2x upsample + skip-add, forward and backward.
//
// Replaces the TPU kernel `hourglass_pose_estimation_tpu/ops/pallas/
// upsample.py::upsample2x_add_pallas`:
//   forward (`_fwd_kernel`):
//     out[b, y, x, c] = low[b, y / 2, x / 2, c] + skip[b, y, x, c]
//   backward of low (`_bwd_kernel` / `_bwd_low`), a 2x2 block sum of g:
//     d_low[b, y, x, c] = sum_{i, j in {0, 1}} g[b, 2y + i, 2x + j, c]
//     (d_skip = g needs no kernel)
// low/d_low [B, H, W, C], skip/out/g [B, 2H, 2W, C], NHWC, bf16 or f32.
//
// What bounds it: no arithmetic to speak of, so device-memory bytes:
// read skip and low once each, write out once. The upsampled low is never
// materialised; each thread moves one 16-byte vector along C (8 bf16 or
// 4 f32) of skip/out and reads the matching vector of low, which the four
// output pixels of a 2x2 block share through L2. The sum is taken in f32
// and rounded once, as PyTorch's elementwise add does. Any H and W.
//
// The backward is bound the same way: read g once, write d_low (a quarter
// of g) once. Each thread owns one 16-byte vector of d_low and reads the
// four matching vectors of g. The four taps are summed in f32 in the order
// ((g00 + g01) + g10) + g11 and rounded once; the Pallas kernel sums in
// g's dtype, so in bf16 the two may differ in the last bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 add_vec_bf16(uint4 a, uint4 b) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 fa = __bfloat1622float2(pa[k]);
    float2 fb = __bfloat1622float2(pb[k]);
    pr[k] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
  }
  return r;
}

__device__ __forceinline__ uint4 add_vec_f32(uint4 a, uint4 b) {
  float4 fa = *reinterpret_cast<float4*>(&a);
  float4 fb = *reinterpret_cast<float4*>(&b);
  float4 fr = make_float4(fa.x + fb.x, fa.y + fb.y, fa.z + fb.z, fa.w + fb.w);
  return *reinterpret_cast<uint4*>(&fr);
}

template <bool kBf16>
__global__ void upsample2x_add_kernel(const uint4* __restrict__ low,
                                      const uint4* __restrict__ skip,
                                      uint4* __restrict__ out, long long nvec,
                                      int H, int W, int CV) {
  const int W2 = 2 * W, H2 = 2 * H;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    int c = (int)(v % CV);
    long long pix = v / CV;
    int xo = (int)(pix % W2);
    long long t = pix / W2;
    int yo = (int)(t % H2);
    long long b = t / H2;
    long long li = ((b * H + (yo >> 1)) * W + (xo >> 1)) * CV + c;
    uint4 l = __ldg(low + li);
    uint4 s = __ldg(skip + v);
    out[v] = kBf16 ? add_vec_bf16(l, s) : add_vec_f32(l, s);
  }
}

template <bool kBf16>
__device__ __forceinline__ uint4 sum4_vec(uint4 a, uint4 b, uint4 c, uint4 d) {
  uint4 r;
  if (kBf16) {
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
    const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
    const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&d);
    __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 fa = __bfloat1622float2(pa[k]), fb = __bfloat1622float2(pb[k]);
      float2 fc = __bfloat1622float2(pc[k]), fd = __bfloat1622float2(pd[k]);
      pr[k] = __floats2bfloat162_rn(((fa.x + fb.x) + fc.x) + fd.x,
                                    ((fa.y + fb.y) + fc.y) + fd.y);
    }
  } else {
    const float* fa = reinterpret_cast<const float*>(&a);
    const float* fb = reinterpret_cast<const float*>(&b);
    const float* fc = reinterpret_cast<const float*>(&c);
    const float* fd = reinterpret_cast<const float*>(&d);
    float* fr = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) fr[k] = ((fa[k] + fb[k]) + fc[k]) + fd[k];
  }
  return r;
}

template <bool kBf16>
__global__ void upsample2x_add_bwd_kernel(const uint4* __restrict__ g,
                                          uint4* __restrict__ dlow,
                                          long long nvec, int H, int W,
                                          int CV) {
  const long long row = 2LL * W * CV;  // one row of g, in vectors
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    int c = (int)(v % CV);
    long long pix = v / CV;
    int x = (int)(pix % W);
    long long t = pix / W;
    int y = (int)(t % H);
    long long b = t / H;
    long long g00 = ((b * 2 * H + 2 * y) * (2LL * W) + 2 * x) * CV + c;
    dlow[v] = sum4_vec<kBf16>(__ldg(g + g00), __ldg(g + g00 + CV),
                              __ldg(g + g00 + row), __ldg(g + g00 + row + CV));
  }
}

}  // namespace

// elem_bytes: 2 (bf16) or 4 (f32); C * elem_bytes must be a multiple of 16.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_upsample2x_add(const void* low, const void* skip, void* out,
                                  int B, int H, int W, int C, int elem_bytes,
                                  int num_sms, void* stream) {
  if ((elem_bytes != 2 && elem_bytes != 4) || (C * elem_bytes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int CV = C * elem_bytes / 16;
  const long long nvec = (long long)B * (2 * H) * (2 * W) * CV;
  if (nvec == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (nvec + threads - 1) / threads;
  long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2)
    upsample2x_add_kernel<true><<<(int)blocks, threads, 0, s>>>(
        (const uint4*)low, (const uint4*)skip, (uint4*)out, nvec, H, W, CV);
  else
    upsample2x_add_kernel<false><<<(int)blocks, threads, 0, s>>>(
        (const uint4*)low, (const uint4*)skip, (uint4*)out, nvec, H, W, CV);
  return (int)cudaGetLastError();
}

// Backward of low: d_low [B, H, W, C] from g [B, 2H, 2W, C] (H, W are the
// low-resolution sizes). The same dtype and C conditions as the forward.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_upsample2x_add_bwd(const void* g, void* dlow, int B, int H,
                                      int W, int C, int elem_bytes,
                                      int num_sms, void* stream) {
  if ((elem_bytes != 2 && elem_bytes != 4) || (C * elem_bytes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int CV = C * elem_bytes / 16;
  const long long nvec = (long long)B * H * W * CV;
  if (nvec == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (nvec + threads - 1) / threads;
  long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2)
    upsample2x_add_bwd_kernel<true><<<(int)blocks, threads, 0, s>>>(
        (const uint4*)g, (uint4*)dlow, nvec, H, W, CV);
  else
    upsample2x_add_bwd_kernel<false><<<(int)blocks, threads, 0, s>>>(
        (const uint4*)g, (uint4*)dlow, nvec, H, W, CV);
  return (int)cudaGetLastError();
}
