// Fused nearest-2x upsample + skip-add, forward.
//
// Replaces the TPU kernel `hourglass_pose_estimation_tpu/ops/pallas/
// upsample.py::upsample2x_add_pallas` (`_fwd`, `_fwd_kernel`):
//   out[b, y, x, c] = low[b, y / 2, x / 2, c] + skip[b, y, x, c]
// low [B, H, W, C], skip/out [B, 2H, 2W, C], NHWC, bf16 or f32.
//
// What bounds it: no arithmetic to speak of, so device-memory bytes:
// read skip and low once each, write out once. The upsampled low is never
// materialised; each thread moves one 16-byte vector along C (8 bf16 or
// 4 f32) of skip/out and reads the matching vector of low, which the four
// output pixels of a 2x2 block share through L2. The sum is taken in f32
// and rounded once, as PyTorch's elementwise add does. Any H and W.

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
