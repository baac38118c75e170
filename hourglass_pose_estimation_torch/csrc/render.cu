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
// What bounds it: device-memory bytes, the write of the target (16 MB at
// [64, 64, 64, 16]); the inputs are a few KB and stay in L1/L2. One thread
// per output element, consecutive threads on consecutive joints of one
// pixel, so the stores coalesce. The square is taken in int32 only inside
// the window (outside it a far-off peak could overflow), then in f32 like
// the reference; `expf` (not `__expf`) keeps full single precision.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void render_gaussian_kernel(const int* __restrict__ mu,
                                       const float* __restrict__ weight,
                                       float* __restrict__ out, long long n,
                                       int H, int W, int J, int tmp,
                                       float two_sigma2) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    int j = (int)(i % J);
    long long p = i / J;
    int x = (int)(p % W);
    long long t = p / W;
    int y = (int)(t % H);
    long long bj = (t / H) * J + j;
    int dx = x - __ldg(mu + 2 * bj);
    int dy = y - __ldg(mu + 2 * bj + 1);
    float v = 0.f;
    if (abs(dx) <= tmp && abs(dy) <= tmp && __ldg(weight + bj) > 0.5f) {
      float d2 = (float)(dy * dy) + (float)(dx * dx);
      v = expf(-d2 / two_sigma2);
    }
    out[i] = v;
  }
}

}  // namespace

// two_sigma2 = 2 * sigma^2 as f32, tmp = int(3 * sigma).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_render_gaussian(const void* mu, const void* weight,
                                   void* out, int B, int H, int W, int J,
                                   int tmp, float two_sigma2, int num_sms,
                                   void* stream) {
  if (H < 1 || W < 1 || J < 1 || tmp < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W * J;
  if (n == 0) return (int)cudaSuccess;
  long long blocks = (n + 255) / 256;
  long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  render_gaussian_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)mu, (const float*)weight, (float*)out, n, H, W, J, tmp,
      two_sigma2);
  return (int)cudaGetLastError();
}
