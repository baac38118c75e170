// The first-generation render and decode kernels, kept to time the
// present kernels of `hourglass_pose_estimation_torch/csrc/render.cu` and
// `decode.cu` against in one run (`chip_smoke.py`'s `before_ms`,
// `experiments/render_decode_probe.py`). Entry points take the same
// arguments as the package's, suffixed `_v1`. The decode carries the NaN
// rule of the package's kernel (NaN ranks first, a NaN gradient gives a
// NaN sign).
//
// render: one thread per output element over a grid-stride loop, 64-bit
// index arithmetic (three `%` and `/` per element), 4-byte stores.
// decode: one 256-thread block per image, 4-byte loads.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
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


namespace {

__global__ void render_gaussian_v1_kernel(const int* __restrict__ mu,
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
extern "C" int hpe_render_gaussian_v1(const void* mu, const void* weight,
                                   void* out, int B, int H, int W, int J,
                                   int tmp, float two_sigma2, int num_sms,
                                   void* stream) {
  if (H < 1 || W < 1 || J < 1 || tmp < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W * J;
  if (n == 0) return (int)cudaSuccess;
  long long blocks = (n + 255) / 256;
  long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  render_gaussian_v1_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)mu, (const float*)weight, (float*)out, n, H, W, J, tmp,
      two_sigma2);
  return (int)cudaGetLastError();
}
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
//
// What bounds it: device-memory bytes (the heatmaps are read once, the
// outputs are tiny). One block per image; the block's J * (256 / J)
// threads stride over the image so that consecutive threads read
// consecutive floats (thread t always sees joint t % J). Each thread keeps
// its running (max, first index) for its joint; a shared-memory pass
// merges them per joint (NaN first, then the larger value, then the
// smaller index), and thread j
// reads the two-neighbour gradient signs and applies the edge gate.


namespace {

// (v, i) ranks before (bv, bi): NaN above every number (torch.argmax and
// jnp.argmax take the first NaN), then the larger value, then the smaller
// index
__device__ __forceinline__ bool ranks_before(float v, int i, float bv, int bi) {
  const bool n = v != v, bn = bv != bv;
  if (n || bn) return n && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// torch.sign: NaN for NaN
__device__ __forceinline__ float sign_nan(float g) {
  return g > 0.f ? 1.f : (g < 0.f ? -1.f : g);
}

__global__ void decode_peaks_v1_kernel(const float* __restrict__ hm,
                                    float* __restrict__ coords,
                                    float* __restrict__ maxvals, int H, int W,
                                    int J) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x;
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + T);

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int j = t % J;
  const int HW = H * W;
  const int pstride = T / J;
  const float* img = hm + (size_t)b * HW * J;

  float best = -INFINITY;
  int bi = INT_MAX;
  for (int q = t / J; q < HW; q += pstride) {
    float v = __ldg(img + (size_t)q * J + j);
    if (ranks_before(v, q, best, bi)) {
      best = v;
      bi = q;
    }
  }
  sv[t] = best;
  si[t] = bi;
  __syncthreads();
  if (t >= J) return;

  for (int k = t + J; k < T; k += J) {
    float v = sv[k];
    int q = si[k];
    if (ranks_before(v, q, best, bi)) {
      best = v;
      bi = q;
    }
  }
  if (bi == INT_MAX) bi = 0;  // no element (H * W == 0 is refused)
  const int px = bi % W, py = bi / W;
  auto at = [&](int y, int x) -> float {
    return (y >= 0 && y < H && x >= 0 && x < W) ? img[((size_t)y * W + x) * J + j] : 0.f;
  };
  float gx = at(py, px + 1) - at(py, px - 1);
  float gy = at(py + 1, px) - at(py - 1, px);
  bool ok = px > 0 && px < W - 1 && py > 0 && py < H - 1;
  float sx = sign_nan(gx);
  float sy = sign_nan(gy);
  coords[((size_t)b * J + j) * 2 + 0] = (float)px + (ok ? sx * 0.25f : 0.f);
  coords[((size_t)b * J + j) * 2 + 1] = (float)py + (ok ? sy * 0.25f : 0.f);
  maxvals[(size_t)b * J + j] = best;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_decode_peaks_v1(const void* hm, void* coords, void* maxvals,
                                int B, int H, int W, int J, void* stream) {
  if (J < 1 || J > 1024 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int T = J >= 256 ? J : J * (256 / J);
  const size_t smem = (size_t)T * (sizeof(float) + sizeof(int));
  decode_peaks_v1_kernel<<<B, T, smem, (cudaStream_t)stream>>>(
      (const float*)hm, (float*)coords, (float*)maxvals, H, W, J);
  return (int)cudaGetLastError();
}
