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
// merges them per joint (larger value, then smaller index), and thread j
// reads the two-neighbour gradient signs and applies the edge gate.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

__global__ void decode_peaks_kernel(const float* __restrict__ hm,
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
    if (v > best || (v == best && q < bi)) {
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
    if (v > best || (v == best && q < bi)) {
      best = v;
      bi = q;
    }
  }
  if (bi == INT_MAX) bi = 0;  // every value NaN
  const int px = bi % W, py = bi / W;
  auto at = [&](int y, int x) -> float {
    return (y >= 0 && y < H && x >= 0 && x < W) ? img[((size_t)y * W + x) * J + j] : 0.f;
  };
  float gx = at(py, px + 1) - at(py, px - 1);
  float gy = at(py + 1, px) - at(py - 1, px);
  bool ok = px > 0 && px < W - 1 && py > 0 && py < H - 1;
  float sx = (float)((gx > 0.f) - (gx < 0.f));
  float sy = (float)((gy > 0.f) - (gy < 0.f));
  coords[((size_t)b * J + j) * 2 + 0] = (float)px + (ok ? sx * 0.25f : 0.f);
  coords[((size_t)b * J + j) * 2 + 1] = (float)py + (ok ? sy * 0.25f : 0.f);
  maxvals[(size_t)b * J + j] = best;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hpe_decode_peaks(const void* hm, void* coords, void* maxvals,
                                int B, int H, int W, int J, void* stream) {
  if (J < 1 || J > 1024 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int T = J >= 256 ? J : J * (256 / J);
  const size_t smem = (size_t)T * (sizeof(float) + sizeof(int));
  decode_peaks_kernel<<<B, T, smem, (cudaStream_t)stream>>>(
      (const float*)hm, (float*)coords, (float*)maxvals, H, W, J);
  return (int)cudaGetLastError();
}
