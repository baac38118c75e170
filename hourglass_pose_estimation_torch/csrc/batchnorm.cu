// Train-mode BatchNorm over the channels of a channels-last activation, with
// the ReLU and the cast to the next op's dtype fused in: the forward's
// statistics and apply, the backward's reduction and dx.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for
// BatchNorm, since XLA fuses its statistics, normalisation, ReLU and casts
// into the neighbouring fusions there. It was added because on this card
// the port's train step spent most of its device time in the chain of
// generic elementwise and reduce kernels that PyTorch makes of the same
// math (about 22 launches forward and 20 back per BatchNorm, ~66 bytes an
// element forward and ~100 back).
//
// x is [M, C] as laid out (M = B*H*W rows of C channels: NCHW in
// channels-last memory), bf16 or f32; all statistics and gradients are f32.
// The statistics' rows are the first R rows (the first k samples of the
// batch, or all of them); every row is normalised.
//   bn_stats_kernel:      moments[0:2, c] = (sum_{r<R} x, sum_{r<R} x^2) / count_stats
//   bn_apply_kernel:      mean = moments[0] / count, E[x^2] = moments[1] / count,
//                         var = max(E[x^2] - mean^2, 0), mul = w * rsqrt(var + eps),
//                         y = relu?((x - mean) * mul + b), rounded once to y's dtype;
//                         it also writes (mean, var) and, when given the running
//                         buffers, moves them to m * ra + (1 - m) * batch.
//   bn_bwd_reduce_kernel: dy_hat = dy where the recomputed (x - mean) * mul + b > 0
//                         (every row when there is no ReLU); over all rows
//                         Sd = sum dy_hat, Sdx = sum dy_hat * (x - mean); then
//                         dbias = Sd, dweight = Sdx * rsqrt(var + eps) and the
//                         cotangent of the moments, cot = (dmean, dvar) / count with
//                         dvar = -0.5 w r^3 Sdx (0 where the clamp held var at 0)
//                         and dmean = -mul Sd - 2 mean dvar.
//   bn_bwd_dx_kernel:     dx = dy_hat * mul, plus cot[0] / count_stats +
//                         2 x cot[1] / count_stats on the statistics' rows, rounded
//                         once to x's dtype.
// Between the launches of each pair the caller may all-reduce the moments
// (forward) and the cotangent (backward) over a data group: sums of each
// rank's rows (count_stats 1, count the global row count), or means of each
// rank's means (count_stats its own rows, an average over the ranks, count
// 1). The apply, the reduce and the dx kernels each recompute a channel's
// mean and mul from the moments with the same f32 operations, so all three
// see the same values, and the forward's output equals the plain path's f32
// math (`(x - mean) * mul + b`, `torch.relu`, the cast) on the same
// statistics bit for bit: explicit round-to-nearest intrinsics, no
// contraction into FMAs, and `rsqrtf` as `torch.rsqrt` computes it on the
// card. The module's hooks stay on the Python side
// (`ops/hopper/batchnorm.py`): the weight and bias come from its `_affine`,
// and the running buffers are given only where its `_update_running` is
// BatchNorm's own (an override is handed the (mean, var) outputs).
//
// What bounds it: device-memory bytes. A bf16 activation of N elements
// needs 6N bytes forward (x read twice, y written once) and 10N back (dy and
// x read by each kernel, dx written), plus the per-channel vectors and the
// reduce kernels' partial sums (blocks x 2 x C f32). Each thread owns 8
// channels of a row (one 16-byte bf16 vector). An apply or dx block spans up
// to 256 channels by as many rows as its threads allow (a warp reads 512
// contiguous bytes), with 4 rows in flight a thread and up to 8 blocks an
// SM. A reduce kernel runs one block of 512 threads an SM over 64-channel
// column chunks (a warp reads four full 128-byte lines), keeps a thread's
// sums in registers over a slab of rows with 256 bytes (statistics) or 2 x
// 128 bytes (backward) of loads in flight, sums the block's threads in
// shared memory and writes one partial row; the last block of a column
// chunk to finish (a fence and a ticket) sums the chunk's partials in
// row-block order, so the result does not depend on which block finished
// when, and resets its ticket for the next launch. Narrow chunks keep that
// last block's reads short (a few dozen partial rows of 64 channels). Grid
// sizes follow M, C and the SM count only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;               // channels a thread owns
constexpr int kApplyColv = 32;        // 8-channel vectors an apply or dx block spans: 256
constexpr int kReduceColv = 8;        // ... a reduce block spans: 64 channels, so that the
                                      // last block of a chunk sums few partials
constexpr int kReduceThreads = 512;   // stats and backward reduce
constexpr int kApplyThreads = 256;    // apply and dx
constexpr int kApplyUnroll = 4;       // rows in flight a thread in apply and dx
constexpr int kMaxChunks = 256;       // tickets: C up to 256 * 64 channels

// A row's 8 channels as loaded (one 16-byte vector of bf16, two of f32),
// kept packed while loads are in flight and widened to f32 lane by lane.
template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  struct Raw {
    uint4 v;
  };
  __device__ static Raw load(const __nv_bfloat16* p) {
    return Raw{__ldg(reinterpret_cast<const uint4*>(p))};
  }
  __device__ static float get(const Raw& r, int j) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&r.v)[j]);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[kVec]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <>
struct Io<float> {
  struct Raw {
    float4 a, b;
  };
  __device__ static Raw load(const float* p) {
    return Raw{__ldg(reinterpret_cast<const float4*>(p)),
               __ldg(reinterpret_cast<const float4*>(p) + 1)};
  }
  __device__ static float get(const Raw& r, int j) {
    const float4& h = j < 4 ? r.a : r.b;
    switch (j & 3) {
      case 0: return h.x;
      case 1: return h.y;
      case 2: return h.z;
      default: return h.w;
    }
  }
  __device__ static void store(float* p, const float (&f)[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// A block's threads as [rpi rows x colv vectors] over its column chunk
// (blockIdx.y); threads beyond rpi * colv, or past C, are inactive.
struct Tile {
  int colv, rpi, tx, ty, cv;
  bool active;
};

template <int kMaxColv>
__device__ __forceinline__ Tile tile_of(int CV) {
  Tile t;
  t.colv = CV < kMaxColv ? CV : kMaxColv;
  t.rpi = blockDim.x / t.colv;
  t.tx = threadIdx.x % t.colv;
  t.ty = threadIdx.x / t.colv;
  t.cv = blockIdx.y * t.colv + t.tx;
  t.active = t.ty < t.rpi && t.cv < CV;
  return t;
}

// one channel's statistics from the moments, in the plain path's f32 steps
struct Stat {
  float mean, raw_var, var, r, mul;
};

__device__ __forceinline__ Stat stat_of(const float* moments, int C, int c, float count,
                                        float w, float eps) {
  Stat s;
  s.mean = __fdiv_rn(moments[c], count);
  const float mean2 = __fdiv_rn(moments[C + c], count);
  s.raw_var = __fsub_rn(mean2, __fmul_rn(s.mean, s.mean));
  s.var = s.raw_var < 0.f ? 0.f : s.raw_var;     // clamp_min: NaN stays NaN
  s.r = rsqrtf(__fadd_rn(s.var, eps));
  s.mul = __fmul_rn(w, s.r);
  return s;
}

// what a thread needs of its 8 channels to normalise a row
struct Coef {
  float mean[kVec], mul[kVec], bias[kVec];
};

__device__ __forceinline__ void coef_of(const float* moments, int C, int c0, float count,
                                        const float* w, const float* b, float eps, Coef& k) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    Stat s = stat_of(moments, C, c0 + j, count, w[c0 + j], eps);
    k.mean[j] = s.mean;
    k.mul[j] = s.mul;
    k.bias[j] = b[c0 + j];
  }
}

__device__ __forceinline__ float normalised(float x, const Coef& k, int j) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, k.mean[j]), k.mul[j]), k.bias[j]);
}

__device__ __forceinline__ float relu_of(float y) {
  return (y > 0.f || y != y) ? y : 0.f;           // torch.relu: NaN stays NaN
}

// the gradient that reaches y_hat: relu's backward passes it where the
// output is not <= 0
template <bool kRelu>
__device__ __forceinline__ float masked(float g, float x, const Coef& k, int j) {
  if (!kRelu) return g;
  return normalised(x, k, j) <= 0.f ? 0.f : g;
}

// Sums of `items` columns of `rows` values each, read by at(row, item), in
// shared memory: threads in groups over row ranges, then the groups' sums in
// order. The order is fixed by the block's shape alone. out(item, sum).
template <typename At, typename Out>
__device__ __forceinline__ void column_sums(int items, int rows, At at, Out out) {
  __shared__ float part[kReduceThreads];
  const int groups = max(1, (int)blockDim.x / items);
  const int span = (rows + groups - 1) / groups;
  for (int i = threadIdx.x; i < items * groups; i += blockDim.x) {
    const int it = i % items, grp = i / items;
    const int r1 = min(rows, (grp + 1) * span);
    float s = 0.f;
#pragma unroll 4
    for (int r = grp * span; r < r1; ++r) s += at(r, it);
    part[grp * items + it] = s;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    float s = 0.f;
    for (int grp = 0; grp < groups; ++grp) s += part[grp * items + it];
    out(it, s);
  }
  __syncthreads();
}

// The end of a reduce kernel: this block's per-thread sums (2 x kVec a
// thread) -> its partial row, then, in the chunk's last block to arrive, the
// partials summed in row-block order into `total` [2, C] (summed over
// blocks). Returns true in that last block, with `total` visible to its
// threads.
__device__ bool reduce_partials(const Tile& t, int C, const float (&a)[kVec],
                                const float (&b)[kVec], float* partial,
                                unsigned int* tickets, float* total) {
  // a row of sm padded by 8 words, so that the sums of one vector's 8 lanes
  // sit in different banks
  __shared__ float sm[2 * kVec][kReduceThreads + 8];
  __shared__ unsigned int ticket;
  const int CV = C / kVec;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sm[j][threadIdx.x] = t.active ? a[j] : 0.f;
    sm[kVec + j][threadIdx.x] = t.active ? b[j] : 0.f;
  }
  __syncthreads();
  // item k * colv + tx: sum k of vector tx (k < kVec: a, else b)
  const int colv = t.colv;
  column_sums(
      2 * kVec * colv, t.rpi,
      [&](int ty, int it) { return sm[it / colv][ty * colv + it % colv]; },
      [&](int it, float s) {
        const int k = it / colv, cv = blockIdx.y * colv + it % colv;
        if (cv < CV)
          partial[((long long)blockIdx.x * 2 + k / kVec) * C + cv * kVec + k % kVec] = s;
      });
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(&tickets[blockIdx.y], 1u);
  __syncthreads();
  if (ticket != gridDim.x - 1) return false;
  __threadfence();
  const int c0 = blockIdx.y * colv * kVec;
  const int nc = min(colv * kVec, C - c0);
  // item which * nc + i: channel c0 + i of sum `which`
  column_sums(
      2 * nc, gridDim.x,
      [&](int blk, int it) {
        return __ldcg(partial + ((long long)blk * 2 + it / nc) * C + c0 + it % nc);
      },
      [&](int it, float s) { total[(it / nc) * C + c0 + it % nc] = s; });
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0u;
  return true;
}

// body(row, x's raw vector) for rows r, r + step, ... below r1, the loads of
// kUnroll rows in flight at a time
template <int kUnroll, typename T, typename Body>
__device__ __forceinline__ void for_rows(const T* p, int C, long long r, long long r1,
                                         long long step, Body body) {
  for (; r + (kUnroll - 1) * step < r1; r += kUnroll * step) {
    typename Io<T>::Raw v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = Io<T>::load(p + (r + u * step) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) body(r + u * step, v[u]);
  }
  for (; r < r1; r += step) body(r, Io<T>::load(p + r * C));
}

// the same over two arrays of one layout: body(row, x's raw, dy's raw)
template <int kUnroll, typename Tx, typename Tg, typename Body>
__device__ __forceinline__ void for_rows2(const Tx* px, const Tg* pg, int C, long long r,
                                          long long r1, long long step, Body body) {
  for (; r + (kUnroll - 1) * step < r1; r += kUnroll * step) {
    typename Io<Tx>::Raw v[kUnroll];
    typename Io<Tg>::Raw d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = Io<Tx>::load(px + (r + u * step) * C);
      d[u] = Io<Tg>::load(pg + (r + u * step) * C);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) body(r + u * step, v[u], d[u]);
  }
  for (; r < r1; r += step) body(r, Io<Tx>::load(px + r * C), Io<Tg>::load(pg + r * C));
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
bn_stats_kernel(const T* __restrict__ x, long long rows, int C, long long slab,
                float count_stats, float* __restrict__ partial,
                unsigned int* __restrict__ tickets, float* __restrict__ moments) {
  const Tile t = tile_of<kReduceColv>(C / kVec);
  float s1[kVec] = {}, s2[kVec] = {};
  if (t.active) {
    const long long r0 = (long long)blockIdx.x * slab;
    // 256 bytes of loads in flight a thread
    for_rows<(int)(256 / (kVec * sizeof(T)))>(x + (long long)t.cv * kVec, C, r0 + t.ty, min(r0 + slab, rows), t.rpi,
             [&](long long, const typename Io<T>::Raw& v) {
#pragma unroll
               for (int j = 0; j < kVec; ++j) {
                 const float f = Io<T>::get(v, j);
                 s1[j] += f;
                 s2[j] = fmaf(f, f, s2[j]);
               }
             });
  }
  if (!reduce_partials(t, C, s1, s2, partial, tickets, moments)) return;
  __syncthreads();
  const int c0 = blockIdx.y * t.colv * kVec;
  const int nc = min(t.colv * kVec, C - c0);
  for (int i = threadIdx.x; i < 2 * nc; i += blockDim.x) {
    const int idx = (i / nc) * C + c0 + i % nc;
    moments[idx] = __fdiv_rn(moments[idx], count_stats);
  }
}

template <typename Tin, typename Tout, bool kRelu>
__global__ void __launch_bounds__(kApplyThreads)
bn_apply_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, long long rows, int C,
                const float* __restrict__ moments, float count, const float* __restrict__ w,
                const float* __restrict__ b, float eps, float* __restrict__ mean_out,
                float* __restrict__ var_out, float* run_mean, float* run_var,
                float momentum, float one_minus_momentum) {
  const Tile t = tile_of<kApplyColv>(C / kVec);
  if (!t.active) return;
  const int c0 = t.cv * kVec;
  Coef k;
  coef_of(moments, C, c0, count, w, b, eps, k);
  if (blockIdx.x == 0 && t.ty == 0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j;
      const Stat s = stat_of(moments, C, c, count, w[c], eps);
      mean_out[c] = s.mean;
      var_out[c] = s.var;
      if (run_mean != nullptr) {
        run_mean[c] = __fadd_rn(__fmul_rn(momentum, run_mean[c]),
                                __fmul_rn(one_minus_momentum, s.mean));
        run_var[c] = __fadd_rn(__fmul_rn(momentum, run_var[c]),
                               __fmul_rn(one_minus_momentum, s.var));
      }
    }
  }
  Tout* py = y + c0;
  for_rows<kApplyUnroll>(x + c0, C, (long long)blockIdx.x * t.rpi + t.ty, rows,
           (long long)gridDim.x * t.rpi, [&](long long r, const typename Io<Tin>::Raw& v) {
             float f[kVec];
#pragma unroll
             for (int j = 0; j < kVec; ++j) {
               const float o = normalised(Io<Tin>::get(v, j), k, j);
               f[j] = kRelu ? relu_of(o) : o;
             }
             Io<Tout>::store(py + r * C, f);
           });
}

template <typename Tin, typename Tg, bool kRelu>
__global__ void __launch_bounds__(kReduceThreads)
bn_bwd_reduce_kernel(const Tg* __restrict__ g, const Tin* __restrict__ x, long long rows,
                     int C, long long slab, const float* __restrict__ moments, float count,
                     const float* __restrict__ w, const float* __restrict__ b, float eps,
                     float* __restrict__ partial, unsigned int* __restrict__ tickets,
                     float* __restrict__ sums, float* __restrict__ dweight,
                     float* __restrict__ dbias, float* __restrict__ cot) {
  const Tile t = tile_of<kReduceColv>(C / kVec);
  float sd[kVec] = {}, sdx[kVec] = {};
  if (t.active) {
    const int c0 = t.cv * kVec;
    Coef k;
    coef_of(moments, C, c0, count, w, b, eps, k);
    const long long r0 = (long long)blockIdx.x * slab;
    // 128 bytes of each array's loads in flight a thread
    for_rows2<(int)(128 / (kVec * (sizeof(Tin) > sizeof(Tg) ? sizeof(Tin) : sizeof(Tg))))>(
              x + c0, g + c0, C, r0 + t.ty, min(r0 + slab, rows), t.rpi,
              [&](long long, const typename Io<Tin>::Raw& v, const typename Io<Tg>::Raw& d) {
#pragma unroll
                for (int j = 0; j < kVec; ++j) {
                  const float f = Io<Tin>::get(v, j);
                  const float dy = masked<kRelu>(Io<Tg>::get(d, j), f, k, j);
                  sd[j] += dy;
                  sdx[j] = fmaf(dy, __fsub_rn(f, k.mean[j]), sdx[j]);
                }
              });
  }
  if (!reduce_partials(t, C, sd, sdx, partial, tickets, sums)) return;
  __syncthreads();
  const int c0 = blockIdx.y * t.colv * kVec;
  const int nc = min(t.colv * kVec, C - c0);
  for (int c = c0 + threadIdx.x; c < c0 + nc; c += blockDim.x) {
    const Stat s = stat_of(moments, C, c, count, w[c], eps);
    const float Sd = sums[c], Sdx = sums[C + c];
    dbias[c] = Sd;
    dweight[c] = Sdx * s.r;
    // rsqrt's backward, -0.5 g r^3, of g = Sdx * w; clamp_min passes where raw >= 0
    const float dvar = s.raw_var >= 0.f ? -0.5f * (Sdx * w[c]) * (s.r * s.r * s.r) : 0.f;
    const float dmean = -(s.mul * Sd) - 2.f * s.mean * dvar;
    cot[c] = dmean / count;
    cot[C + c] = dvar / count;
  }
}

template <typename Tin, typename Tg, bool kRelu>
__global__ void __launch_bounds__(kApplyThreads)
bn_bwd_dx_kernel(const Tg* __restrict__ g, const Tin* __restrict__ x, Tin* __restrict__ dx,
                 long long rows, long long stat_rows, int C, const float* __restrict__ moments,
                 float count, const float* __restrict__ w, const float* __restrict__ b,
                 float eps, const float* __restrict__ cot, float count_stats) {
  const Tile t = tile_of<kApplyColv>(C / kVec);
  if (!t.active) return;
  const int c0 = t.cv * kVec;
  Coef k;
  coef_of(moments, C, c0, count, w, b, eps, k);
  float c1[kVec], c2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    c1[j] = cot[c0 + j] / count_stats;
    c2[j] = 2.f * (cot[C + c0 + j] / count_stats);
  }
  Tin* pdx = dx + c0;
  for_rows2<kApplyUnroll>(x + c0, g + c0, C, (long long)blockIdx.x * t.rpi + t.ty, rows,
            (long long)gridDim.x * t.rpi,
            [&](long long r, const typename Io<Tin>::Raw& v, const typename Io<Tg>::Raw& d) {
              const bool stat = r < stat_rows;
              float o[kVec];
#pragma unroll
              for (int j = 0; j < kVec; ++j) {
                const float f = Io<Tin>::get(v, j);
                const float dy = masked<kRelu>(Io<Tg>::get(d, j), f, k, j) * k.mul[j];
                o[j] = stat ? dy + fmaf(c2[j], f, c1[j]) : dy;
              }
              Io<Tin>::store(pdx + r * C, o);
            });
}

int colv_of(int C, int max_colv) { return C / kVec < max_colv ? C / kVec : max_colv; }

// column chunks of the grid (gridDim.y) of a kernel spanning max_colv vectors
int chunks_of(int C, int max_colv) {
  return (C / kVec + colv_of(C, max_colv) - 1) / colv_of(C, max_colv);
}

// blocks of an elementwise kernel: enough for every row, at most 8 a SM
int apply_blocks(long long rows, int C, int num_sms) {
  const long long rpi = kApplyThreads / colv_of(C, kApplyColv);
  long long blocks = (rows + rpi * kApplyUnroll - 1) / (rpi * kApplyUnroll);
  long long cap = (long long)num_sms * 8 / chunks_of(C, kApplyColv);
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

bool shape_ok(int C, int elem_bytes) {
  return C > 0 && C % kVec == 0 && chunks_of(C, kReduceColv) <= kMaxChunks &&
         (elem_bytes == 2 || elem_bytes == 4);
}

// the row slab of each of `blocks` row blocks
long long slab_of(long long rows, int blocks) { return (rows + blocks - 1) / blocks; }

template <typename Tin, typename Tout>
void launch_apply(bool relu, dim3 grid, cudaStream_t s, const void* x, void* y,
                  long long rows, int C, const float* moments, float count, const float* w,
                  const float* b, float eps, float* mean_out, float* var_out, float* rm,
                  float* rv, float momentum, float omm) {
  if (relu)
    bn_apply_kernel<Tin, Tout, true><<<grid, kApplyThreads, 0, s>>>(
        (const Tin*)x, (Tout*)y, rows, C, moments, count, w, b, eps, mean_out, var_out, rm, rv,
        momentum, omm);
  else
    bn_apply_kernel<Tin, Tout, false><<<grid, kApplyThreads, 0, s>>>(
        (const Tin*)x, (Tout*)y, rows, C, moments, count, w, b, eps, mean_out, var_out, rm, rv,
        momentum, omm);
}

template <typename Tin, typename Tg>
void launch_bwd_reduce(bool relu, dim3 grid, long long slab, cudaStream_t s, const void* g,
                       const void* x, long long rows, int C, const float* moments, float count,
                       const float* w, const float* b, float eps, float* partial,
                       unsigned int* tickets, float* sums, float* dw, float* db, float* cot) {
  if (relu)
    bn_bwd_reduce_kernel<Tin, Tg, true><<<grid, kReduceThreads, 0, s>>>(
        (const Tg*)g, (const Tin*)x, rows, C, slab, moments, count, w, b, eps, partial, tickets,
        sums, dw, db, cot);
  else
    bn_bwd_reduce_kernel<Tin, Tg, false><<<grid, kReduceThreads, 0, s>>>(
        (const Tg*)g, (const Tin*)x, rows, C, slab, moments, count, w, b, eps, partial, tickets,
        sums, dw, db, cot);
}

template <typename Tin, typename Tg>
void launch_bwd_dx(bool relu, dim3 grid, cudaStream_t s, const void* g, const void* x,
                   void* dx, long long rows, long long stat_rows, int C, const float* moments,
                   float count, const float* w, const float* b, float eps, const float* cot,
                   float count_stats) {
  if (relu)
    bn_bwd_dx_kernel<Tin, Tg, true><<<grid, kApplyThreads, 0, s>>>(
        (const Tg*)g, (const Tin*)x, (Tin*)dx, rows, stat_rows, C, moments, count, w, b, eps,
        cot, count_stats);
  else
    bn_bwd_dx_kernel<Tin, Tg, false><<<grid, kApplyThreads, 0, s>>>(
        (const Tg*)g, (const Tin*)x, (Tin*)dx, rows, stat_rows, C, moments, count, w, b, eps,
        cot, count_stats);
}

}  // namespace

// Row blocks of a reduce kernel (stats or backward reduce) over `rows` rows
// of C channels: its partial sums take blocks x 2 x C f32. At least 8 row
// steps a thread, at most one block per SM and column chunk.
extern "C" int hpe_bn_reduce_blocks(long long rows, int C, int num_sms) {
  if (C <= 0 || C % kVec != 0) return 1;
  const long long rpi = kReduceThreads / colv_of(C, kReduceColv);
  long long blocks = (rows + rpi * 8 - 1) / (rpi * 8);
  long long cap = num_sms / chunks_of(C, kReduceColv);
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

// x [rows, C] (bf16: elem_bytes 2, f32: 4) -> moments [2, C] f32: the sums
// of x and x^2 over the first stat_rows rows, each / count_stats. partial:
// [blocks, 2, C] f32 scratch (blocks from hpe_bn_reduce_blocks); tickets:
// kMaxChunks zeroed uint32 that the kernel leaves zeroed, one set per stream.
extern "C" int hpe_bn_stats(const void* x, long long stat_rows, int C, int elem_bytes,
                            float count_stats, void* partial, int blocks, void* tickets,
                            void* moments, void* stream) {
  if (!shape_ok(C, elem_bytes) || blocks < 1 || stat_rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks, chunks_of(C, kReduceColv));
  const long long slab = slab_of(stat_rows, blocks);
  if (elem_bytes == 2)
    bn_stats_kernel<__nv_bfloat16><<<grid, kReduceThreads, 0, s>>>(
        (const __nv_bfloat16*)x, stat_rows, C, slab, count_stats, (float*)partial,
        (unsigned int*)tickets, (float*)moments);
  else
    bn_stats_kernel<float><<<grid, kReduceThreads, 0, s>>>(
        (const float*)x, stat_rows, C, slab, count_stats, (float*)partial,
        (unsigned int*)tickets, (float*)moments);
  return (int)cudaGetLastError();
}

// (x [rows, C], moments [2, C]) -> y [rows, C] in out_bytes' dtype, mean and
// var [C]; run_mean / run_var (f32 [C], both or neither) move in place.
extern "C" int hpe_bn_apply(const void* x, int in_bytes, void* y, int out_bytes,
                            long long rows, int C, const void* moments, float count,
                            const void* w, const void* b, float eps, int relu,
                            void* mean_out, void* var_out, void* run_mean, void* run_var,
                            float momentum, float one_minus_momentum, int num_sms,
                            void* stream) {
  if (!shape_ok(C, in_bytes) || !shape_ok(C, out_bytes) || rows < 0 ||
      (run_mean == nullptr) != (run_var == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(apply_blocks(rows, C, num_sms), chunks_of(C, kApplyColv));
  const float *m = (const float*)moments, *wf = (const float*)w, *bf = (const float*)b;
  float *mo = (float*)mean_out, *vo = (float*)var_out, *rm = (float*)run_mean,
        *rv = (float*)run_var;
  if (in_bytes == 2 && out_bytes == 2)
    launch_apply<__nv_bfloat16, __nv_bfloat16>(relu, grid, s, x, y, rows, C, m, count, wf, bf,
                                               eps, mo, vo, rm, rv, momentum, one_minus_momentum);
  else if (in_bytes == 2)
    launch_apply<__nv_bfloat16, float>(relu, grid, s, x, y, rows, C, m, count, wf, bf, eps, mo,
                                       vo, rm, rv, momentum, one_minus_momentum);
  else if (out_bytes == 2)
    launch_apply<float, __nv_bfloat16>(relu, grid, s, x, y, rows, C, m, count, wf, bf, eps, mo,
                                       vo, rm, rv, momentum, one_minus_momentum);
  else
    launch_apply<float, float>(relu, grid, s, x, y, rows, C, m, count, wf, bf, eps, mo, vo, rm,
                               rv, momentum, one_minus_momentum);
  return (int)cudaGetLastError();
}

// (dy [rows, C] in g_bytes' dtype, x [rows, C]) -> sums [2, C] (Sd, Sdx),
// dweight, dbias [C] and the moments' cotangent cot [2, C]; partial, blocks
// and tickets as for hpe_bn_stats.
extern "C" int hpe_bn_bwd_reduce(const void* g, int g_bytes, const void* x, int in_bytes,
                                 long long rows, int C, const void* moments, float count,
                                 const void* w, const void* b, float eps, int relu,
                                 void* partial, int blocks, void* tickets, void* sums,
                                 void* dweight, void* dbias, void* cot, void* stream) {
  if (!shape_ok(C, in_bytes) || !shape_ok(C, g_bytes) || blocks < 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks, chunks_of(C, kReduceColv));
  const long long slab = slab_of(rows, blocks);
  const float *m = (const float*)moments, *wf = (const float*)w, *bf = (const float*)b;
  float *pa = (float*)partial, *su = (float*)sums, *dw = (float*)dweight, *db = (float*)dbias,
        *co = (float*)cot;
  unsigned int* tk = (unsigned int*)tickets;
  if (in_bytes == 2 && g_bytes == 2)
    launch_bwd_reduce<__nv_bfloat16, __nv_bfloat16>(relu, grid, slab, s, g, x, rows, C, m,
                                                    count, wf, bf, eps, pa, tk, su, dw, db, co);
  else if (in_bytes == 2)
    launch_bwd_reduce<__nv_bfloat16, float>(relu, grid, slab, s, g, x, rows, C, m, count, wf, bf,
                                            eps, pa, tk, su, dw, db, co);
  else if (g_bytes == 2)
    launch_bwd_reduce<float, __nv_bfloat16>(relu, grid, slab, s, g, x, rows, C, m, count, wf, bf,
                                            eps, pa, tk, su, dw, db, co);
  else
    launch_bwd_reduce<float, float>(relu, grid, slab, s, g, x, rows, C, m, count, wf, bf, eps,
                                    pa, tk, su, dw, db, co);
  return (int)cudaGetLastError();
}

// (dy, x [rows, C], the moments, cot [2, C]) -> dx [rows, C] in x's dtype;
// the first stat_rows rows take the statistics' term.
extern "C" int hpe_bn_bwd_dx(const void* g, int g_bytes, const void* x, int in_bytes, void* dx,
                             long long rows, long long stat_rows, int C, const void* moments,
                             float count, const void* w, const void* b, float eps, int relu,
                             const void* cot, float count_stats, int num_sms, void* stream) {
  if (!shape_ok(C, in_bytes) || !shape_ok(C, g_bytes) || rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(apply_blocks(rows, C, num_sms), chunks_of(C, kApplyColv));
  const float *m = (const float*)moments, *wf = (const float*)w, *bf = (const float*)b,
              *co = (const float*)cot;
  if (in_bytes == 2 && g_bytes == 2)
    launch_bwd_dx<__nv_bfloat16, __nv_bfloat16>(relu, grid, s, g, x, dx, rows, stat_rows, C, m,
                                                count, wf, bf, eps, co, count_stats);
  else if (in_bytes == 2)
    launch_bwd_dx<__nv_bfloat16, float>(relu, grid, s, g, x, dx, rows, stat_rows, C, m, count,
                                        wf, bf, eps, co, count_stats);
  else if (g_bytes == 2)
    launch_bwd_dx<float, __nv_bfloat16>(relu, grid, s, g, x, dx, rows, stat_rows, C, m, count,
                                        wf, bf, eps, co, count_stats);
  else
    launch_bwd_dx<float, float>(relu, grid, s, g, x, dx, rows, stat_rows, C, m, count, wf, bf,
                                eps, co, count_stats);
  return (int)cudaGetLastError();
}
