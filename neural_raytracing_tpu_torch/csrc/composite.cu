// K8: NeRF alpha compositing.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/composite.py
// (_pallas_composite / _kernel):
//   alpha_i = 1 - exp(-sigma_i * t_i)           (absolute sample position t_i)
//   T_i     = prod_{j<i} max(1 - alpha_j, 1e-10)
//   out     = sum_i alpha_i * T_i * rgb_i
// The TPU kernel transposes the samples onto the lane axis and builds the
// exclusive log-prefix-sum as a triangular [T, T] matmul on the MXU (Mosaic
// has no cumsum).  Here the caller's sample-major layout sigma [T][R],
// rgb [T][R][3] stays, and nothing is transposed.
// Bound on an H100: memory (16 bytes read per sample, 12 written per ray).
// What keeps the card from it is latency: one thread a ray walking its T
// samples gives an eval tile's 10,000 rays 2-4 resident warps a SM, each
// with a dependent chain of loads.  So a ray's samples split into S
// segments (S = 8 at T = 64), one thread a segment, 80,000 threads at
// 10,000 rays:
//   - each thread issues its segment's loads first (4 floats a sample,
//     8 samples at a time, all independent), then computes its segment's
//     local weighted sum and its product of max(1 - alpha, 1e-10);
//   - the S segments of a ray are S warps of one block, the lanes of a warp
//     on 32 consecutive rays, so each load is 128 coalesced bytes;
//   - the segments then meet in a fixed order: the first segment's thread
//     walks the S (product, sum) pairs in shared memory, carrying the
//     incoming transmittance, so the output has the same bits from run to
//     run.  It differs from the cumprod order only by rounding.
// (The segments of a ray on S lanes of one warp, meeting by shuffles, were
// 5% faster than this map at 10,000 rays on an H100 and 27% slower at a
// training step's 1,024.)  The sample positions are read from global
// memory (a warp's lanes read the same one), so T has no limit.
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include <cuda_runtime.h>

constexpr int NRT_COMPOSITE_THREADS = 256;
constexpr int NRT_COMPOSITE_BATCH = 8;     // samples a thread loads at once

template <int S>
__global__ void __launch_bounds__(NRT_COMPOSITE_THREADS)
nrt_composite_kernel(const float* __restrict__ sigma, const float* __restrict__ rgb,
                     const float* __restrict__ ts, float* __restrict__ out, int n_t,
                     int n_r) {
  constexpr int RB = NRT_COMPOSITE_THREADS / S;   // rays a block
  const int j = threadIdx.x % RB, seg = threadIdx.x / RB;   // the ray in the block, its segment
  const int r = blockIdx.x * RB + j;
  const int per = (n_t + S - 1) / S;              // samples a segment
  const int i0 = min(seg * per, n_t), i1 = min(i0 + per, n_t);
  float prod = 1.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (r < n_r) {
    for (int b = i0; b < i1; b += NRT_COMPOSITE_BATCH) {
      float sg[NRT_COMPOSITE_BATCH], t[NRT_COMPOSITE_BATCH], c[NRT_COMPOSITE_BATCH][3];
#pragma unroll
      for (int q = 0; q < NRT_COMPOSITE_BATCH; ++q) {
        if (b + q < i1) {
          const size_t s = (size_t)(b + q) * n_r + r;
          sg[q] = __ldg(sigma + s);
          t[q] = __ldg(ts + b + q);
          c[q][0] = __ldg(rgb + 3 * s);
          c[q][1] = __ldg(rgb + 3 * s + 1);
          c[q][2] = __ldg(rgb + 3 * s + 2);
        }
      }
#pragma unroll
      for (int q = 0; q < NRT_COMPOSITE_BATCH; ++q) {
        if (b + q < i1) {
          const float alpha = 1.f - expf(-sg[q] * t[q]);
          const float w = alpha * prod;
          a0 += w * c[q][0];
          a1 += w * c[q][1];
          a2 += w * c[q][2];
          prod *= fmaxf(1.f - alpha, 1e-10f);
        }
      }
    }
  }
  // the segments meet in order: out = sum_s (prod_{s' < s} P_s') acc_s
  __shared__ float pair[S][4][RB];
  pair[seg][0][j] = prod;
  pair[seg][1][j] = a0;
  pair[seg][2][j] = a1;
  pair[seg][3][j] = a2;
  __syncthreads();
  if (seg != 0 || r >= n_r) return;
  float o0 = 0.f, o1 = 0.f, o2 = 0.f, trans = 1.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    o0 += trans * pair[s][1][j];
    o1 += trans * pair[s][2][j];
    o2 += trans * pair[s][3][j];
    trans *= pair[s][0][j];
  }
  out[3 * (size_t)r + 0] = o0;
  out[3 * (size_t)r + 1] = o1;
  out[3 * (size_t)r + 2] = o2;
}

// Segments a ray for T samples: 8 at T >= 64, else T / 8 rounded down to a
// power of two (at least 1), so a segment keeps >= 8 samples in flight.
static int nrt_composite_segments(int n_t) {
  int s = 1;
  while (s < 8 && 8 * 2 * s <= n_t) s *= 2;
  return s;
}

extern "C" int nrt_composite(const float* sigma, const float* rgb, const float* ts,
                             float* out, int n_t, int n_r, void* stream) {
  if (n_t < 0 || n_r < 0) return (int)cudaErrorInvalidValue;
  if (n_r == 0) return 0;
  const int S = nrt_composite_segments(n_t), rb = NRT_COMPOSITE_THREADS / S;
  const int grid = (n_r + rb - 1) / rb;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: nrt_composite_kernel<1><<<grid, NRT_COMPOSITE_THREADS, 0, st>>>(
                sigma, rgb, ts, out, n_t, n_r); break;
    case 2: nrt_composite_kernel<2><<<grid, NRT_COMPOSITE_THREADS, 0, st>>>(
                sigma, rgb, ts, out, n_t, n_r); break;
    case 4: nrt_composite_kernel<4><<<grid, NRT_COMPOSITE_THREADS, 0, st>>>(
                sigma, rgb, ts, out, n_t, n_r); break;
    default: nrt_composite_kernel<8><<<grid, NRT_COMPOSITE_THREADS, 0, st>>>(
                 sigma, rgb, ts, out, n_t, n_r); break;
  }
  return (int)cudaGetLastError();
}
