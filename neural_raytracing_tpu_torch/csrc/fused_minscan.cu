// K3: fused silhouette min-scan through a SphereSDF.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_march.py
// (fused_min_scan / _build_minscan_kernel).  For every ray it returns the
// index of the earliest strict minimum of sd over the steps + 1 samples
// t = step * i, i = 0..steps:
//   mn = sd(o), idx = 0
//   for i = 1..steps:  p = o + (step * i) * d;  if sd(p) < mn: idx = i;  mn = min(mn, sd(p))
// as float32 (SDF.throughput then evaluates sd, with gradients, at
// o + (idx * step) * d).  t and p use explicit round-to-nearest multiply and
// add, as PyTorch computes them (no FMA contraction); a NaN sd propagates
// into mn as torch.minimum does.  The SDF is the tiled one of mlp_tiled.cuh
// (nrt_f32_sdf / nrt_bf16_sdf, shared with the march K2): the sphere set of
// sphere_set.cuh (both smooth-min forms) and the register-tiled shift net
// over the weights of kernels/fused_mlp.py tile_layout.
//
// Bound on an H100: f32 FMA issue.  Every ray takes all steps + 1 samples,
// (2 x 165,504 + 31 x 128) flops each for the flagship 8x128 shift net and
// 128 spheres: 24.77 ms at 38,400 rays x 129 at 67 TFLOP/s.  What the
// design does about the four limits of the first kernel (an 8 x 1 tile with
// the weights read from global memory, 64-row blocks that re-read each layer
// from L2 in four passes, 16 warps per SM with sample 0 evaluated alone, the
// bf16 products on the CUDA cores):
//   1. a block owns 32 rays x NRT_TILE_U = 4 samples = 128 rows (16 x 4 =
//      64 rows when hidden > 128); each thread keeps an 8 x 8 outer-product
//      tile in registers and loads 2 + 2 float4 from shared memory for 64
//      FMAs (before: 12 memory instructions for 32);
//   2. each layer's W streams once per block and evaluation through
//      shared memory in 8-row chunks, double-buffered with cp.async: about
//      5 KB of L2 traffic per sample instead of 40;
//   3. sample 0 is part of the first group; the last group's rows past
//      steps are evaluated and ignored; the whole 128 x 128 output of a
//      layer stays in registers, so one activation buffer serves every
//      layer; the per-ray update is a shuffle within a warp, and the block
//      fits twice on an SM (16 warps); the wrapper splits each ray's
//      samples into as many segments (blocks) as fill the last wave of
//      blocks best, and a second, small kernel merges them;
//   4. K3-bf16 (bf16 != 0, SDF(march_dtype=bfloat16)), the bf16 operands of
//      the JAX _make_sdf_eval (the rounded encoding, act of the rounded
//      encoding on the skip layers, every act(h) rounded, bf16 weights,
//      float32 sums): mma.sync m16n8k16 on the tensor cores over bf16
//      activations in shared memory.  Its products alone would take 1.66 ms
//      at 38,400 x 129; the softplus epilogue (1,219 accurate exp + log1p a
//      sample, run from the accumulator fragments) sets its pace.
// Per output the f32 sum starts at 0, adds fmaf in ascending k (the h part,
// then the encoding) and then the bias, as the first kernel did, with the
// accurate expf / log1pf / sinf / cosf.
//
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include "mlp_tiled.cuh"

// Sample points of group i0 (samples i0 .. i0 + U - 1 of the block's rays):
// row = ray * U + u.
template <int M>
__device__ __forceinline__ void nrt_scan_points(const float* __restrict__ ro,
                                                const float* __restrict__ rd, int n,
                                                int ray0, float step, int i0, float* ps) {
  for (int idx = threadIdx.x; idx < M * 3; idx += blockDim.x) {
    const int row = idx / 3, c = idx % 3;
    const int g = ray0 + row / NRT_TILE_U;
    const float o = g < n ? ro[(size_t)g * 3 + c] : 0.f;
    const float d = g < n ? rd[(size_t)g * 3 + c] : 0.f;
    const float t = __fmul_rn(step, (float)(i0 + row % NRT_TILE_U));
    ps[idx] = __fadd_rn(o, __fmul_rn(t, d));
  }
}

// Where a block works: the grid is segments x ray blocks; block b takes
// the rays of ray block b / segments and the sample groups of segment
// b % segments (a near-equal share of the ceil((steps + 1) / U) groups).
// More segments than one fill the card's last wave of blocks; a second
// kernel then merges each ray's segments.
struct NrtScanOut {
  float* idx;      // [n] the argmin index as float32
  float* part_m;   // [segments][n] a segment's minimum before its first NaN
  int* part_i;     // [segments][n] (its earliest index + 1) | (a NaN seen) << 30
  int segments;
};

__device__ __forceinline__ void nrt_scan_groups(int steps, int segments, int& g0, int& g1) {
  const int groups = (steps + NRT_TILE_U) / NRT_TILE_U;
  const int seg = blockIdx.x % segments;
  g0 = seg * groups / segments;
  g1 = (seg + 1) * groups / segments;
}

// The per-ray update of one group: the thread of row `row` (< M, whole
// warps) holds that row's sd; lane u = 0 of each ray replays its samples
// in order into its segment's state: mn, the minimum before the first NaN
// (from +inf), best, the earliest index where it fell (0 in segment 0,
// else -1 until a sample falls below +inf), and dead, a NaN seen.  This is
// the scan's rule: idx moves where sd < mn, and a NaN, which min() carries
// as torch.minimum does, freezes it.
__device__ __forceinline__ void nrt_scan_update(float sd, int row, int i0, int steps,
                                                float& mn, int& best, bool& dead) {
  float s[NRT_TILE_U];
  s[0] = sd;
#pragma unroll
  for (int u = 1; u < NRT_TILE_U; ++u) s[u] = __shfl_down_sync(0xffffffffu, sd, u);
  if (row % NRT_TILE_U != 0) return;
#pragma unroll
  for (int u = 0; u < NRT_TILE_U; ++u) {
    if (i0 + u > steps || dead) break;
    if (s[u] != s[u]) {
      dead = true;
    } else if (s[u] < mn) {
      mn = s[u];
      best = i0 + u;
    }
  }
}

// Writes ray g's result: the index itself with one segment, else the
// segment's state for nrt_minscan_merge_kernel.
__device__ __forceinline__ void nrt_scan_finish(const NrtScanOut out, int n, int g, float mn,
                                                int best, bool dead) {
  if (g >= n) return;
  if (out.segments == 1) {
    out.idx[g] = (float)best;
    return;
  }
  const size_t at = (size_t)(blockIdx.x % out.segments) * n + g;
  out.part_m[at] = mn;
  out.part_i[at] = (best + 1) | (dead ? 1 << 30 : 0);
}

// Merges each ray's segments in order, as the scan would have run them.
__global__ void nrt_minscan_merge_kernel(const NrtScanOut out, int n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  float mn = out.part_m[g];
  int code = out.part_i[g];
  int best = (code & ((1 << 30) - 1)) - 1;
  bool dead = code >> 30;
  for (int seg = 1; seg < out.segments && !dead; ++seg) {
    const size_t at = (size_t)seg * n + g;
    code = out.part_i[at];
    if (out.part_m[at] < mn) {
      mn = out.part_m[at];
      best = (code & ((1 << 30) - 1)) - 1;
    }
    dead = code >> 30;
  }
  out.idx[g] = (float)best;
}

// ---- K3: f32 ------------------------------------------------------------------

template <int NP>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_fused_minscan_f32_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                             const float* __restrict__ step_ptr, const NrtScanOut out,
                             int n, int steps, SphereSet S, const __grid_constant__ TiledNet m) {
  constexpr int M = nrt_tiled_rows(NP), R = M / NRT_TILE_U;
  extern __shared__ __align__(16) float smem[];
  const NrtF32Tile<NP> T(smem, m, S.n);
  NrtStream<NP, false> W;   // the weights, double-buffered

  nrt_f32_sdf_init(m, T);
  const int ray0 = blockIdx.x / out.segments * R;
  const float step = *step_ptr;
  // in the row-0 thread of each ray: its segment's state (nrt_scan_update)
  float mn = INFINITY;
  int best = blockIdx.x % out.segments == 0 ? 0 : -1;
  bool dead = false;
  int g0, g1;
  nrt_scan_groups(steps, out.segments, g0, g1);

  for (int i0 = g0 * NRT_TILE_U; i0 < g1 * NRT_TILE_U; i0 += NRT_TILE_U) {
    __syncthreads();  // the previous group is done with act
    W.start(m, T.wbuf);
    nrt_load_spheres(S, T.sph);
    nrt_scan_points<M>(ro, rd, n, ray0, step, i0, T.ps);
    __syncthreads();
    nrt_f32_sdf<NP, M / 16>(m, S, T, W);
    if (threadIdx.x < M) {   // the output layer, one row a thread
      const int row = threadIdx.x;
      nrt_scan_update(T.sm[row] + nrt_f32_out(m, T, row), row, i0, steps, mn, best, dead);
    }
  }

  if (threadIdx.x < M && threadIdx.x % NRT_TILE_U == 0)
    nrt_scan_finish(out, n, ray0 + threadIdx.x / NRT_TILE_U, mn, best, dead);
}

// ---- K3-bf16: the tensor cores ---------------------------------------------------

template <int NP>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_fused_minscan_bf16_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                              const float* __restrict__ step_ptr, const NrtScanOut out,
                              int n, int steps, SphereSet S, const __grid_constant__ TiledNet m) {
  constexpr int M = nrt_tiled_rows(NP), R = M / NRT_TILE_U;
  extern __shared__ __align__(16) float smem[];
  const NrtBf16Tile<NP> T(smem, m, S.n);
  NrtStream<NP, true> W;    // the weights, double-buffered

  nrt_bf16_sdf_init(m, S, T);
  const int ray0 = blockIdx.x / out.segments * R;
  const float step = *step_ptr;
  // in the row-0 thread of each ray: its segment's state (nrt_scan_update)
  float mn = INFINITY;
  int best = blockIdx.x % out.segments == 0 ? 0 : -1;
  bool dead = false;
  int g0, g1;
  nrt_scan_groups(steps, out.segments, g0, g1);

  for (int i0 = g0 * NRT_TILE_U; i0 < g1 * NRT_TILE_U; i0 += NRT_TILE_U) {
    __syncthreads();  // the previous group is done with act, ps and sm
    W.start(m, T.wbuf);
    nrt_scan_points<M>(ro, rd, n, ray0, step, i0, T.ps);
    __syncthreads();
    nrt_bf16_sdf<NP, 4>(m, S, T, W);
    if (threadIdx.x < M) {   // the output layer on the CUDA cores, one row a thread
      const int row = threadIdx.x;
      nrt_scan_update(T.sm[row] + nrt_bf16_out(m, T, row), row, i0, steps, mn, best, dead);
    }
  }

  if (threadIdx.x < M && threadIdx.x % NRT_TILE_U == 0)
    nrt_scan_finish(out, n, ray0 + threadIdx.x / NRT_TILE_U, mn, best, dead);
}

// ---- launch -----------------------------------------------------------------------

// The kernel for (bf16, NP), its dynamic shared memory and rays per block.
struct NrtScanLaunch {
  void (*kernel)(const float*, const float*, const float*, const NrtScanOut, int, int,
                 SphereSet, const TiledNet);
  size_t smem;
  int rays;
};

static NrtScanLaunch nrt_scan_config(int bf16, int NP, int EP, int n_spheres) {
  if (bf16)
    return NP == 128
               ? NrtScanLaunch{nrt_fused_minscan_bf16_kernel<128>,
                               nrt_bf16_sdf_smem<128>(EP, n_spheres), 128 / NRT_TILE_U}
               : NrtScanLaunch{nrt_fused_minscan_bf16_kernel<256>,
                               nrt_bf16_sdf_smem<256>(EP, n_spheres), 64 / NRT_TILE_U};
  return NP == 128 ? NrtScanLaunch{nrt_fused_minscan_f32_kernel<128>,
                                   nrt_f32_sdf_smem<128>(EP), 128 / NRT_TILE_U}
                   : NrtScanLaunch{nrt_fused_minscan_f32_kernel<256>,
                                   nrt_f32_sdf_smem<256>(EP), 64 / NRT_TILE_U};
}

extern "C" int nrt_fused_min_scan(const float* ro, const float* rd,
                                  const float* step, float* idx, float* part_m, int* part_i,
                                  int segments, int n, int steps,
                                  int bf16, const float* tfs, const float* centers,
                                  const float* radii, int n_spheres, float k,
                                  int stable, int in_size, int freqs, int hidden,
                                  int num_layers, int skip, int out_size, int act,
                                  const void* const* weights, void* stream) {
  TiledNet m;
  if (n < 0 || n_spheres <= 0 || n_spheres > NRT_TILED_MAX_SPHERES || steps < 0 ||
      segments < 1 || (segments > 1 && (part_m == nullptr || part_i == nullptr)) ||
      in_size != 3 || out_size != 1 ||
      !nrt_tiled_fill(m, freqs, hidden, num_layers, skip, act, bf16, weights))
    return (int)cudaErrorInvalidValue;
  SphereSet S{tfs, centers, radii, n_spheres, k, stable};
  const NrtScanLaunch c = nrt_scan_config(bf16, m.NP, m.EP, n_spheres);
  const NrtScanOut out{idx, part_m, part_i, segments};
  const int rc = nrt_launch(c.kernel, (n + c.rays - 1) / c.rays * segments, c.smem, stream,
                            ro, rd, step, out, n, steps, S, m);
  if (rc != 0 || segments == 1 || n == 0) return rc;
  nrt_minscan_merge_kernel<<<(n + NRT_THREADS - 1) / NRT_THREADS, NRT_THREADS, 0,
                             (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}

// Blocks of the kernel for this net that fit on one SM (its occupancy), or
// a negative cudaError_t; writes the rays a block takes to *rays.
extern "C" int nrt_fused_min_scan_blocks_per_sm(int bf16, int freqs, int hidden,
                                                int n_spheres, int* rays) {
  if (freqs < 0 || freqs > 128 || hidden <= 0 || hidden > 256 || n_spheres <= 0 ||
      n_spheres > NRT_TILED_MAX_SPHERES || rays == nullptr)
    return -(int)cudaErrorInvalidValue;
  const int E = 3 + 2 * freqs, r = bf16 ? 16 : 8;
  const NrtScanLaunch c =
      nrt_scan_config(bf16, hidden <= 128 ? 128 : 256, (E + r - 1) / r * r, n_spheres);
  cudaError_t err = cudaFuncSetAttribute(
      c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  int blocks = 0;
  *rays = c.rays;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.kernel, NRT_THREADS,
                                                        c.smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
