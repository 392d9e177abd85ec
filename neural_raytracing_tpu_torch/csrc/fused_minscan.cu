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
// into mn as torch.minimum does.  The sphere set is sphere_set.cuh (shared
// with K2, both smooth-min forms), the shift net the register-tiled device
// MLP of mlp_tiled.cuh over the weights kernels/fused_march.py packs.
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

#define NRT_SCAN_MAX_SPHERES 1024

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

// The encoding [x, sin(x B), cos(x B)] of the rows' points, value c of row
// at put(row, c, v) (x B by fmaf in ascending d, as the first kernel did).
template <int M, typename Put>
__device__ __forceinline__ void nrt_scan_encode(const TiledNet& m, const float* ps, Put put) {
  const int F = m.F;
  for (int idx = threadIdx.x; idx < M * (3 + F); idx += blockDim.x) {
    const int row = idx % M, c = idx / M;
    const float* x = ps + row * 3;
    if (c < 3) {
      put(row, c, x[c]);
    } else {
      const int f = c - 3;
      float mapped = 0.f;
      for (int d = 0; d < 3; ++d) mapped = fmaf(x[d], __ldg(m.B + d * F + f), mapped);
      put(row, 3 + f, sinf(mapped));
      put(row, 3 + F + f, cosf(mapped));
    }
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
__host__ __device__ inline size_t nrt_scan_f32_smem(int EP) {
  constexpr int M = nrt_tiled_rows(NP);
  return sizeof(float) * ((size_t)2 * NRT_F32_KC * NP + (size_t)(NP + EP) * (M + 4) + M);
}

template <int NP>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_fused_minscan_f32_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                             const float* __restrict__ step_ptr, const NrtScanOut out,
                             int n, int steps, SphereSet S, const __grid_constant__ TiledNet m) {
  constexpr int M = nrt_tiled_rows(NP), LD = M + 4, R = M / NRT_TILE_U;
  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem;                               // [2][KC][NP]
  float* act = wbuf + 2 * NRT_F32_KC * NP;          // [NP + EP][LD], k-major
  float* sm = act + (size_t)(NP + m.EP) * LD;       // [M] sphere smooth-min
  // the sphere set and the sample points borrow the h rows, which are dead
  // from a group's output layer until its init layer writes them
  float* sph = act;
  float* ps = act + nrt_sphere_smem_floats(S.n);

  // the encoding's padded rows stay zero
  for (int i = threadIdx.x; i < (m.EP - m.E) * LD; i += blockDim.x)
    act[(size_t)(NP + m.E) * LD + i] = 0.f;
  const int ray0 = blockIdx.x / out.segments * R;
  const float step = *step_ptr;
  // in the row-0 thread of each ray: its segment's state (nrt_scan_update)
  float mn = INFINITY;
  int best = blockIdx.x % out.segments == 0 ? 0 : -1;
  bool dead = false;
  int buf = 0, g0, g1;
  nrt_scan_groups(steps, out.segments, g0, g1);
  float acc[M / 16][NP / 16];

  for (int i0 = g0 * NRT_TILE_U; i0 < g1 * NRT_TILE_U; i0 += NRT_TILE_U) {
    __syncthreads();  // the previous group is done with act
    nrt_f32_issue<NP>(static_cast<const float*>(m.w[0]), wbuf + buf * NRT_F32_KC * NP);
    nrt_load_spheres(S, sph);
    nrt_scan_points<M>(ro, rd, n, ray0, step, i0, ps);
    __syncthreads();
    nrt_sphere_min(sph, S.n, S.k, S.stable, ps, sm, M);
    nrt_scan_encode<M>(m, ps, [&](int row, int c, float v) { act[(NP + c) * LD + row] = v; });
    // (the init layer's first barrier orders the encoding before its reads)

    for (int l = 0; l <= m.L; ++l) {
      nrt_f32_gemm<NP>(acc, act, nrt_tiled_kbase(m, l), nrt_tiled_k(m, l),
                       static_cast<const float*>(m.w[l]), wbuf, buf);
      __syncthreads();  // every thread is done reading act
      if (l < m.L)
        nrt_f32_issue<NP>(static_cast<const float*>(m.w[l + 1]),
                          wbuf + buf * NRT_F32_KC * NP);
      nrt_with_act(m.act, [&](auto a) {
        nrt_f32_store<NP, decltype(a)::value>(acc, m.b[l], act);
      });
      if (l == 0)   // the skip layers read act(enc)
        for (int i = threadIdx.x; i < m.E * M; i += blockDim.x) {
          float* e = act + (size_t)(NP + i / M) * LD + i % M;
          *e = nrt_act(*e, m.act);
        }
    }
    __syncthreads();

    if (threadIdx.x < M) {   // the output layer, one row a thread
      const int row = threadIdx.x;
      float o = 0.f;
      for (int k = 0; k < m.H; ++k) o = fmaf(act[k * LD + row], __ldg(m.w_out + k), o);
      nrt_scan_update(sm[row] + (o + __ldg(m.b_out)), row, i0, steps, mn, best, dead);
    }
  }

  if (threadIdx.x < M && threadIdx.x % NRT_TILE_U == 0)
    nrt_scan_finish(out, n, ray0 + threadIdx.x / NRT_TILE_U, mn, best, dead);
}

// ---- K3-bf16: the tensor cores ---------------------------------------------------

template <int NP>
__host__ __device__ inline int nrt_scan_bf16_lda(int EP) { return NP + EP + 8; }

template <int NP>
__host__ __device__ inline size_t nrt_scan_bf16_smem(int EP, int n_spheres) {
  constexpr int M = nrt_tiled_rows(NP);
  return sizeof(__nv_bfloat16) *
             ((size_t)2 * NP * NRT_BF16_WLD + (size_t)M * nrt_scan_bf16_lda<NP>(EP)) +
         sizeof(float) * ((size_t)nrt_sphere_smem_floats(n_spheres) + 3 * M + M);
}

template <int NP>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_fused_minscan_bf16_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                              const float* __restrict__ step_ptr, const NrtScanOut out,
                              int n, int steps, SphereSet S, const __grid_constant__ TiledNet m) {
  constexpr int M = nrt_tiled_rows(NP), R = M / NRT_TILE_U;
  const int lda = nrt_scan_bf16_lda<NP>(m.EP);
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][NP][WLD]
  __nv_bfloat16* act = wbuf + 2 * NP * NRT_BF16_WLD;              // [M][lda], row-major
  float* sph = reinterpret_cast<float*>(act + (size_t)M * lda);
  float* ps = sph + nrt_sphere_smem_floats(S.n);                  // [M][3]
  float* sm = ps + 3 * M;                                         // [M]

  // the encoding's padded columns stay zero
  for (int i = threadIdx.x; i < M * (m.EP - m.E); i += blockDim.x)
    act[(size_t)(i / (m.EP - m.E)) * lda + NP + m.E + i % (m.EP - m.E)] = __float2bfloat16(0.f);
  nrt_load_spheres(S, sph);
  const int ray0 = blockIdx.x / out.segments * R;
  const float step = *step_ptr;
  // in the row-0 thread of each ray: its segment's state (nrt_scan_update)
  float mn = INFINITY;
  int best = blockIdx.x % out.segments == 0 ? 0 : -1;
  bool dead = false;
  int buf = 0, g0, g1;
  nrt_scan_groups(steps, out.segments, g0, g1);
  float acc[4][4][4];

  for (int i0 = g0 * NRT_TILE_U; i0 < g1 * NRT_TILE_U; i0 += NRT_TILE_U) {
    __syncthreads();  // the previous group is done with act, ps and sm
    nrt_bf16_issue<NP>(static_cast<const __nv_bfloat16*>(m.w[0]), m.EP, 0,
                       wbuf + buf * NP * NRT_BF16_WLD);
    nrt_scan_points<M>(ro, rd, n, ray0, step, i0, ps);
    __syncthreads();
    nrt_sphere_min(sph, S.n, S.k, S.stable, ps, sm, M);
    // the encoding rounded to bf16
    nrt_scan_encode<M>(m, ps, [&](int row, int c, float v) {
      act[(size_t)row * lda + NP + c] = __float2bfloat16_rn(v);
    });

    for (int l = 0; l <= m.L; ++l) {
      nrt_bf16_gemm<NP>(acc, act, lda, nrt_tiled_kbase(m, l), nrt_tiled_k(m, l),
                        static_cast<const __nv_bfloat16*>(m.w[l]), wbuf, buf);
      __syncthreads();  // every warp is done reading act
      if (l < m.L)
        nrt_bf16_issue<NP>(static_cast<const __nv_bfloat16*>(m.w[l + 1]),
                           nrt_tiled_k(m, l + 1), 0, wbuf + buf * NP * NRT_BF16_WLD);
      nrt_with_act(m.act, [&](auto a) {
        nrt_bf16_store<NP, decltype(a)::value>(acc, m.b[l], act, lda);
      });
      if (l == 0)   // the skip layers read act of the rounded encoding, rounded
        for (int i = threadIdx.x; i < m.E * M; i += blockDim.x) {
          __nv_bfloat16* e = act + (size_t)(i % M) * lda + NP + i / M;
          *e = __float2bfloat16_rn(nrt_act(__bfloat162float(*e), m.act));
        }
    }
    __syncthreads();

    if (threadIdx.x < M) {   // the output layer on the CUDA cores, one row a thread
      const int row = threadIdx.x;
      const __nv_bfloat16* h = act + (size_t)row * lda;
      float o = 0.f;
      for (int k = 0; k < m.H; ++k) o = fmaf(__bfloat162float(h[k]), __ldg(m.w_out + k), o);
      nrt_scan_update(sm[row] + (o + __ldg(m.b_out)), row, i0, steps, mn, best, dead);
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
                               nrt_scan_bf16_smem<128>(EP, n_spheres), 128 / NRT_TILE_U}
               : NrtScanLaunch{nrt_fused_minscan_bf16_kernel<256>,
                               nrt_scan_bf16_smem<256>(EP, n_spheres), 64 / NRT_TILE_U};
  return NP == 128 ? NrtScanLaunch{nrt_fused_minscan_f32_kernel<128>,
                                   nrt_scan_f32_smem<128>(EP), 128 / NRT_TILE_U}
                   : NrtScanLaunch{nrt_fused_minscan_f32_kernel<256>,
                                   nrt_scan_f32_smem<256>(EP), 64 / NRT_TILE_U};
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
  if (n < 0 || n_spheres <= 0 || n_spheres > NRT_SCAN_MAX_SPHERES || steps < 0 ||
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
      n_spheres > NRT_SCAN_MAX_SPHERES || rays == nullptr)
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
