// K2: fused no-grad sphere trace through a SphereSDF, in persistent ray slots.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_march.py
// (fused_march / _build_march_kernel / _make_sdf_eval), plain (omega = 1)
// and over-relaxed (1 < omega < 2, Keinert et al. 2014).  A ray starts at
// depth t0 (bounded) or 0 and, while it remains (not hit, depth < max_t,
// fewer than max_steps evaluations), takes a step:
//   sd    = smooth_min_i(|T_i p - c_i| - r_i) + shift_mlp(p),  p = o + d * depth
//   fail  = om > 1 & (|sd| + |prev| <= step | sd < -eps)
//   hit   = !fail & sd <= eps
//   step  = fail ? (1 - om) * step : om * sd;  om = fail ? 1 : om
//   depth += step, prev = sd, unless it hit
// The ray's own omega falls to 1 at its first failure: the failed step is
// taken back and the ray marches plainly from there.  With omega = 1 nothing
// fails and om * sd == sd: the plain sphere trace.  Products and sums of the
// loop are rounded one by one (no contraction into FMAs), as the plain
// version computes them.
//
// Bound on an H100: the shift net's multiply-adds over the SDF evaluations
// the rays need (2 x 165,504 + 31 x 128 flops each for the flagship 8x128
// net and 128 spheres) at the f32 FMA rate, or for K2-bf16 on the tensor
// cores beside the elementwise work of its softplus epilogue.  Rays need
// from 0 to max_steps evaluations (the flagship's 128^2 eval tile: median 8,
// 99th percentile 24, most 71), so the design keeps the tile full while rays
// finish at different steps:
//   * persistent blocks, one a SM (fewer for fewer rays: the wrapper's
//     march_plan), each with M slots (march_slots.cuh, shared with the
//     shadow march K4): the rows of the tiled SDF of
//     mlp_tiled.cuh (the f32 register tile or the bf16 tensor-core tile,
//     over the weights of kernels/fused_mlp.py tile_layout; the same SDF code and
//     double-buffered weight stream as the min-scan K3);
//   * a step evaluates the SDF of every live slot at once; a slot whose ray
//     hits, leaves its interval or runs out of steps writes depth and hit and
//     takes the next ray from a global queue (one atomicAdd a warp on a
//     counter the launch zeroes), with its relaxation state and evaluation
//     count starting afresh;
//   * once the queue is dry, the live slots move to the front rows and a
//     step evaluates only the first M, M / 2 or 32 rows, so a step's cost
//     follows the live rows in the tail;
//   * the kernel fits twice on an SM, as K3 does, but one block a SM
//     marches faster (H100: 18.2 against 20.8 ms on 65,536 bounded rays,
//     chip_smoke.py phase 3b): a step's cost has a large fixed part (a
//     32-row f32 step took 0.10 ms, a 128-row one 0.19; two or eight chunks
//     of weights in flight made no difference), so the tail is shorter in
//     fewer, fuller blocks;
//   * a ray's state lives in global memory, read and written by its row's
//     thread once a step: the depth in the output, [prev, step, om,
//     evaluations] in a float4 of a scratch the wrapper allocates.  The
//     slots (ray ids) sit in shared memory beside the tile.
// A ray's result depends only on its own evaluations: each row's SDF sums
// run in one order whatever its slot, its block, the tile variant or the
// step it starts on, so the depths are the same bit for bit from launch to
// launch and under any permutation of the rays.
// K2-bf16 (bf16 != 0, SDF(march_dtype=bfloat16)) runs the same loop over the
// bf16 tile (the operands of the JAX _make_sdf_eval: the rounded encoding,
// act of the rounded encoding on the skip layers, every act(h) rounded);
// the sphere set and the loop stay f32.
//
// Bounded mode (t0 != nullptr): per-ray start t0 and end max_t (the
// march_bound clip); otherwise depth starts at 0 and max_t is one scalar.
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include <limits.h>

#include "march_slots.cuh"
#include "mlp_tiled.cuh"


struct NrtMarch {
  const float* ro;              // [n][3]
  const float* rd;              // [n][3]
  const float* t0;              // [n] or nullptr (unbounded)
  const float* mt;              // [n] or nullptr (then max_t)
  float max_t;
  float* depth;                 // [n] the ray's depth while it marches, then its result
  unsigned char* hit;           // [n]
  float4* state;                // [n] prev, last step, om, evaluations (int bits)
  int* queue;                   // the next ray to hand out
  unsigned long long* stats;    // nullptr, or [3] += steps, rows evaluated, live rows
  int n, max_steps;
  int first;                    // the slots a block fills before its first step
  int slots;                    // the slots a block fills (all M)
  float eps, omega;

  // Ray g enters a slot at t0 (or 0); one with no steps or t0 >= its max_t
  // is resolved at once (no hit).
  __device__ bool enter(int g) const {
    const float t = t0 ? t0[g] : 0.f;
    depth[g] = t;
    if (max_steps > 0 && t < (mt ? mt[g] : max_t)) {
      state[g] = make_float4(0.f, 0.f, omega, __int_as_float(0));
      return true;
    }
    hit[g] = 0;
    return false;
  }
  __device__ float march_depth(int g) const { return depth[g]; }
};

// One step of ray g with its SDF value sd; frees the slot when the ray is
// done.
__device__ __forceinline__ void nrt_march_update(const NrtMarch& a, int g, float sd,
                                                 int* slot) {
  const float4 s = a.state[g];
  const int evals = __float_as_int(s.w) + 1;
  const float om = s.z, l = s.y;
  const bool fail = om > 1.f && (__fadd_rn(fabsf(sd), fabsf(s.x)) <= l || sd < -a.eps);
  bool done = true;
  if (!fail && sd <= a.eps) {
    a.hit[g] = 1;
  } else {
    const float step = fail ? __fmul_rn(__fsub_rn(1.f, om), l) : __fmul_rn(om, sd);
    const float depth = __fadd_rn(a.depth[g], step);
    a.depth[g] = depth;
    a.state[g] = make_float4(sd, step, fail ? 1.f : om, __int_as_float(evals));
    done = evals >= a.max_steps || !(depth < (a.mt ? a.mt[g] : a.max_t));
    if (done) a.hit[g] = 0;
  }
  if (done) *slot = -1;
}

// ---- K2: f32 --------------------------------------------------------------------

template <int NP, int TM>
__device__ __forceinline__ void nrt_march_f32_step(
    const NrtMarch& a, const SphereSet& S, const TiledNet& m,
    const NrtF32Tile<NP>& T, NrtStream<NP, false>& W,
    const NrtSlots& Q) {
  nrt_f32_sdf<NP, TM>(m, S, T, W);
  const int t = threadIdx.x;
  if (t < 16 * TM && Q.slot[t] >= 0)
    nrt_march_update(a, Q.slot[t], T.sm[t] + nrt_f32_out(m, T, t), Q.slot + t);
}

template <int NP>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_fused_march_f32_kernel(const NrtMarch a, SphereSet S, const __grid_constant__ TiledNet m) {
  constexpr int M = nrt_tiled_rows(NP);
  extern __shared__ __align__(16) float smem[];
  const NrtF32Tile<NP> T(smem, m, S.n);
  NrtStream<NP, false> W;
  const NrtSlots Q(T.end(), M);
  nrt_f32_sdf_init(m, T);
  nrt_march_begin(Q, M);
  __syncthreads();
  for (bool first = true;; first = false) {
    // (its barriers also order the last step's reads of act before the
    // spheres and points overwrite the h rows)
    const int rows = nrt_march_schedule<M>(a, Q, first);
    if (rows == 0) break;
    W.start(m, T.wbuf);
    nrt_load_spheres(S, T.sph);
    nrt_march_points(a, Q, T.ps, rows);
    __syncthreads();
    if (rows == M)
      nrt_march_f32_step<NP, M / 16>(a, S, m, T, W, Q);
    else if (rows == 64)
      nrt_march_f32_step<NP, 4>(a, S, m, T, W, Q);
    else
      nrt_march_f32_step<NP, 2>(a, S, m, T, W, Q);
  }
  nrt_march_finish(a, Q);
}

// ---- K2-bf16: the tensor cores -----------------------------------------------------

template <int NP, int MI>
__device__ __forceinline__ void nrt_march_bf16_step(
    const NrtMarch& a, const SphereSet& S, const TiledNet& m,
    const NrtBf16Tile<NP>& T, NrtStream<NP, true>& W,
    const NrtSlots& Q) {
  nrt_bf16_sdf<NP, MI>(m, S, T, W);
  const int t = threadIdx.x;
  if (t < 16 * MI * (nrt_tiled_rows(NP) / 64) && Q.slot[t] >= 0)
    nrt_march_update(a, Q.slot[t], T.sm[t] + nrt_bf16_out(m, T, t), Q.slot + t);
}

template <int NP>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_fused_march_bf16_kernel(const NrtMarch a, SphereSet S, const __grid_constant__ TiledNet m) {
  constexpr int M = nrt_tiled_rows(NP);
  extern __shared__ __align__(16) float smem[];
  const NrtBf16Tile<NP> T(smem, m, S.n);
  NrtStream<NP, true> W;
  const NrtSlots Q(T.end(), M);
  nrt_bf16_sdf_init(m, S, T);
  nrt_march_begin(Q, M);
  __syncthreads();
  for (bool first = true;; first = false) {
    const int rows = nrt_march_schedule<M>(a, Q, first);
    if (rows == 0) break;
    W.start(m, T.wbuf);
    nrt_march_points(a, Q, T.ps, rows);
    __syncthreads();
    // rows = 16 MI (M / 64)
    if (rows == M)
      nrt_march_bf16_step<NP, 4>(a, S, m, T, W, Q);
    else if (rows == M / 2)
      nrt_march_bf16_step<NP, 2>(a, S, m, T, W, Q);
    else
      nrt_march_bf16_step<NP, 1>(a, S, m, T, W, Q);
  }
  nrt_march_finish(a, Q);
}

// ---- launch -----------------------------------------------------------------------

// The kernel for (bf16, NP), its dynamic shared memory and its slots.
struct NrtMarchLaunch {
  void (*kernel)(const NrtMarch, SphereSet, const TiledNet);
  size_t smem;
  int slots;
};

template <int NP>
static NrtMarchLaunch nrt_march_config(int bf16, int EP, int n_spheres) {
  constexpr int M = nrt_tiled_rows(NP);
  if (bf16)
    return NrtMarchLaunch{nrt_fused_march_bf16_kernel<NP>,
                          nrt_bf16_sdf_smem<NP>(EP, n_spheres) + nrt_slots_bytes(M), M};
  return NrtMarchLaunch{nrt_fused_march_f32_kernel<NP>,
                        nrt_f32_sdf_smem<NP>(EP) + nrt_slots_bytes(M), M};
}

static NrtMarchLaunch nrt_march_config(int bf16, int NP, int EP, int n_spheres) {
  return NP == 128 ? nrt_march_config<128>(bf16, EP, n_spheres)
                   : nrt_march_config<256>(bf16, EP, n_spheres);
}

// grid: the persistent blocks (the wrapper's march_plan); state: [n] float4
// scratch; queue: one int, zeroed here on the stream; stats: nullptr or [3]
// unsigned 64-bit counters the launch adds its steps, evaluated rows and
// live rows to.
extern "C" int nrt_fused_march(const float* ro, const float* rd, const float* t0,
                               const float* mt, float max_t, float* depth,
                               unsigned char* hit, void* state, int* queue,
                               unsigned long long* stats, int n, int grid, int max_steps,
                               float eps, float omega, int bf16, const float* tfs,
                               const float* centers, const float* radii,
                               int n_spheres, float k, int stable,
                               int in_size, int freqs, int hidden, int num_layers,
                               int skip, int out_size, int act,
                               const void* const* weights, void* stream) {
  TiledNet m;
  if (n < 0 || n > INT_MAX - (1 << 24) || grid < 0 || (n > 0 && grid == 0) ||
      n_spheres <= 0 || n_spheres > NRT_TILED_MAX_SPHERES || max_steps < 0 ||
      in_size != 3 || out_size != 1 || !(omega >= 1.f && omega < 2.f) ||
      (t0 == nullptr) != (mt == nullptr) ||
      (n > 0 && (state == nullptr || queue == nullptr)) ||
      !nrt_tiled_fill(m, freqs, hidden, num_layers, skip, act, bf16, weights))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const NrtMarchLaunch c = nrt_march_config(bf16, m.NP, m.EP, n_spheres);
  const int per_block = (n + grid - 1) / grid;
  const NrtMarch a{ro, rd, t0, mt, max_t, depth, hit, static_cast<float4*>(state),
                   queue, stats, n, max_steps, per_block < c.slots ? per_block : c.slots,
                   c.slots, eps, omega};
  const cudaError_t err = cudaMemsetAsync(queue, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return nrt_launch(c.kernel, grid, c.smem, stream, a,
                    SphereSet{tfs, centers, radii, n_spheres, k, stable}, m);
}

// The kernel for this net: info = [blocks per SM (its occupancy), slots a
// block holds, registers a thread, local memory a thread in bytes (spills),
// dynamic shared memory a block in bytes].  Returns a cudaError_t as int.
extern "C" int nrt_fused_march_info(int bf16, int freqs, int hidden, int n_spheres,
                                    int* info) {
  if (freqs < 0 || freqs > 128 || hidden <= 0 || hidden > 256 || n_spheres <= 0 ||
      n_spheres > NRT_TILED_MAX_SPHERES || info == nullptr)
    return (int)cudaErrorInvalidValue;
  const int E = 3 + 2 * freqs, r = bf16 ? 16 : 8;
  const NrtMarchLaunch c =
      nrt_march_config(bf16, hidden <= 128 ? 128 : 256, (E + r - 1) / r * r, n_spheres);
  cudaError_t err = cudaFuncSetAttribute(
      c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  cudaFuncAttributes attr;
  int blocks = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, c.kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.kernel, NRT_THREADS,
                                                        c.smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = c.slots;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = (int)c.smem;
  return 0;
}
