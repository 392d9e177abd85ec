// K4: fused no-grad shadow march through a SphereSDF, in persistent ray slots.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_march.py
// (fused_shadow_march / _build_shadow_kernel): the loop of
// SDF.intersect_test.  Per ray:
//   depth = depth0 (1e2 * eps), remaining = true
//   live  = remaining & (depth < max_t)      (the max_t term only with
//                                             past_light_exit)
//   sd    = smooth_min_i(|T_i p - c_i| - r_i) + shift_mlp(p),  p = o + d * depth
//   hits  = live & sd < eps                  (strict <)
//   depth += sd where live                   (the hit step's distance too)
//   remaining &= !hits
//   not_blocked = depth >= max_t | remaining
// Each line differs from the primary march K2 (fused_march.cu): the start
// depth, < against <=, the advance on the hit step, and the exit gate.
// So a ray leaves its slot when it hits (not_blocked = depth + sd >= max_t),
// when with the exit its depth reaches max_t, or after max_steps
// evaluations (both not blocked); one that is not live on entry (max_steps
// 0, or depth0 >= max_t with the exit) resolves in the refill, not blocked,
// without an evaluation.
// Zero-direction rays (sum |d| == 0: masked light samples) never move, so
// their first evaluation decides them: sd(o) < eps hits (blocked unless
// depth0 + sd >= max_t), otherwise no later step can hit (not blocked).  A
// zero-direction ray takes that one evaluation and leaves with exactly the
// flag of the plain loop (shadow_march_plain), which marches it on.
//
// Bound on an H100: the shift net's multiply-adds over the SDF evaluations
// the rays need (2 x 165,504 + 31 x 128 flops each for the 8x128 net and 128
// spheres) at the f32 FMA rate, or for K4-bf16 the tensor cores beside the
// elementwise work of its softplus epilogue: ~0.3 ms f32 for a NeRV eval
// chunk.  On the NeRV paths a launch is small (a 10,000-ray eval chunk, a
// 12,288-ray training call) and its rays need 6 evaluations on average but
// up to 51 or 64 (rays that graze the surface on their way to the light),
// so a launch lasts as long as its slowest block's tail of steps with few
// live rays:
//   * the slots are K2's (march_slots.cuh): one block a SM, its slots
//     refilled from a queue, the live slots compacted to fewer rows once it
//     is dry, here down to 8 (f32) or 32 (bf16) rows; the wrapper's
//     shadow_plan fills 64 of the 128 slots where one fill would hold every
//     ray (no refill), so a block's first steps evaluate 64 rows, not 128;
//   * a thin f32 step (32, 16 or 8 rows) runs on the thin map of
//     mlp_tiled.cuh (NrtF32Thin): each warp on its own columns, so a block
//     reads each weight from shared memory once, 4 warps below 32 rows;
//   * the weights stream in chunks of 32 k-rows (f32; 64 with bf16 operands)
//     through three buffers; the sphere set is summed by 8 lanes a row over
//     all the threads (K5's order);
//   * each of these sums runs in one order whatever rows a step evaluates,
//     so a ray's flag depends on its own evaluations only: the same bit for
//     bit from launch to launch and under any permutation of the rays (its
//     state, depth and evaluations, lives in a [n] float2 scratch the wrapper
//     allocates).
// What a thin step costs (H100, PERF.md): an 8-row f32 step ~0.06 ms, of
// which the products ~0.013, the weight stream alone ~0.035 (656 KB from L2
// a step, overlapped), the rest the softplus epilogues, the barriers, the
// sphere set, the encoding and the output layer.
// K4-bf16 (bf16 != 0, SDF(march_dtype=bfloat16)) runs the same loop over the
// bf16 tensor-core tile of mlp_tiled.cuh (the operands of the JAX
// _make_sdf_eval, as K2-bf16), its steps down to 32 rows; the sphere set and
// the loop stay f32.
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include <limits.h>

#include "march_slots.cuh"
#include "mlp_tiled.cuh"

// The weight stream of a K4 step for NP-wide nets (WIDE): chunks of 32
// k-rows (f32; 64 k with bf16 operands) through three buffers, at NP = 256
// K2's chunks (bf16) or 16 k-rows (f32), to fit its wider tile; K2's stream
// (two buffers of 8 or 32) where the wide one does not fit beside the tile
// (freqs near 128).
template <int NP, bool BF16, bool WIDE>
constexpr int nrt_shadow_kc() {
  if (!WIDE) return BF16 ? NRT_BF16_KC : NRT_F32_KC;
  if (BF16) return NP == 128 ? 64 : NRT_BF16_KC;
  return NP == 128 ? 32 : 16;
}
template <int NP, bool BF16, bool WIDE>
using NrtShadowStream = NrtStream<NP, BF16, nrt_shadow_kc<NP, BF16, WIDE>(), WIDE ? 3 : 2>;

// lanes a row of the sphere set's smooth-min, over all the threads
constexpr int NRT_SHADOW_TPR = 8;
// the fewest rows an f32 step evaluates (a thin step: 32, 16 or 8 rows)
constexpr int NRT_SHADOW_F32_MIN = 8;

struct NrtShadow {
  const float* ro;              // [n][3]
  const float* rd;              // [n][3]
  const float* mt;              // [n] the distance to the light
  unsigned char* not_blocked;   // [n]
  float2* state;                // [n] depth, evaluations (int bits)
  int* queue;                   // the next ray to hand out
  unsigned long long* stats;    // nullptr, or [3] += steps, rows evaluated, live rows
  int n, max_steps;
  int first;                    // the slots a block fills before its first step
  int slots;                    // the slots a block fills (at most M)
  int past_light_exit;
  float eps, depth0;

  __device__ bool enter(int g) const {
    if (max_steps > 0 && (!past_light_exit || depth0 < mt[g])) {
      state[g] = make_float2(depth0, __int_as_float(0));
      return true;
    }
    not_blocked[g] = 1;
    return false;
  }
  __device__ float march_depth(int g) const { return state[g].x; }
};

// One step of ray g with its SDF value sd; frees the slot when the ray is
// done.
__device__ __forceinline__ void nrt_shadow_update(const NrtShadow& a, int g, float sd,
                                                  int* slot) {
  const float2 s = a.state[g];
  const int evals = __float_as_int(s.y) + 1;
  const float depth = __fadd_rn(s.x, sd);
  const float mt = a.mt[g];
  const float* d = a.rd + (size_t)g * 3;
  bool done = true;
  if (sd < a.eps)
    a.not_blocked[g] = depth >= mt ? 1 : 0;
  else if (evals >= a.max_steps || (a.past_light_exit && !(depth < mt)) ||
           fabsf(d[0]) + fabsf(d[1]) + fabsf(d[2]) == 0.f)
    a.not_blocked[g] = 1;
  else {
    a.state[g] = make_float2(depth, __int_as_float(evals));
    done = false;
  }
  if (done) *slot = -1;
}

// ---- K4: f32 --------------------------------------------------------------------

// ROWS >= 64: the 16 x 16 layout; fewer: the thin map.
template <int NP, int ROWS, typename Tile, typename Stream>
__device__ __forceinline__ void nrt_shadow_f32_step(const NrtShadow& a, const SphereSet& S,
                                                    const TiledNet& m, const Tile& T,
                                                    Stream& W, const NrtSlots& Q) {
  if constexpr (ROWS >= 64)
    nrt_f32_sdf<NP, ROWS / 16, NRT_SHADOW_TPR>(m, S, T, W);
  else
    nrt_f32_sdf<NP, 2, NRT_SHADOW_TPR, NrtF32Thin<NP, ROWS>>(m, S, T, W);
  const int t = threadIdx.x;
  if (t < ROWS && Q.slot[t] >= 0)
    nrt_shadow_update(a, Q.slot[t], T.sm[t] + nrt_f32_out(m, T, t), Q.slot + t);
}

template <int NP, bool WIDE>
__global__ void __launch_bounds__(NRT_THREADS, 1)
nrt_fused_shadow_f32_kernel(const NrtShadow a, SphereSet S, const __grid_constant__ TiledNet m) {
  using Stream = NrtShadowStream<NP, false, WIDE>;
  constexpr int M = nrt_tiled_rows(NP);
  extern __shared__ __align__(16) float smem[];
  const NrtF32Tile<NP, Stream::RING> T(smem, m, S.n);
  Stream W;
  const NrtSlots Q(T.end(), M);
  nrt_f32_sdf_init(m, T);
  nrt_march_begin(Q, M);
  __syncthreads();
  for (bool first = true;; first = false) {
    // (its barriers also order the last step's reads of act before the
    // spheres and points overwrite the h rows)
    const int rows = nrt_march_schedule<M, NRT_SHADOW_F32_MIN>(a, Q, first);
    if (rows == 0) break;
    W.start(m, T.wbuf);
    nrt_load_spheres(S, T.sph);
    nrt_march_points(a, Q, T.ps, rows);
    __syncthreads();
    if (rows == M)
      nrt_shadow_f32_step<NP, M>(a, S, m, T, W, Q);
    else if (rows == 64)
      nrt_shadow_f32_step<NP, 64>(a, S, m, T, W, Q);
    else if (rows == 32)
      nrt_shadow_f32_step<NP, 32>(a, S, m, T, W, Q);
    else if (rows == 16)
      nrt_shadow_f32_step<NP, 16>(a, S, m, T, W, Q);
    else
      nrt_shadow_f32_step<NP, 8>(a, S, m, T, W, Q);
  }
  nrt_march_finish(a, Q);
}

// ---- K4-bf16: the tensor cores -----------------------------------------------------

template <int NP, int MI, typename Tile, typename Stream>
__device__ __forceinline__ void nrt_shadow_bf16_step(const NrtShadow& a, const SphereSet& S,
                                                     const TiledNet& m, const Tile& T,
                                                     Stream& W, const NrtSlots& Q) {
  nrt_bf16_sdf<NP, MI, NRT_SHADOW_TPR>(m, S, T, W);
  const int t = threadIdx.x;
  if (t < 16 * MI * (nrt_tiled_rows(NP) / 64) && Q.slot[t] >= 0)
    nrt_shadow_update(a, Q.slot[t], T.sm[t] + nrt_bf16_out(m, T, t), Q.slot + t);
}

template <int NP, bool WIDE>
__global__ void __launch_bounds__(NRT_THREADS, 1)
nrt_fused_shadow_bf16_kernel(const NrtShadow a, SphereSet S, const __grid_constant__ TiledNet m) {
  using Stream = NrtShadowStream<NP, true, WIDE>;
  constexpr int M = nrt_tiled_rows(NP);
  extern __shared__ __align__(16) float smem[];
  const NrtBf16Tile<NP, Stream::RING> T(smem, m, S.n);
  Stream W;
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
      nrt_shadow_bf16_step<NP, 4>(a, S, m, T, W, Q);
    else if (rows == M / 2)
      nrt_shadow_bf16_step<NP, 2>(a, S, m, T, W, Q);
    else
      nrt_shadow_bf16_step<NP, 1>(a, S, m, T, W, Q);
  }
  nrt_march_finish(a, Q);
}

// ---- launch -----------------------------------------------------------------------

// The kernel for (bf16, NP), its dynamic shared memory and its slots.
struct NrtShadowLaunch {
  void (*kernel)(const NrtShadow, SphereSet, const TiledNet);
  size_t smem;
  int slots;
};

template <int NP, bool WIDE>
static NrtShadowLaunch nrt_shadow_config(int bf16, int EP, int n_spheres) {
  constexpr int M = nrt_tiled_rows(NP);
  if (bf16)
    return NrtShadowLaunch{
        nrt_fused_shadow_bf16_kernel<NP, WIDE>,
        nrt_bf16_sdf_smem<NP, NrtShadowStream<NP, true, WIDE>::RING>(EP, n_spheres) +
            nrt_slots_bytes(M),
        M};
  return NrtShadowLaunch{
      nrt_fused_shadow_f32_kernel<NP, WIDE>,
      nrt_f32_sdf_smem<NP, NrtShadowStream<NP, false, WIDE>::RING>(EP) + nrt_slots_bytes(M),
      M};
}

// The wide stream where it fits in the current device's shared memory.
template <int NP>
static NrtShadowLaunch nrt_shadow_config(int bf16, int EP, int n_spheres) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    limit = 0;
  const NrtShadowLaunch wide = nrt_shadow_config<NP, true>(bf16, EP, n_spheres);
  return wide.smem <= (size_t)limit ? wide : nrt_shadow_config<NP, false>(bf16, EP, n_spheres);
}

static NrtShadowLaunch nrt_shadow_config(int bf16, int NP, int EP, int n_spheres) {
  return NP == 128 ? nrt_shadow_config<128>(bf16, EP, n_spheres)
                   : nrt_shadow_config<256>(bf16, EP, n_spheres);
}

// grid: the persistent blocks (the wrapper's shadow_plan), slots: the slots
// a block fills (at least 32; at most the kernel's, 128 or 64); state: [n] float2
// scratch; queue: one int, zeroed here on the stream; stats: nullptr or [3]
// unsigned 64-bit counters the launch adds its steps, evaluated rows and
// live rows to.  weights: the packed layout of mlp_tiled.cuh.
extern "C" int nrt_fused_shadow_march(const float* ro, const float* rd, const float* mt,
                                      unsigned char* not_blocked, void* state, int* queue,
                                      unsigned long long* stats, int n, int grid,
                                      int slots, int max_steps, float eps, float depth0,
                                      int past_light_exit, int bf16, const float* tfs,
                                      const float* centers, const float* radii,
                                      int n_spheres, float k, int stable, int in_size,
                                      int freqs, int hidden, int num_layers, int skip,
                                      int out_size, int act, const void* const* weights,
                                      void* stream) {
  TiledNet m;
  if (n < 0 || n > INT_MAX - (1 << 24) || grid < 0 || (n > 0 && grid == 0) ||
      slots < 32 || n_spheres <= 0 || n_spheres > NRT_TILED_MAX_SPHERES || max_steps < 0 ||
      in_size != 3 || out_size != 1 ||
      (n > 0 && (state == nullptr || queue == nullptr)) ||
      !nrt_tiled_fill(m, freqs, hidden, num_layers, skip, act, bf16, weights))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const NrtShadowLaunch c = nrt_shadow_config(bf16, m.NP, m.EP, n_spheres);
  const int per_block = (n + grid - 1) / grid;
  const int used = slots < c.slots ? slots : c.slots;
  const NrtShadow a{ro, rd, mt, not_blocked, static_cast<float2*>(state), queue, stats,
                    n, max_steps, per_block < used ? per_block : used, used,
                    past_light_exit, eps, depth0};
  const cudaError_t err = cudaMemsetAsync(queue, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return nrt_launch(c.kernel, grid, c.smem, stream, a,
                    SphereSet{tfs, centers, radii, n_spheres, k, stable}, m);
}

// The kernel for this net: info = [blocks per SM (its occupancy), slots a
// block holds, registers a thread, local memory a thread in bytes (spills),
// dynamic shared memory a block in bytes].  Returns a cudaError_t as int.
extern "C" int nrt_fused_shadow_march_info(int bf16, int freqs, int hidden, int n_spheres,
                                           int* info) {
  if (freqs < 0 || freqs > 128 || hidden <= 0 || hidden > 256 || n_spheres <= 0 ||
      n_spheres > NRT_TILED_MAX_SPHERES || info == nullptr)
    return (int)cudaErrorInvalidValue;
  const int E = 3 + 2 * freqs, r = bf16 ? 16 : 8;
  const NrtShadowLaunch c =
      nrt_shadow_config(bf16, hidden <= 128 ? 128 : 256, (E + r - 1) / r * r, n_spheres);
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
