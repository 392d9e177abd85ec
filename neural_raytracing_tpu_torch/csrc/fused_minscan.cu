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
// add, as PyTorch computes them (no FMA contraction).
//
// Work shape: there is no early exit, every ray takes all steps + 1
// evaluations.  One block owns NRT_SCAN_RAYS rays; the samples of one ray are
// independent, so NRT_SCAN_UNROLL samples of the block's rays share one MLP
// evaluation of NRT_SCAN_UNROLL * NRT_SCAN_RAYS rows (the JAX kernel's
// unroll = 4), and the min/argmin update replays them in order.  Sample 0 is
// evaluated on its own; a last group past `steps` evaluates rows that the
// update ignores.  Rows past n are masked (never written), not padded.
// The sphere set is sphere_set.cuh (shared with K2), the shift net the
// device MLP of mlp.cuh (shared with K1).
// Bound on an H100: f32 FMA issue, (2 * 165,504 + 31 * 128) flops per ray
// and sample for the flagship 8x128 shift net and 128 spheres.
// K3-bf16 (bf16 != 0, SDF(march_dtype=bfloat16)) is the same scan over the
// NRT_BF16_MARCH operands of mlp.cuh.
//
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include "sphere_set.cuh"

#define NRT_SCAN_RAYS 16
#define NRT_SCAN_UNROLL 4
#define NRT_SCAN_ROWS (NRT_SCAN_RAYS * NRT_SCAN_UNROLL)

template <int MODE>
__global__ void __launch_bounds__(NRT_THREADS)
nrt_fused_minscan_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                         const float* __restrict__ step_ptr,
                         float* __restrict__ idx_out, int n, int steps,
                         SphereSet S, const __grid_constant__ MLPWeights m) {
  extern __shared__ __align__(16) float smem[];
  const int R = NRT_SCAN_RAYS, U = NRT_SCAN_UNROLL;
  float* sph = smem;                                 // [n_sph][13]
  float* o = sph + nrt_sphere_smem_floats(S.n);      // [R][3]
  float* d = o + nrt_round4(R * 3);                  // [R][3]
  float* ps = d + nrt_round4(R * 3);                 // [U*R][3] sample points
  float* sm = ps + nrt_round4(U * R * 3);            // [U*R] sphere smooth-min
  float* mlp_smem = sm + U * R;                      // 16-byte aligned

  nrt_load_spheres(S, sph);
  const int row0 = blockIdx.x * R;
  if (threadIdx.x < R * 3) {
    const int r = threadIdx.x / 3, g = row0 + r;
    o[threadIdx.x] = g < n ? ro[(size_t)row0 * 3 + threadIdx.x] : 0.f;
    d[threadIdx.x] = g < n ? rd[(size_t)row0 * 3 + threadIdx.x] : 0.f;
  }
  const float step = *step_ptr;
  float mn = 0.f;  // live in threads r < R: ray r's running minimum and index
  int best = 0;
  __syncthreads();

  // group 0 is sample 0 alone; group j >= 1 holds samples 1 + (j-1)U .. jU
  for (int i0 = 0; i0 <= steps; i0 += (i0 == 0 ? 1 : U)) {
    const int u_count = i0 == 0 ? 1 : U;
    const int rows = u_count * R;
    for (int idx = threadIdx.x; idx < rows * 3; idx += blockDim.x) {
      const int row = idx / 3, c = idx % 3;
      const int u = row / R, r = row % R;
      const float t = __fmul_rn(step, (float)(i0 + u));
      ps[idx] = __fadd_rn(o[r * 3 + c], __fmul_rn(t, d[r * 3 + c]));
    }
    // also orders the previous group's update before sm is overwritten
    __syncthreads();

    nrt_sphere_min(sph, S.n, S.k, S.stable, ps, sm, rows);
    const float* ob;
    int os;
    nrt_mlp_block<MODE>(m, ps, rows, mlp_smem, &ob, &os);  // ends with a barrier

    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      for (int u = 0; u < u_count; ++u) {
        const int i = i0 + u;
        if (i > steps) break;
        const float sd = sm[u * R + r] + ob[(u * R + r) * os];
        if (i == 0) {
          mn = sd;
        } else {
          if (sd < mn) best = i;
          // min(mn, sd), propagating a NaN as torch.minimum does
          if (sd < mn || sd != sd) mn = sd;
        }
      }
    }
  }

  if (threadIdx.x < R && row0 + threadIdx.x < n)
    idx_out[row0 + threadIdx.x] = (float)best;
}

extern "C" int nrt_fused_min_scan(const float* ro, const float* rd,
                                  const float* step, float* idx, int n, int steps,
                                  int bf16, const float* tfs, const float* centers,
                                  const float* radii, int n_spheres, float k,
                                  int stable, int in_size, int freqs, int hidden,
                                  int num_layers, int skip, int out_size, int act,
                                  const void* const* weights, void* stream) {
  MLPWeights m;
  if (n < 0 || n_spheres <= 0 || steps < 0 || in_size != 3 || out_size != 1 ||
      !nrt_fill_weights(m, in_size, freqs, hidden, num_layers, skip, out_size,
                        act, weights))
    return (int)cudaErrorInvalidValue;
  SphereSet S{tfs, centers, radii, n_spheres, k, stable};
  const int R = NRT_SCAN_RAYS, U = NRT_SCAN_UNROLL;
  const size_t floats = nrt_sphere_smem_floats(n_spheres) + 2 * nrt_round4(R * 3) +
                        nrt_round4(U * R * 3) + U * R +
                        nrt_mlp_smem_floats(m, U * R);
  const size_t smem = sizeof(float) * floats;
  const int grid = (n + R - 1) / R;
  if (bf16)
    return nrt_launch(nrt_fused_minscan_kernel<NRT_BF16_MARCH>, grid, smem, stream, ro, rd,
                      step, idx, n, steps, S, m);
  return nrt_launch(nrt_fused_minscan_kernel<NRT_F32>, grid, smem, stream, ro, rd, step,
                    idx, n, steps, S, m);
}
