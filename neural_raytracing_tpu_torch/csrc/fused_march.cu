// K2: fused no-grad sphere trace through a SphereSDF.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_march.py
// (fused_march / _build_march_kernel / _make_sdf_eval), plain (omega = 1)
// and over-relaxed (1 < omega < 2, Keinert et al. 2014).
// One thread block owns NRT_ROWS rays and runs the whole march loop:
//   remaining = valid & !hit & depth < max_t
//   sd        = smooth_min_i(|T_i p - c_i| - r_i) + shift_mlp(p),  p = o + d * depth
//   fail      = remaining & om > 1 & (|sd| + |prev| <= step | sd < -eps)
//   hit      |= remaining & !fail & sd <= eps
//   step      = fail ? (1 - om) * step : om * sd;  om = fail ? 1 : om
//   depth += step, prev = sd where still remaining
// Each ray keeps three values of the relaxation in shared memory: the
// previous SDF, the last step and its own omega (which falls to 1 at its
// first failure: the failed step is taken back and the ray marches plainly
// from there).  With omega = 1 no step fails and om * sd == sd exactly, so
// the loop is the plain sphere trace.  Products and sums are rounded one by
// one (no contraction into FMAs), as the plain version computes them.
// The 128 transformed spheres sit in shared memory (sphere_set.cuh, shared
// with the min-scan K3); the shift MLP is the device MLP of mlp.cuh (the
// same network the fused MLP kernel evaluates).
// A block leaves the loop as soon as none of its rays remains
// (__syncthreads_or); rows past n are invalid and never hold it back.
// Bound on an H100: f32 FMA issue of the shift MLP (2 * 165,504 flops per
// ray and step for the 8x128 net) over the steps each ray needs.
// K2-bf16 (bf16 != 0, SDF(march_dtype=bfloat16)) runs the same loop over the
// NRT_BF16_MARCH operands of mlp.cuh; the sphere set and the loop stay f32.
//
// Bounded mode (t0 != nullptr): per-ray start t0 and end max_t (the
// march_bound clip); otherwise depth starts at 0 and max_t is one scalar.
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include "sphere_set.cuh"

template <int MODE>
__global__ void __launch_bounds__(NRT_THREADS)
nrt_fused_march_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                       const float* __restrict__ t0, const float* __restrict__ mt,
                       float max_t, float* __restrict__ depth_out,
                       unsigned char* __restrict__ hit_out, int n, int max_steps,
                       float eps, float omega, SphereSet S,
                       const __grid_constant__ MLPWeights m) {
  extern __shared__ __align__(16) float smem[];
  const int R = NRT_ROWS;
  float* sph = smem;                             // [n_sph][13]
  float* ps = sph + nrt_sphere_smem_floats(S.n); // [R][3] march points
  float* o = ps + nrt_round4(R * 3);             // [R][3]
  float* d = o + nrt_round4(R * 3);              // [R][3]
  float* depth = d + nrt_round4(R * 3);          // [R]
  float* mx = depth + R;                         // [R] per-ray max_t
  float* sm = mx + R;                            // [R] sphere smooth-min
  float* prev = sm + R;                          // [R] SDF at the previous point
  float* slen = prev + R;                        // [R] last step taken
  float* om = slen + R;                          // [R] the ray's omega
  int* state = reinterpret_cast<int*>(om + R);   // [R] bit0 valid, bit1 hit, bit2 remaining
  float* mlp_smem = om + 2 * R;                  // 16-byte aligned: R % 4 == 0

  nrt_load_spheres(S, sph);
  const int row0 = blockIdx.x * R;
  if (threadIdx.x < R) {
    const int r = threadIdx.x, g = row0 + r;
    const bool valid = g < n;
    for (int c = 0; c < 3; ++c) {
      o[r * 3 + c] = valid ? ro[(size_t)g * 3 + c] : 0.f;
      d[r * 3 + c] = valid ? rd[(size_t)g * 3 + c] : 0.f;
    }
    depth[r] = valid && t0 ? t0[g] : 0.f;
    mx[r] = valid && mt ? mt[g] : max_t;
    prev[r] = 0.f;
    slen[r] = 0.f;
    om[r] = omega;
    state[r] = valid ? 1 : 0;
  }
  __syncthreads();

  for (int step = 0; step < max_steps; ++step) {
    int rem = 0;
    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      rem = (state[r] & 1) && !(state[r] & 2) && depth[r] < mx[r];
      state[r] = (state[r] & 3) | (rem << 2);
      const float t = depth[r];
      for (int c = 0; c < 3; ++c)
        ps[r * 3 + c] = __fadd_rn(o[r * 3 + c], __fmul_rn(d[r * 3 + c], t));
    }
    if (!__syncthreads_or(rem)) break;

    nrt_sphere_min(sph, S.n, S.k, S.stable, ps, sm, R);
    const float* ob;
    int os;
    nrt_mlp_block<MODE>(m, ps, R, mlp_smem, &ob, &os);  // ends with a barrier

    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      if (state[r] & 4) {
        const float sd = __fadd_rn(sm[r], ob[r * os]);
        const float o = om[r], l = slen[r];
        const bool fail = o > 1.f && (__fadd_rn(fabsf(sd), fabsf(prev[r])) <= l ||
                                      sd < -eps);
        if (!fail && sd <= eps) {
          state[r] |= 2;
        } else {
          const float step = fail ? __fmul_rn(__fsub_rn(1.f, o), l) : __fmul_rn(o, sd);
          if (fail) om[r] = 1.f;
          depth[r] = __fadd_rn(depth[r], step);
          slen[r] = step;
          prev[r] = sd;
        }
      }
    }
    // the barrier at the top of the next step orders these updates
  }

  if (threadIdx.x < R) {
    const int r = threadIdx.x, g = row0 + r;
    if (g < n) {
      depth_out[g] = depth[r];
      hit_out[g] = (state[r] & 2) ? 1 : 0;
    }
  }
}

extern "C" int nrt_fused_march(const float* ro, const float* rd, const float* t0,
                               const float* mt, float max_t, float* depth,
                               unsigned char* hit, int n, int max_steps, float eps,
                               float omega, int bf16, const float* tfs,
                               const float* centers, const float* radii,
                               int n_spheres, float k, int stable,
                               int in_size, int freqs, int hidden, int num_layers,
                               int skip, int out_size, int act,
                               const void* const* weights, void* stream) {
  MLPWeights m;
  if (n < 0 || n_spheres <= 0 || max_steps < 0 || in_size != 3 || out_size != 1 ||
      !(omega >= 1.f && omega < 2.f) ||
      (t0 == nullptr) != (mt == nullptr) ||
      !nrt_fill_weights(m, in_size, freqs, hidden, num_layers, skip, out_size,
                        act, weights))
    return (int)cudaErrorInvalidValue;
  SphereSet S{tfs, centers, radii, n_spheres, k, stable};
  const int R = NRT_ROWS;
  const size_t floats = nrt_sphere_smem_floats(n_spheres) + 3 * nrt_round4(R * 3) +
                        7 * R + nrt_mlp_smem_floats(m, R);
  const size_t smem = sizeof(float) * floats;
  const int grid = (n + R - 1) / R;
  if (bf16)
    return nrt_launch(nrt_fused_march_kernel<NRT_BF16_MARCH>, grid, smem, stream, ro, rd,
                      t0, mt, max_t, depth, hit, n, max_steps, eps, omega, S, m);
  return nrt_launch(nrt_fused_march_kernel<NRT_F32>, grid, smem, stream, ro, rd, t0, mt,
                    max_t, depth, hit, n, max_steps, eps, omega, S, m);
}
