// K4: fused no-grad shadow march through a SphereSDF.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_march.py
// (fused_shadow_march / _build_shadow_kernel): the loop of
// SDF.intersect_test.  One thread block owns NRT_ROWS shadow rays and runs
// the whole loop:
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
// A block leaves the loop once none of its rays is both live and valid;
// valid means a non-zero direction (sum |d| > 0) and a row below n, so
// zero-direction rays (masked light samples) never hold a block back.
// Their lanes keep the state they had, as in the TPU kernel.
// The sphere set and the shift MLP are the device code of K2 and K3
// (sphere_set.cuh, mlp.cuh), so the three loops evaluate one field.
// Bound on an H100: f32 FMA issue of the shift MLP (2 * 165,504 flops per
// ray and step for the 8x128 net) over the live ray-steps; with the
// past-light exit most shadow rays leave after a few steps.
// K4-bf16 (bf16 != 0, SDF(march_dtype=bfloat16)) runs the same loop over the
// NRT_BF16_MARCH operands of mlp.cuh.
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include "sphere_set.cuh"

template <int MODE>
__global__ void __launch_bounds__(NRT_THREADS)
nrt_fused_shadow_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                        const float* __restrict__ mt,
                        unsigned char* __restrict__ not_blocked, int n,
                        int max_steps, float eps, float depth0,
                        int past_light_exit, SphereSet S,
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
  int* state = reinterpret_cast<int*>(sm + R);   // [R] bit0 valid, bit1 remaining, bit2 live
  float* mlp_smem = sm + 2 * R;                  // 16-byte aligned: R % 4 == 0

  nrt_load_spheres(S, sph);
  const int row0 = blockIdx.x * R;
  if (threadIdx.x < R) {
    const int r = threadIdx.x, g = row0 + r;
    const bool in = g < n;
    float dsum = 0.f;
    for (int c = 0; c < 3; ++c) {
      o[r * 3 + c] = in ? ro[(size_t)g * 3 + c] : 0.f;
      d[r * 3 + c] = in ? rd[(size_t)g * 3 + c] : 0.f;
      dsum += fabsf(d[r * 3 + c]);
    }
    depth[r] = depth0;
    mx[r] = in ? mt[g] : 0.f;
    state[r] = (in && dsum > 0.f ? 1 : 0) | 2;
  }
  __syncthreads();

  for (int step = 0; step < max_steps; ++step) {
    int gate = 0;
    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      const int st = state[r];
      const int live = (st & 2) && (!past_light_exit || depth[r] < mx[r]);
      state[r] = (st & 3) | (live << 2);
      gate = live && (st & 1);
      const float t = depth[r];
      for (int c = 0; c < 3; ++c)
        ps[r * 3 + c] = __fadd_rn(o[r * 3 + c], __fmul_rn(d[r * 3 + c], t));
    }
    if (!__syncthreads_or(gate)) break;

    nrt_sphere_min(sph, S.n, S.k, S.stable, ps, sm, R);
    const float* ob;
    int os;
    nrt_mlp_block<MODE>(m, ps, R, mlp_smem, &ob, &os);  // ends with a barrier

    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      if (state[r] & 4) {
        const float sd = sm[r] + ob[r * os];
        if (sd < eps) state[r] &= ~2;
        depth[r] = depth[r] + sd;
      }
    }
    // the barrier at the top of the next step orders these updates
  }

  if (threadIdx.x < R) {
    const int r = threadIdx.x, g = row0 + r;
    if (g < n) not_blocked[g] = (depth[r] >= mx[r] || (state[r] & 2)) ? 1 : 0;
  }
}

extern "C" int nrt_fused_shadow_march(const float* ro, const float* rd,
                                      const float* mt, unsigned char* not_blocked,
                                      int n, int max_steps, float eps,
                                      float depth0, int past_light_exit, int bf16,
                                      const float* tfs, const float* centers,
                                      const float* radii, int n_spheres, float k,
                                      int stable, int in_size, int freqs,
                                      int hidden, int num_layers, int skip,
                                      int out_size, int act,
                                      const void* const* weights, void* stream) {
  MLPWeights m;
  if (n < 0 || n_spheres <= 0 || max_steps < 0 || in_size != 3 || out_size != 1 ||
      !nrt_fill_weights(m, in_size, freqs, hidden, num_layers, skip, out_size,
                        act, weights))
    return (int)cudaErrorInvalidValue;
  SphereSet S{tfs, centers, radii, n_spheres, k, stable};
  const int R = NRT_ROWS;
  const size_t floats = nrt_sphere_smem_floats(n_spheres) + 3 * nrt_round4(R * 3) +
                        4 * R + nrt_mlp_smem_floats(m, R);
  const size_t smem = sizeof(float) * floats;
  const int grid = (n + R - 1) / R;
  if (bf16)
    return nrt_launch(nrt_fused_shadow_kernel<NRT_BF16_MARCH>, grid, smem, stream, ro, rd,
                      mt, not_blocked, n, max_steps, eps, depth0, past_light_exit, S, m);
  return nrt_launch(nrt_fused_shadow_kernel<NRT_F32>, grid, smem, stream, ro, rd, mt,
                    not_blocked, n, max_steps, eps, depth0, past_light_exit, S, m);
}
