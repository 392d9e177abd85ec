// K5: fused SphereSDF evaluation, one value per point.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_sdf.py
// (_pallas_forward / _build_kernel):
//   sd(p) = smooth_min_i(|T_i p - c_i| - r_i) + shift_mlp(p)
// with the clamped or the exact (stable) smooth-min.  This is the inner
// evaluation of the loop kernels K2, K3 and K4, once per point: one thread
// block owns NRT_ROWS points, the 128 transformed spheres sit in shared
// memory (sphere_set.cuh) and the shift MLP is the device MLP of mlp.cuh.
// Only the points are read and one float per point written; the transformed
// points ([points, spheres, 3] in the plain version) never leave the block.
// Bound on an H100: f32 FMA issue of the shift MLP (2 * 165,504 flops per
// point for the 8x128 net).
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include "sphere_set.cuh"

__global__ void __launch_bounds__(NRT_THREADS)
nrt_fused_sdf_kernel(const float* __restrict__ p, float* __restrict__ out, int n,
                     SphereSet S, const __grid_constant__ MLPWeights m) {
  extern __shared__ __align__(16) float smem[];
  const int R = NRT_ROWS;
  float* sph = smem;                             // [n_sph][13]
  float* ps = sph + nrt_sphere_smem_floats(S.n); // [R][3] points
  float* sm = ps + nrt_round4(R * 3);            // [R] sphere smooth-min
  float* mlp_smem = sm + R;                      // 16-byte aligned: R % 4 == 0

  nrt_load_spheres(S, sph);
  const int row0 = blockIdx.x * R;
  for (int idx = threadIdx.x; idx < R * 3; idx += blockDim.x) {
    const int g = row0 + idx / 3;
    ps[idx] = g < n ? p[(size_t)row0 * 3 + idx] : 0.f;
  }
  __syncthreads();

  nrt_sphere_min(sph, S.n, S.k, S.stable, ps, sm, R);
  const float* ob;
  int os;
  nrt_mlp_block(m, ps, R, mlp_smem, &ob, &os);  // its barriers also order sm

  if (threadIdx.x < R) {
    const int r = threadIdx.x, g = row0 + r;
    if (g < n) out[g] = sm[r] + ob[r * os];
  }
}

extern "C" int nrt_fused_sphere_sdf(const float* p, float* out, int n,
                                    const float* tfs, const float* centers,
                                    const float* radii, int n_spheres, float k,
                                    int stable, int in_size, int freqs, int hidden,
                                    int num_layers, int skip, int out_size, int act,
                                    const void* const* weights, void* stream) {
  MLPWeights m;
  if (n < 0 || n_spheres <= 0 || in_size != 3 || out_size != 1 ||
      !nrt_fill_weights(m, in_size, freqs, hidden, num_layers, skip, out_size,
                        act, weights))
    return (int)cudaErrorInvalidValue;
  SphereSet S{tfs, centers, radii, n_spheres, k, stable};
  const int R = NRT_ROWS;
  const size_t floats = nrt_sphere_smem_floats(n_spheres) + nrt_round4(R * 3) + R +
                        nrt_mlp_smem_floats(m, R);
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      nrt_fused_sdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int grid = (n + R - 1) / R;
  nrt_fused_sdf_kernel<<<grid, NRT_THREADS, smem, (cudaStream_t)stream>>>(p, out, n, S, m);
  return (int)cudaGetLastError();
}
