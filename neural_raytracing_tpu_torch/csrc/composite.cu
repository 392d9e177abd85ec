// K8: NeRF alpha compositing.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/composite.py
// (_pallas_composite / _kernel):
//   alpha_i = 1 - exp(-sigma_i * t_i)           (absolute sample position t_i)
//   T_i     = prod_{j<i} max(1 - alpha_j, 1e-10)
//   out     = sum_i alpha_i * T_i * rgb_i
// The TPU kernel transposes the samples onto the lane axis and builds the
// exclusive log-prefix-sum as a triangular [T, T] matmul on the MXU (Mosaic
// has no cumsum).  Here each ray is one thread and the transmittance is a
// running product in registers, in the caller's sample-major layout
// sigma [T][R], rgb [T][R][3]: at each sample a warp reads 32 consecutive
// sigmas and 96 consecutive colour floats, so every load is coalesced and
// nothing is transposed.  The sample positions (T floats) sit in shared
// memory.  Blocks are small (64 threads) so that the 10,000 rays of an eval
// tile spread over all SMs, and the sample loop is unrolled so that each
// thread has several samples' loads in flight at once.
// Bound on an H100: memory (16 bytes read per sample, 12 written per ray).
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include <cuda_runtime.h>

constexpr int NRT_COMPOSITE_THREADS = 64;

__global__ void __launch_bounds__(NRT_COMPOSITE_THREADS)
nrt_composite_kernel(const float* __restrict__ sigma, const float* __restrict__ rgb,
                     const float* __restrict__ ts, float* __restrict__ out,
                     int n_t, int n_r) {
  extern __shared__ float t_s[];                  // [n_t] sample positions
  for (int i = threadIdx.x; i < n_t; i += blockDim.x) t_s[i] = ts[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_r) return;
  float trans = 1.f, acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_t; ++i) {
    const size_t s = (size_t)i * n_r + r;
    const float alpha = 1.f - expf(-sigma[s] * t_s[i]);
    const float w = alpha * trans;
    const float* c = rgb + 3 * s;
    acc0 += w * c[0];
    acc1 += w * c[1];
    acc2 += w * c[2];
    trans *= fmaxf(1.f - alpha, 1e-10f);
  }
  out[3 * (size_t)r + 0] = acc0;
  out[3 * (size_t)r + 1] = acc1;
  out[3 * (size_t)r + 2] = acc2;
}

extern "C" int nrt_composite(const float* sigma, const float* rgb, const float* ts,
                             float* out, int n_t, int n_r, void* stream) {
  if (n_t < 0 || n_r < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)n_t;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (n_r == 0) return 0;
  const int grid = (n_r + NRT_COMPOSITE_THREADS - 1) / NRT_COMPOSITE_THREADS;
  nrt_composite_kernel<<<grid, NRT_COMPOSITE_THREADS, smem, (cudaStream_t)stream>>>(
      sigma, rgb, ts, out, n_t, n_r);
  return (int)cudaGetLastError();
}
