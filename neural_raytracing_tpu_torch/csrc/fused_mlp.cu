// K1: fused Fourier-encode + SkipConnMLP forward, its general route: the
// nets off the tile of fused_mlp_tile.cu (in_size other than 3, hidden > 256
// or freqs > 128; kernels/fused_mlp.py k1_route).
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_mlp.py
// (_pallas_forward / _build_kernel).  One thread block evaluates NRT_ROWS
// points end to end (encode -> init -> L hidden layers with skip concats ->
// out) with every intermediate in shared memory; only x is read and the
// output written.  Bound on an H100: f32 FMA issue (2 * MACs flops per point
// at 67 TFLOP/s); the bytes moved are tiny.  See mlp.cuh for the layout.
// K1-bf16 (bf16 != 0, SkipConnMLP(compute_dtype=bfloat16) in the JAX
// package) is the same kernel over the NRT_BF16_MLP operands of mlp.cuh: the
// same float32 FMAs on bf16-rounded operands.  Its least time on the card
// would be the tensor cores' (2 * MACs at 989 TFLOP/s); this simple version
// is still held to the f32 FMA rate.
//
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include "mlp.cuh"

template <int MODE>
__global__ void __launch_bounds__(NRT_THREADS)
nrt_fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int n, const __grid_constant__ MLPWeights m) {
  extern __shared__ __align__(16) float smem[];
  const int R = NRT_ROWS;
  const int in = m.in_size;
  float* xs = smem;                         // [R][in]
  float* mlp_smem = smem + nrt_round4(R * in);
  const int row0 = blockIdx.x * R;

  for (int idx = threadIdx.x; idx < R * in; idx += blockDim.x) {
    const int g = row0 + idx / in;
    xs[idx] = g < n ? x[(size_t)row0 * in + idx] : 0.f;
  }
  __syncthreads();

  const float* ob;
  int os;
  nrt_mlp_block<MODE>(m, xs, R, mlp_smem, &ob, &os);

  const int O = m.out_size;
  for (int idx = threadIdx.x; idx < R * O; idx += blockDim.x) {
    const int r = idx / O, c = idx % O;
    if (row0 + r < n) out[(size_t)(row0 + r) * O + c] = ob[r * os + c];
  }
}

extern "C" int nrt_fused_mlp_forward(const float* x, float* out, int n,
                                     int in_size, int freqs, int hidden,
                                     int num_layers, int skip, int out_size,
                                     int act, int bf16,
                                     const void* const* weights, void* stream) {
  MLPWeights m;
  if (n < 0 || !nrt_fill_weights(m, in_size, freqs, hidden, num_layers, skip,
                                 out_size, act, weights))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (nrt_round4(NRT_ROWS * in_size) + nrt_mlp_smem_floats(m, NRT_ROWS));
  const int grid = (n + NRT_ROWS - 1) / NRT_ROWS;
  if (bf16)
    return nrt_launch(nrt_fused_mlp_kernel<NRT_BF16_MLP>, grid, smem, stream, x, out, n, m);
  return nrt_launch(nrt_fused_mlp_kernel<NRT_F32>, grid, smem, stream, x, out, n, m);
}
