// Device-side SkipConnMLP shared by the fused MLP kernel's general route
// (fused_mlp.cu: K1 for a net off the tile), the fused SDF (fused_sdf.cu) and
// the MLP backward (fused_mlp_bwd.cu), so every kernel evaluates exactly the
// network the MLP kernel evaluates.  The march K2, the min-scan K3, the
// shadow march K4 and K1 for the nets the port builds (fused_mlp_tile.cu)
// run on the tiles of mlp_tiled.cuh instead, with the same float32 sums.
//
// Math (neural_raytracing_tpu_torch/nn/mlp.py, the plain version):
//   enc = [x, sin(x B), cos(x B)]
//   h   = act(enc W_init + b_init)
//   h   = act([h, act(enc)] W_i + b_i)     on a skip layer (i % skip == 0, i != L-1)
//   h   = act(h W_i + b_i)                 otherwise
//   out = h W_out + b_out
// All weights are float32 in the JAX layout [fan_in, fan_out].
//
// Design: a thread block owns NRT_ROWS rows.  Their encoded input and
// activations live in dynamic shared memory; the weights are read from
// global memory (a net is at most ~1.5 MB and stays resident in the 50 MB
// L2).  Each thread computes NRT_RT rows of one output column with f32 FMAs,
// reading four activations at a time as a float4 broadcast, so a warp issues
// one shared-memory load per four FMAs and one coalesced weight load per
// column.  The bound on the card is the f32 FMA rate (the kernel does not
// use tensor cores, to stay in IEEE float32 like the reference).
//
// Operand modes (a template parameter, so the float32 path's code and
// registers do not depend on the bf16 one), the compute_dtype of the JAX
// kernels:
//   NRT_F32        float32 operands, as above;
//   NRT_BF16_MLP   K1's bf16 operands (neural_raytracing_tpu/kernels/
//                  fused_mlp.py:77-91): the init layer reads the encoding
//                  rounded to bf16, the skip layers act(enc) of the float32
//                  encoding, rounded (the march kernels' bf16 operands,
//                  which take act() of the ROUNDED encoding, are the bf16
//                  tile of mlp_tiled.cuh).
// In the bf16 mode every hidden operand is act(h) rounded to bf16 (round to
// nearest even, as astype), and the weight matrices m.w[i] point at bf16
// arrays (the wrapper casts them once per call); biases, B, sin/cos and the
// output stay float32.  Activations are kept in shared memory as bf16-valued
// floats.  The product of two bf16 values is exact in float32, so the fmaf
// that adds it rounds only the sum, as a bf16 x bf16 -> f32 matmul does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define NRT_MAX_LAYERS 32
#define NRT_ROWS 32      // rows (points or rays) per thread block
#define NRT_THREADS 256  // threads per block
#define NRT_RT 8         // rows per thread in a wide layer

// Activation codes; kernels/fused_mlp.py keeps the same table.
enum NrtAct {
  NRT_LEAKY_RELU = 0,
  NRT_RELU = 1,
  NRT_SOFTPLUS = 2,
  NRT_SIGMOID = 3,
  NRT_TANH = 4,
  NRT_ELU = 5,
  NRT_IDENTITY = 6,
};

enum NrtOperands {
  NRT_F32 = 0,
  NRT_BF16_MLP = 1,
};

// The type the weight matrices are stored in, by operand mode.
template <int MODE> struct NrtWeight { typedef float T; };
template <> struct NrtWeight<NRT_BF16_MLP> { typedef __nv_bfloat16 T; };

__device__ __forceinline__ float nrt_ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float nrt_ldw(const __nv_bfloat16* p) {
  // a bf16 value is the top half of the float32 with the same value
  return __uint_as_float(
      (unsigned int)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// x rounded to the nearest bf16 value (ties to even), as a float.
__device__ __forceinline__ float nrt_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct MLPWeights {
  const float* B;                       // [in_size, freqs]
  const float* w[NRT_MAX_LAYERS + 2];   // init, layers 0..L-1, out (bf16 arrays
                                        // in a bf16 operand mode)
  const float* b[NRT_MAX_LAYERS + 2];
  int in_size, freqs, hidden, num_layers, skip, out_size, act;
};

__host__ __device__ inline int nrt_round4(int x) { return (x + 3) & ~3; }

// Fills the weight struct from the host array
// [B, init_w, init_b, layer0_w, layer0_b, ..., out_w, out_b].
// Returns false if the net does not fit the struct.
inline bool nrt_fill_weights(MLPWeights& m, int in_size, int freqs, int hidden,
                             int num_layers, int skip, int out_size, int act,
                             const void* const* ptrs) {
  if (num_layers < 0 || num_layers > NRT_MAX_LAYERS || skip <= 0 ||
      in_size <= 0 || freqs < 0 || hidden <= 0 || out_size <= 0 || act < 0 ||
      act > NRT_IDENTITY)
    return false;
  m.in_size = in_size;
  m.freqs = freqs;
  m.hidden = hidden;
  m.num_layers = num_layers;
  m.skip = skip;
  m.out_size = out_size;
  m.act = act;
  m.B = static_cast<const float*>(ptrs[0]);
  for (int i = 0; i < num_layers + 2; ++i) {
    m.w[i] = static_cast<const float*>(ptrs[1 + 2 * i]);
    m.b[i] = static_cast<const float*>(ptrs[2 + 2 * i]);
  }
  return true;
}

// Shared floats the MLP needs for R rows: enc, two hidden buffers, output.
inline size_t nrt_mlp_smem_floats(const MLPWeights& m, int R) {
  const int E = m.in_size + 2 * m.freqs;
  return (size_t)R * (nrt_round4(E) + 2 * nrt_round4(m.hidden) +
                      nrt_round4(m.out_size));
}

// Host side: sets the kernel's dynamic shared memory limit and launches it
// on grid blocks of NRT_THREADS threads.  Returns a cudaError_t as int.
template <typename Kernel, typename... Args>
inline int nrt_launch(Kernel kernel, int grid, size_t smem, void* stream,
                      Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {   // e.g. more shared memory than a block has
    cudaGetLastError();       // not left for the next launch's check
    return (int)err;
  }
  if (grid == 0) return 0;
  kernel<<<grid, NRT_THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float nrt_act(float x, int act) {
  switch (act) {
    case NRT_LEAKY_RELU: return x >= 0.f ? x : 0.01f * x;
    case NRT_RELU: return fmaxf(x, 0.f);
    case NRT_SOFTPLUS: return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
    case NRT_SIGMOID: return 1.f / (1.f + expf(-x));
    case NRT_TANH: return tanhf(x);
    case NRT_ELU: return x > 0.f ? x : expm1f(x);
    default: return x;
  }
}

// d act / d x at the pre-activation x; the table ACTIVATION_GRADS of
// nn/mlp.py (and of the JAX package) is the same.
__device__ __forceinline__ float nrt_dact(float x, int act) {
  switch (act) {
    case NRT_LEAKY_RELU: return x >= 0.f ? 1.f : 0.01f;
    case NRT_RELU: return x >= 0.f ? 1.f : 0.f;
    case NRT_SOFTPLUS: return 1.f / (1.f + expf(-x));
    case NRT_SIGMOID: {
      const float s = 1.f / (1.f + expf(-x));
      return s * (1.f - s);
    }
    case NRT_TANH: {
      const float t = tanhf(x);
      return 1.f - t * t;
    }
    case NRT_ELU: return x > 0.f ? 1.f : expf(x);
    default: return 1.f;
  }
}

// acc[r] += sum_k s[r*ld + k] * W[k*N + j] for k < K.
// s is 16-byte aligned and ld % 4 == 0.  W is float or bf16.
template <int RT, typename WT>
__device__ __forceinline__ void nrt_accum(float (&acc)[RT], const float* s,
                                          int ld, int K,
                                          const WT* __restrict__ W, int N,
                                          int j) {
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    const float w0 = nrt_ldw(W + (size_t)(k + 0) * N + j);
    const float w1 = nrt_ldw(W + (size_t)(k + 1) * N + j);
    const float w2 = nrt_ldw(W + (size_t)(k + 2) * N + j);
    const float w3 = nrt_ldw(W + (size_t)(k + 3) * N + j);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(s + r * ld + k);
      acc[r] = fmaf(a.x, w0, acc[r]);
      acc[r] = fmaf(a.y, w1, acc[r]);
      acc[r] = fmaf(a.z, w2, acc[r]);
      acc[r] = fmaf(a.w, w3, acc[r]);
    }
  }
  for (; k < K; ++k) {
    const float w = nrt_ldw(W + (size_t)k * N + j);
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = fmaf(s[r * ld + k], w, acc[r]);
  }
}

// dst[r][j] = act(row_r . W[:, j] + bias[j]) for r < R, j < N, where row_r
// is the K1 columns of s1 followed by the K2 columns of s2 (the skip
// concatenation without a copy).  act < 0 means no activation (the output
// layer); otherwise a bf16 operand mode stores the value rounded to bf16.
template <int RT, int MODE = NRT_F32>
__device__ void nrt_linear_rt(const float* s1, int ld1, int K1,
                              const float* s2, int ld2, int K2,
                              const typename NrtWeight<MODE>::T* __restrict__ W,
                              const float* __restrict__ bias, int N,
                              float* dst, int ldd, int R, int act) {
  const int n_items = (R / RT) * N;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int j = item % N;
    const int r0 = (item / N) * RT;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    nrt_accum<RT>(acc, s1 + r0 * ld1, ld1, K1, W, N, j);
    if (K2 > 0) nrt_accum<RT>(acc, s2 + r0 * ld2, ld2, K2, W + (size_t)K1 * N, N, j);
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float v = acc[r] + bj;
      if (act >= 0) v = nrt_act(v, act);
      if (MODE != NRT_F32 && act >= 0) v = nrt_bf16(v);
      dst[(r0 + r) * ldd + j] = v;
    }
  }
}

template <int MODE = NRT_F32>
__device__ __forceinline__ void nrt_linear(const float* s1, int ld1, int K1,
                                           const float* s2, int ld2, int K2,
                                           const typename NrtWeight<MODE>::T* __restrict__ W,
                                           const float* __restrict__ bias,
                                           int N, float* dst, int ldd, int R,
                                           int act) {
  // narrow layers (the output heads) spread rows over threads instead
  if (N >= 32 && R % NRT_RT == 0)
    nrt_linear_rt<NRT_RT, MODE>(s1, ld1, K1, s2, ld2, K2, W, bias, N, dst, ldd, R, act);
  else
    nrt_linear_rt<1, MODE>(s1, ld1, K1, s2, ld2, K2, W, bias, N, dst, ldd, R, act);
}

// Stores the encoding value v at enc[i]: v itself (rounded to bf16 in a
// bf16 mode) or, with ACT (K1's skip operand), act(v) rounded to bf16.
template <int MODE, bool ACT>
__device__ __forceinline__ void nrt_put_enc(float* enc, int i, float v, int act) {
  if (ACT)
    enc[i] = nrt_bf16(nrt_act(v, act));
  else
    enc[i] = MODE == NRT_F32 ? v : nrt_bf16(v);
}

// enc[r] = [x, sin(x B), cos(x B)] for the R rows of xs ([R][in_size]),
// row stride es, stored as nrt_put_enc<MODE, ACT> stores it.  The caller
// synchronises before reading enc.
template <int MODE = NRT_F32, bool ACT = false>
__device__ void nrt_fourier_encode(const MLPWeights& m, const float* xs, int R,
                                   float* enc, int es) {
  const int in = m.in_size, F = m.freqs;
  for (int idx = threadIdx.x; idx < R * (in + F); idx += blockDim.x) {
    const int r = idx / (in + F), c = idx % (in + F);
    const float* x = xs + r * in;
    if (c < in) {
      nrt_put_enc<MODE, ACT>(enc, r * es + c, x[c], m.act);
    } else {
      const int f = c - in;
      float mapped = 0.f;
      for (int d = 0; d < in; ++d) mapped = fmaf(x[d], __ldg(m.B + d * F + f), mapped);
      nrt_put_enc<MODE, ACT>(enc, r * es + in + f, sinf(mapped), m.act);
      nrt_put_enc<MODE, ACT>(enc, r * es + in + F + f, cosf(mapped), m.act);
    }
  }
}

// Evaluates the MLP on the R rows of xs ([R][in_size] in shared memory)
// with MODE's operands.  smem holds nrt_mlp_smem_floats(m, R) floats
// (16-byte aligned).  On return (after a barrier) the outputs are at *out,
// row stride *out_ld.  xs must stay in place until then.
template <int MODE = NRT_F32>
__device__ void nrt_mlp_block(const MLPWeights& m, const float* xs, int R,
                              float* smem, const float** out, int* out_ld) {
  typedef typename NrtWeight<MODE>::T WT;
  const int in = m.in_size, F = m.freqs, H = m.hidden;
  const int E = in + 2 * F;
  const int es = nrt_round4(E), hs = nrt_round4(H), os = nrt_round4(m.out_size);
  float* enc = smem;
  float* ha = enc + R * es;
  float* hb = ha + R * hs;
  float* ob = hb + R * hs;

  nrt_fourier_encode<MODE>(m, xs, R, enc, es);
  __syncthreads();

  nrt_linear<MODE>(enc, es, E, nullptr, 0, 0, reinterpret_cast<const WT*>(m.w[0]),
                   m.b[0], H, ha, hs, R, m.act);
  __syncthreads();
  // skip layers see act(enc): the raw encoding is not needed any more
  if (MODE == NRT_BF16_MLP) {
    // K1 rounds act() of the float32 encoding: encode again (cheap beside
    // the layers) rather than keep a second copy in shared memory
    nrt_fourier_encode<MODE, true>(m, xs, R, enc, es);
  } else {
    for (int idx = threadIdx.x; idx < R * E; idx += blockDim.x) {
      const int r = idx / E, c = idx % E;
      enc[r * es + c] = nrt_act(enc[r * es + c], m.act);
    }
  }
  __syncthreads();

  float* cur = ha;
  float* nxt = hb;
  for (int i = 0; i < m.num_layers; ++i) {
    const bool skip = (i % m.skip) == 0 && i != m.num_layers - 1;
    nrt_linear<MODE>(cur, hs, H, enc, es, skip ? E : 0,
                     reinterpret_cast<const WT*>(m.w[1 + i]), m.b[1 + i], H,
                     nxt, hs, R, m.act);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  nrt_linear<MODE>(cur, hs, H, nullptr, 0, 0,
                   reinterpret_cast<const WT*>(m.w[m.num_layers + 1]),
                   m.b[m.num_layers + 1], m.out_size, ob, os, R, -1);
  __syncthreads();
  *out = ob;
  *out_ld = os;
}
