// Register-tiled device shift net of the silhouette min-scan K3
// (fused_minscan.cu), over the packed weights that
// kernels/fused_march.py pack_shift_weights lays out.  K1, K2 and K4-K7
// keep the device MLP of mlp.cuh.
//
// A block evaluates the net on M rows at once.  Its activations live in ONE
// shared buffer with a row per "k" of the layers' products: the hidden
// columns h at k in [0, NP), act(enc) (the raw encoding before the init
// layer) at k in [NP, NP + EP).  So a skip layer reads [h, act(enc)] as one
// K = NP + EP product, the init layer the K = EP rows from NP, a plain layer
// the K = NP rows from 0.  A layer's whole output sits in registers until
// every thread has finished reading the buffer, then overwrites the h rows.
//
// Widths: NP = 128 (hidden <= 128, M = 128 rows) or 256 (hidden <= 256,
// M = 64 rows); EP = the encoding width 3 + 2 * freqs rounded up to 8 (f32)
// or 16 (bf16).  Padded weight rows and columns and padded biases are zero,
// so a padded output column is act(0), finite, and every later layer meets
// it with a zero weight row: it adds exactly 0.
//
// Packed layout (the pointer table [B, init w, init b, layer 0 w, layer 0 b,
// ..., out w, out b]):
//   B      [3, freqs] float32, as the module's;
//   biases [NP] float32;
//   f32    layer weights [K][NP] float32, k-major, with the columns in the
//          order the thread tile reads them: physical column p holds
//          logical output column nrt_tiled_col(p);
//   bf16   layer weights W^T [NP][K] bf16 (n-major, k contiguous): the
//          "col" B operand of mma.m16n8k16;
//   out w  [NP] float32 (bf16 values in the bf16 mode), out b [1].
// K of layer l: EP (l = 0, the init layer), NP + EP (hidden layer l - 1 is a
// skip layer), NP otherwise.
#pragma once

#include <stdint.h>

#include "sphere_set.cuh"

#define NRT_TILE_U 4          // samples of one ray per MLP evaluation
#define NRT_F32_KC 8          // k rows of W per f32 chunk
#define NRT_BF16_KC 32        // k per bf16 chunk
#define NRT_BF16_WLD 40       // bf16 row stride of a staged W^T chunk (20 words = 4 mod 8)

struct TiledNet {
  const float* B;                        // [3, F]
  const void* w[NRT_MAX_LAYERS + 1];     // init, hidden 0..L-1 (packed)
  const float* b[NRT_MAX_LAYERS + 1];    // [NP]
  const float* w_out;                    // [NP]
  const float* b_out;                    // [1]
  int F, H, L, skip, act, E, EP, NP;
};

// Rows per block for an NP-wide layer.
__host__ __device__ constexpr int nrt_tiled_rows(int NP) { return NP == 128 ? 128 : 64; }

// The logical output column of physical column p of a packed f32 matrix:
// thread tx's TN = NP/16 columns tx + 16 c sit at p = 64 (c / 4) + 4 tx + c % 4,
// so a thread reads its weights as float4s and 8 threads read 128 contiguous
// bytes, while the columns a quarter-warp writes back are 1 row of the
// activation buffer apart (conflict-free with a row stride of 4 mod 32).
__host__ __device__ inline int nrt_tiled_col(int p) {
  return (p % 64) / 4 + 16 * (4 * (p / 64) + p % 4);
}

inline bool nrt_tiled_fill(TiledNet& m, int freqs, int hidden, int num_layers, int skip,
                           int act, int bf16, const void* const* ptrs) {
  if (num_layers < 0 || num_layers > NRT_MAX_LAYERS || skip <= 0 || freqs < 0 ||
      freqs > 128 || hidden <= 0 || hidden > 256 || act < 0 || act > NRT_IDENTITY)
    return false;
  m.F = freqs;
  m.H = hidden;
  m.L = num_layers;
  m.skip = skip;
  m.act = act;
  m.E = 3 + 2 * freqs;
  const int r = bf16 ? 16 : 8;
  m.EP = (m.E + r - 1) / r * r;
  m.NP = hidden <= 128 ? 128 : 256;
  m.B = static_cast<const float*>(ptrs[0]);
  for (int l = 0; l <= num_layers; ++l) {
    m.w[l] = ptrs[1 + 2 * l];
    m.b[l] = static_cast<const float*>(ptrs[2 + 2 * l]);
  }
  m.w_out = static_cast<const float*>(ptrs[1 + 2 * (num_layers + 1)]);
  m.b_out = static_cast<const float*>(ptrs[2 + 2 * (num_layers + 1)]);
  return true;
}

// K and first activation row of layer l (0 = init, 1 + i = hidden layer i).
__device__ __forceinline__ int nrt_tiled_k(const TiledNet& m, int l) {
  if (l == 0) return m.EP;
  const int i = l - 1;
  return (i % m.skip == 0 && i != m.L - 1) ? m.NP + m.EP : m.NP;
}
__device__ __forceinline__ int nrt_tiled_kbase(const TiledNet& m, int l) {
  return l == 0 ? m.NP : 0;
}

// Calls f(NrtActCode<A>()) with the activation code act as a compile-time
// constant A.  The epilogues take the activation as a template parameter:
// with the code a run-time value, each of a thread's 64 outputs carried the
// whole switch of nrt_act inline, and that code outgrew the instruction cache.
template <int A> struct NrtActCode { static constexpr int value = A; };

template <typename F>
__device__ __forceinline__ void nrt_with_act(int act, F f) {
  switch (act) {
    case NRT_LEAKY_RELU: f(NrtActCode<NRT_LEAKY_RELU>()); break;
    case NRT_RELU: f(NrtActCode<NRT_RELU>()); break;
    case NRT_SOFTPLUS: f(NrtActCode<NRT_SOFTPLUS>()); break;
    case NRT_SIGMOID: f(NrtActCode<NRT_SIGMOID>()); break;
    case NRT_TANH: f(NrtActCode<NRT_TANH>()); break;
    case NRT_ELU: f(NrtActCode<NRT_ELU>()); break;
    default: f(NrtActCode<NRT_IDENTITY>()); break;
  }
}

// ---- asynchronous copies ------------------------------------------------------

__device__ __forceinline__ void nrt_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void nrt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void nrt_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- f32: an outer-product tile on the CUDA cores ------------------------------
//
// 256 threads as 16 (ty, rows) x 16 (tx, columns); a thread owns TM = M/16
// rows ((r / 4) * 64 + 4 ty + r % 4) by TN = NP/16 columns (tx + 16 c), TM x
// TN = 64 sums.  Activations are stored k-major, act[k * LD + row], LD = M + 4.
// Per k a thread loads TM/4 float4 of activations and TN/4 float4 of weights
// from shared memory for 64 FMAs.  W streams through two KC x NP buffers
// with cp.async: chunk c + 1 loads while chunk c is used, one barrier each.

// Copies KC rows of W (a packed [K][NP] f32 matrix, row k0 at src) into dst.
template <int NP>
__device__ __forceinline__ void nrt_f32_issue(const float* __restrict__ src, float* dst) {
  for (int p = threadIdx.x; p < NRT_F32_KC * NP / 4; p += blockDim.x)
    nrt_cp_async16(dst + 4 * p, src + 4 * p);
  nrt_cp_async_commit();
}

// acc = act[kbase .. kbase + K) (rows of the thread's tile) x W, each sum
// from 0 by fmaf in ascending k.  On entry chunk 0 of W is in flight to
// wbuf[buf]; on return buf names the buffer that is free.
template <int NP>
__device__ __forceinline__ void nrt_f32_gemm(float (&acc)[nrt_tiled_rows(NP) / 16][NP / 16],
                                             const float* act, int kbase, int K,
                                             const float* __restrict__ W, float* wbuf,
                                             int& buf) {
  constexpr int M = nrt_tiled_rows(NP), LD = M + 4, TM = M / 16, TN = NP / 16;
  constexpr int KC = NRT_F32_KC;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  const int nc = K / KC;
  for (int ch = 0; ch < nc; ++ch) {
    nrt_cp_async_wait_all();
    __syncthreads();  // chunk ch landed; every thread is done with chunk ch - 1
    if (ch + 1 < nc)
      nrt_f32_issue<NP>(W + (size_t)(ch + 1) * KC * NP, wbuf + (buf ^ 1) * KC * NP);
    const float* wc = wbuf + buf * KC * NP;
    const float* ac = act + (size_t)(kbase + ch * KC) * LD;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(ac + kk * LD + q * 64 + ty * 4);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(wc + kk * NP + q * 64 + tx * 4);
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
    buf ^= 1;
  }
}

// h rows of act = ACT(acc + bias) (the caller has synchronised: nobody
// reads act any more).
template <int NP, int ACT>
__device__ __forceinline__ void nrt_f32_store(const float (&acc)[nrt_tiled_rows(NP) / 16][NP / 16],
                                              const float* __restrict__ bias, float* act) {
  constexpr int M = nrt_tiled_rows(NP), LD = M + 4, TM = M / 16, TN = NP / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int j = tx + 16 * c;
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      float4 v;
      v.x = nrt_act(acc[4 * q][c] + bj, ACT);
      v.y = nrt_act(acc[4 * q + 1][c] + bj, ACT);
      v.z = nrt_act(acc[4 * q + 2][c] + bj, ACT);
      v.w = nrt_act(acc[4 * q + 3][c] + bj, ACT);
      *reinterpret_cast<float4*>(act + j * LD + q * 64 + ty * 4) = v;
    }
  }
}

// ---- bf16: mma.sync m16n8k16 on the tensor cores --------------------------------
//
// Activations are bf16, row-major act[row * LDA + k] (LDA = NP + EP + 8, a
// word stride of 4 mod 8: the fragment loads are conflict-free).  8 warps
// as (M / 64) x (NP / 32 / (M / 64)); a warp owns 64 rows x 32 columns, 4 x 4
// m16n8 tiles, 64 float32 sums a thread.  W^T streams through two NP x 32
// chunks (row stride NRT_BF16_WLD) with cp.async, as the f32 tile does.

__device__ __forceinline__ void nrt_mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t nrt_ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies chunk ch (k in [32 ch, 32 ch + kc)) of W^T ([NP][K] bf16) into dst.
template <int NP>
__device__ __forceinline__ void nrt_bf16_issue(const __nv_bfloat16* __restrict__ W, int K,
                                               int ch, __nv_bfloat16* dst) {
  const int k0 = ch * NRT_BF16_KC;
  const int per_row = min(NRT_BF16_KC, K - k0) / 8;   // 16-byte pieces
  for (int p = threadIdx.x; p < NP * per_row; p += blockDim.x) {
    const int n = p / per_row, piece = p % per_row;
    nrt_cp_async16(dst + n * NRT_BF16_WLD + 8 * piece, W + (size_t)n * K + k0 + 8 * piece);
  }
  nrt_cp_async_commit();
}

template <int NP>
__device__ __forceinline__ void nrt_bf16_gemm(float (&acc)[4][4][4], const __nv_bfloat16* act,
                                              int lda, int kbase, int K,
                                              const __nv_bfloat16* __restrict__ W,
                                              __nv_bfloat16* wbuf, int& buf) {
  constexpr int WM = nrt_tiled_rows(NP) / 64, WN = 8 / WM;
  constexpr int WCHUNK = NP * NRT_BF16_WLD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (warp / WN) * 64, col0 = (warp % WN) * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int nc = (K + NRT_BF16_KC - 1) / NRT_BF16_KC;
  for (int ch = 0; ch < nc; ++ch) {
    nrt_cp_async_wait_all();
    __syncthreads();  // chunk ch landed; every warp is done with chunk ch - 1
    if (ch + 1 < nc) nrt_bf16_issue<NP>(W, K, ch + 1, wbuf + (buf ^ 1) * WCHUNK);
    const __nv_bfloat16* wc = wbuf + buf * WCHUNK;
    const int steps = min(NRT_BF16_KC, K - ch * NRT_BF16_KC) / 16;
#pragma unroll
    for (int ks = 0; ks < NRT_BF16_KC / 16; ++ks) {
      if (ks < steps) {
        const int ka = kbase + ch * NRT_BF16_KC + ks * 16 + 2 * t;
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const __nv_bfloat16* p = act + (size_t)(row0 + mi * 16 + g) * lda + ka;
          a[mi][0] = nrt_ld32(p);
          a[mi][1] = nrt_ld32(p + 8 * lda);
          a[mi][2] = nrt_ld32(p + 8);
          a[mi][3] = nrt_ld32(p + 8 * lda + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* p = wc + (col0 + ni * 8 + g) * NRT_BF16_WLD + ks * 16 + 2 * t;
          b[ni][0] = nrt_ld32(p);
          b[ni][1] = nrt_ld32(p + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) nrt_mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
    }
    buf ^= 1;
  }
}

// h columns of act = bf16(ACT(acc + bias)), from the accumulator fragments.
template <int NP, int ACT>
__device__ __forceinline__ void nrt_bf16_store(const float (&acc)[4][4][4],
                                               const float* __restrict__ bias,
                                               __nv_bfloat16* act, int lda) {
  constexpr int WM = nrt_tiled_rows(NP) / 64, WN = 8 / WM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (warp / WN) * 64, col0 = (warp % WN) * 32;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = col0 + ni * 8 + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = row0 + mi * 16 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            nrt_act(acc[mi][ni][2 * half] + b0, ACT),
            nrt_act(acc[mi][ni][2 * half + 1] + b1, ACT));
        *reinterpret_cast<__nv_bfloat162*>(act + (size_t)(row + 8 * half) * lda + col) = v;
      }
    }
  }
}
