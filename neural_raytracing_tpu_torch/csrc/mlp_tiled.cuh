// Register-tiled device SDF of the sphere-trace march K2 (fused_march.cu)
// and the silhouette min-scan K3 (fused_minscan.cu): the sphere set's
// smooth-min (sphere_set.cuh), the encoding and the shift net over the
// packed weights of kernels/fused_mlp.py tile_layout (fused_mlp_tile.cu's
// pack kernel writes them),
// one code path for K2, K3 and the shadow march K4 (fused_shadow.cu)
// (nrt_f32_sdf / nrt_bf16_sdf and the output layer nrt_f32_out /
// nrt_bf16_out).  The fused MLP forward K1 (fused_mlp_tile.cu) runs the
// same net without the sphere set (nrt_f32_net / nrt_bf16_net) over the
// layout kernels/fused_mlp.py tile_layout gives, with out_size output
// columns; the backward K6/K7 (fused_mlp_bwd_tile.cu) runs its forward on
// nrt_f32_chunk and its gradient chain on the same register tile.  K5, and
// K1 and K6/K7 for a net off the tile, keep the device MLP of mlp.cuh.
//
// A block evaluates the net on up to M rows at once; a caller with fewer
// live rows (K2's and K4's tail) evaluates only the first 32 or M / 2 of them
// (template parameter TM / MI below), and every row's sums are the same
// whichever it takes.  Its activations live in ONE
// shared buffer with a row per "k" of the layers' products: the hidden
// columns h at k in [0, NP), act(enc) (the raw encoding before the init
// layer) at k in [NP, NP + EP).  So a skip layer reads [h, act(enc)] as one
// K = NP + EP product, the init layer the K = EP rows from NP, a plain layer
// the K = NP rows from 0.  A layer's whole output sits in registers until
// every thread has finished reading the buffer, then overwrites the h rows.
//
// Widths: NP = 128 (hidden <= 128, M = 128 rows) or 256 (hidden <= 256,
// M = 64 rows; K1 gives an f32 buffer of 64 rows at NP 128); EP = the
// encoding width 3 + 2 * freqs rounded up to 8 (f32) or 16 (bf16).  Padded
// weight rows and columns and padded biases are zero, so a padded output
// column is act(0), finite, and every later layer meets it with a zero
// weight row: it adds exactly 0.
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
//   out w  [out_size][NP] float32 (bf16 values in the bf16 mode), k
//          contiguous for each output column; out b [out_size].  The
//          march kernels' shift net has out_size 1.
// K of layer l: EP (l = 0, the init layer), NP + EP (hidden layer l - 1 is a
// skip layer), NP otherwise.
#pragma once

#include <stdint.h>

#include "sphere_set.cuh"

#define NRT_TILE_U 4          // samples of one ray per MLP evaluation
#define NRT_TILED_MAX_SPHERES 1024  // the sphere set the f32 tile's h rows hold
#define NRT_F32_KC 8          // k rows of W per f32 chunk
#define NRT_BF16_KC 32        // k per bf16 chunk

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

// ---- f32: an outer-product tile on the CUDA cores ------------------------------
//
// 256 threads as 16 (ty, rows) x 16 (tx, columns); a thread owns TM = M/16
// rows ((r / 4) * 64 + 4 ty + r % 4) by TN = NP/16 columns (tx + 16 c), TM x
// TN = 64 sums.  With TM = 4 the tile covers the rows [0, 64), with TM = 2
// the rows [0, 32) (2 ty + r), every thread still busy.  Activations are
// stored k-major, act[k * LD + row], LD = M + 4 (M a template parameter of
// the buffer's users, nrt_tiled_rows(NP) unless K1 gives its 64).
// Per k a thread loads TM/4 float4 of activations and TN/4 float4 of weights
// from shared memory for 64 FMAs.  W streams through two KC x NP buffers
// with cp.async (NrtStream): chunk c + 1 loads while chunk c is used, one
// barrier each.

// Copies `rows` k-rows of W (a packed [K][NP] f32 matrix, row k0 at src)
// into dst.
template <int NP>
__device__ __forceinline__ void nrt_f32_issue(const float* __restrict__ src, float* dst,
                                              int rows) {
  for (int p = threadIdx.x; p < rows * NP / 4; p += blockDim.x)
    nrt_cp_async16(dst + 4 * p, src + 4 * p);
}

// acc += the KC k-rows of act at ac (rows of the thread's tile) x the chunk
// wc of W, by fmaf in ascending k.
template <int NP, int TM, int M = nrt_tiled_rows(NP)>
__device__ __forceinline__ void nrt_f32_chunk(float (&acc)[TM][NP / 16], const float* ac,
                                              const float* wc) {
  constexpr int LD = M + 4, TN = NP / 16;
  static_assert(TM == 2 || (TM % 4 == 0 && TM <= M / 16), "rows of a thread");
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < NRT_F32_KC; ++kk) {
    float a[TM], w[TN];
    if constexpr (TM == 2) {
      const float2 v = *reinterpret_cast<const float2*>(ac + kk * LD + ty * 2);
      a[0] = v.x; a[1] = v.y;
    } else {
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(ac + kk * LD + q * 64 + ty * 4);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
      }
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
}

// h rows of act = ACT(acc + bias) (the caller has synchronised: nobody
// reads act any more).
template <int NP, int ACT, int TM = nrt_tiled_rows(NP) / 16, int M = nrt_tiled_rows(NP)>
__device__ __forceinline__ void nrt_f32_store(const float (&acc)[TM][NP / 16],
                                              const float* __restrict__ bias, float* act) {
  constexpr int LD = M + 4, TN = NP / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int j = tx + 16 * c;
    const float bj = __ldg(bias + j);
    if constexpr (TM == 2) {
      float2 v;
      v.x = nrt_act(acc[0][c] + bj, ACT);
      v.y = nrt_act(acc[1][c] + bj, ACT);
      *reinterpret_cast<float2*>(act + j * LD + ty * 2) = v;
    }
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
// as (M / 64) x (NP / 32 / (M / 64)); a warp owns 16 MI rows x 32 columns,
// MI x 4 m16n8 tiles, 16 MI float32 sums a thread: MI = 4 covers the M rows,
// MI = 2 and 1 the first M / 2 and M / 4.  W^T streams through two NP x 32
// chunks (row stride nrt_bf16_wld(32)) with cp.async, as the f32 tile's W does.

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

// The row stride of a staged W^T chunk of KC k (KC + 8 bf16: a word stride
// of 4 mod 8, so the fragment loads are conflict-free).
__host__ __device__ constexpr int nrt_bf16_wld(int KC) { return KC + 8; }

// Copies chunk ch (k in [KC ch, KC ch + kc)) of W^T ([NP][K] bf16) into dst.
template <int NP, int KC>
__device__ __forceinline__ void nrt_bf16_issue(const __nv_bfloat16* __restrict__ W, int K,
                                               int ch, __nv_bfloat16* dst) {
  const int k0 = ch * KC;
  const int per_row = min(KC, K - k0) / 8;   // 16-byte pieces
  for (int p = threadIdx.x; p < NP * per_row; p += blockDim.x) {
    const int n = p / per_row, piece = p % per_row;
    nrt_cp_async16(dst + n * nrt_bf16_wld(KC) + 8 * piece, W + (size_t)n * K + k0 + 8 * piece);
  }
}

// acc += act[:, ka0 .. ka0 + 16 steps) (the warp's rows) x the chunk wc of W^T.
template <int NP, int MI, int KC = NRT_BF16_KC>
__device__ __forceinline__ void nrt_bf16_chunk(float (&acc)[MI][4][4], const __nv_bfloat16* act,
                                               int lda, int ka0, const __nv_bfloat16* wc,
                                               int steps) {
  constexpr int WM = nrt_tiled_rows(NP) / 64, WN = 8 / WM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (warp / WN) * 16 * MI, col0 = (warp % WN) * 32;
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    if (ks < steps) {
      const int ka = ka0 + ks * 16 + 2 * t;
      uint32_t a[MI][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const __nv_bfloat16* p = act + (size_t)(row0 + mi * 16 + g) * lda + ka;
        a[mi][0] = nrt_ld32(p);
        a[mi][1] = nrt_ld32(p + 8 * lda);
        a[mi][2] = nrt_ld32(p + 8);
        a[mi][3] = nrt_ld32(p + 8 * lda + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p = wc + (col0 + ni * 8 + g) * nrt_bf16_wld(KC) + ks * 16 + 2 * t;
        b[ni][0] = nrt_ld32(p);
        b[ni][1] = nrt_ld32(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) nrt_mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
}

// h columns of act = bf16(ACT(acc + bias)), from the accumulator fragments.
template <int NP, int ACT, int MI = 4>
__device__ __forceinline__ void nrt_bf16_store(const float (&acc)[MI][4][4],
                                               const float* __restrict__ bias,
                                               __nv_bfloat16* act, int lda) {
  constexpr int WM = nrt_tiled_rows(NP) / 64, WN = 8 / WM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (warp / WN) * 16 * MI, col0 = (warp % WN) * 32;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = col0 + ni * 8 + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
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

// ---- the weight stream ------------------------------------------------------------
//
// One evaluation's weights, layer after layer (the init layer, then each
// hidden layer), as a stream of chunks of KC k-rows (the last of a layer
// may be shorter) through STAGES buffers in shared memory: chunk i sits in
// buffer i % STAGES.  The caller starts it (chunks 0 .. STAGES - 2 in
// flight) before the evaluation's points and spheres; before reading chunk
// i every thread waits for it and passes a barrier, after which the buffer
// of chunk i - 1 is free and chunk i + STAGES - 1 goes there, across a
// layer's end too.  K2 and K3 take 2 buffers of 8 k-rows (f32) or 32 k
// (bf16); K4 three of 32 k-rows (f32) or 64 k (bf16).
template <int NP, bool BF16, int KC_ = (BF16 ? NRT_BF16_KC : NRT_F32_KC), int STAGES = 2>
struct NrtStream {
  static constexpr int KC = KC_;
  // elements (floats, or bf16 with BF16) of one buffer and of the ring
  static constexpr int BUF = BF16 ? NP * nrt_bf16_wld(KC) : KC * NP;
  static constexpr int RING = STAGES * BUF;
  static_assert(KC % (BF16 ? 16 : 8) == 0 && STAGES >= 2, "stream shape");

  const void* src;   // the layer of the next chunk to issue
  int l, K, c, left; // its layer, that layer's K, its chunk there, the layer's chunks left
  unsigned i = 0;    // the chunk to read next

  __device__ __forceinline__ void layer(const TiledNet& m) {
    K = nrt_tiled_k(m, l);
    left = (K + KC - 1) / KC;
    c = 0;
    src = m.w[l];
  }
  template <typename T>
  __device__ __forceinline__ static T* buffer(T* wbuf, unsigned b) {
    return wbuf + (size_t)(b % STAGES) * BUF;
  }
  // Issues the next chunk into buffer b and commits it (an empty group past
  // the stream's end).
  template <typename T>
  __device__ __forceinline__ void issue(const TiledNet& m, T* wbuf, unsigned b) {
    if (left > 0) {
      if constexpr (BF16)
        nrt_bf16_issue<NP, KC>(static_cast<const __nv_bfloat16*>(src), K, c, buffer(wbuf, b));
      else
        nrt_f32_issue<NP>(static_cast<const float*>(src) + (size_t)c * KC * NP,
                          buffer(wbuf, b), KC == NRT_F32_KC ? KC : min(KC, K - c * KC));
      ++c;
      if (--left == 0 && ++l <= m.L) layer(m);
    }
    nrt_cp_async_commit();
  }
  // A new evaluation: its first STAGES - 1 chunks in flight (every buffer
  // is free: the caller synchronised after the last evaluation's reads).
  template <typename T>
  __device__ __forceinline__ void start(const TiledNet& m, T* wbuf) {
    l = 0;
    layer(m);
    i = 0;
#pragma unroll
    for (unsigned s = 0; s < STAGES - 1; ++s) issue(m, wbuf, s);
  }
  // -> the next chunk to read, once it landed and everyone is done with the
  // one before, whose buffer the chunk STAGES - 1 ahead takes.
  template <typename T>
  __device__ __forceinline__ T* next(const TiledNet& m, T* wbuf) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    T* chunk = buffer(wbuf, i);
    issue(m, wbuf, i + STAGES - 1);
    ++i;
    return chunk;
  }
};

// ---- the SDF on the tile: one code path for K2 and K3 -------------------------------
//
// The caller starts the weight stream (NrtStream::start), puts the points of
// rows [0, ROWS) in ps (and, in f32, loads the sphere set into sph) and
// synchronises; nrt_*_sdf then writes the spheres' smooth-min of those rows
// to sm and runs the encoding and the shift net's hidden layers, and ends
// with a barrier, after which nrt_*_out(row) gives the shift of a row (the
// output layer on the CUDA cores, fmaf in ascending k, then the bias).  So
// sd = sm[row] + out(row), the same sums whichever rows or tile variant
// evaluate a point.

// The encoding [x, sin(x B), cos(x B)] of rows [0, ROWS) of the points ps
// ([.][3]), value c of row at put(row, c, v) (x B by fmaf in ascending d,
// as the first kernels did).
template <int ROWS, typename Put>
__device__ __forceinline__ void nrt_tiled_encode(const TiledNet& m, const float* ps, Put put) {
  const int F = m.F;
  for (int idx = threadIdx.x; idx < ROWS * (3 + F); idx += blockDim.x) {
    const int row = idx % ROWS, c = idx / ROWS;
    const float* x = ps + row * 3;
    if (c < 3) {
      put(row, c, x[c]);
    } else {
      const int f = c - 3;
      float mapped = 0.f;
      for (int d = 0; d < 3; ++d) mapped = fmaf(x[d], __ldg(m.B + d * F + f), mapped);
      put(row, 3 + f, sinf(mapped));
      put(row, 3 + F + f, cosf(mapped));
    }
  }
}

// The spheres' smooth-min of rows [0, ROWS) of the tile's M: with TPR = 0
// blockDim.x / M lanes a row (K2 and K3: a row's order whatever ROWS), else
// TPR lanes a row over all the threads (K4: more threads in a thin step,
// one order whatever ROWS).
template <int M, int ROWS, int TPR>
__device__ __forceinline__ void nrt_tiled_sphere_min(const SphereSet& S, const float* sph,
                                                     const float* ps, float* sm) {
  if constexpr (TPR == 0)
    nrt_sphere_min(sph, S.n, S.k, S.stable, ps, sm, M, ROWS);
  else
    nrt_sphere_min_lanes<TPR>(sph, S.n, S.k, S.stable, ps, sm, ROWS);
}

// f32: the weight stream's buffers, the activation buffer (k-major) and the
// smooth-min of the M rows; the sphere set and the points borrow the h rows,
// which are dead from an evaluation's output layer until its init layer
// writes them.
// RING: the floats of the weight stream's buffers (NrtStream::RING).
template <int NP, int RING = 2 * NRT_F32_KC * NP, int M = nrt_tiled_rows(NP)>
__host__ __device__ inline size_t nrt_f32_sdf_smem(int EP) {
  return sizeof(float) * ((size_t)RING + (size_t)(NP + EP) * (M + 4) + M);
}

template <int NP, int RING = 2 * NRT_F32_KC * NP, int M = nrt_tiled_rows(NP)>
struct NrtF32Tile {
  static constexpr int kNP = NP, kM = M;   // kM: its rows (K1's 64 at NP 128)
  float* wbuf;   // [RING] the stream's buffers
  float* act;    // [NP + EP][M + 4]
  float* sm;     // [M]
  float* sph;    // the sphere set, in the h rows
  float* ps;     // [M][3] the points, after it
  __device__ NrtF32Tile(float* smem, const TiledNet& m, int n_spheres)
      : wbuf(smem),
        act(smem + RING),
        sm(act + (size_t)(NP + m.EP) * (M + 4)),
        sph(act),
        ps(act + nrt_sphere_smem_floats(n_spheres)) {}
  // the end of the tile's shared memory
  __device__ void* end() const { return sm + M; }
};

// Zeroes the encoding's padded rows (once per block; nrt_f32_net's first
// barrier orders it before their reads).
template <typename Tile>
__device__ __forceinline__ void nrt_f32_sdf_init(const TiledNet& m, const Tile& T) {
  constexpr int NP = Tile::kNP;
  constexpr int LD = Tile::kM + 4;
  for (int i = threadIdx.x; i < (m.EP - m.E) * LD; i += blockDim.x)
    T.act[(size_t)(NP + m.E) * LD + i] = 0.f;
}

// The outputs a thread of the f32 tile owns in a layer: MAP::R rows x MAP::C
// columns of the MAP::ROWS rows evaluated, with MAP::chunk (acc += 8 k-rows
// of act x W) and MAP::store (the epilogue).  Each output's sum is the same
// fmaf in ascending k in every map.
template <int NP, int TM, int M = nrt_tiled_rows(NP)>
struct NrtF32Wide {   // the 16 x 16 thread layout above: rows [0, 16 TM) of a tile of M
  static constexpr int ROWS = 16 * TM, R = TM, C = NP / 16;
  __device__ __forceinline__ static void chunk(float (&acc)[R][C], const float* ac,
                                               const float* wc) {
    nrt_f32_chunk<NP, TM, M>(acc, ac, wc);
  }
  template <int ACT>
  __device__ __forceinline__ static void store(const float (&acc)[R][C],
                                               const float* __restrict__ bias, float* act) {
    nrt_f32_store<NP, ACT, TM, M>(acc, bias, act);
  }
};

// A thin step of ROWS = 32, 16 or 8 rows (K4's tail) with every warp on its
// own columns, so a block reads each weight from shared memory once (the 16
// x 16 layout reads it once a warp): 8 warps at 32 rows, 4 at 16 and 8
// (on an H100 faster than 2 or 8 there), each own 4 rows x CPT columns a
// thread, thread t the rows 4 (t % (ROWS / 4)) .. + 3 and the physical
// columns [CPT c, CPT c + CPT), c = t / (ROWS / 4), of the packed matrix
// (the logical columns nrt_tiled_col(p)); the other threads only pass the
// barriers.  Per k a thread loads one float4 of activations and CPT weights
// for 4 CPT FMAs.  (Loading a thread's operands of 8 k-rows before their
// products made no difference on an H100.)
template <int NP, int ROWS_>
struct NrtF32Thin {
  static constexpr int ROWS = ROWS_, RQ = ROWS / 4, LD = nrt_tiled_rows(NP) + 4;
  static constexpr int WARPS = ROWS == 32 ? 8 : 4;
  static constexpr int CPT0 = RQ * NP / (32 * WARPS);   // columns a thread at WARPS
  static constexpr int CPT = CPT0 < 1 ? 1 : (CPT0 > NP / 32 ? NP / 32 : CPT0);
  static constexpr int THREADS = RQ * (NP / CPT), R = 4, C = CPT;
  static_assert(ROWS == 32 || ROWS == 16 || ROWS == 8, "thin rows");
  static_assert(THREADS <= NRT_THREADS && (CPT == 1 || CPT == 2 || CPT % 4 == 0), "thin map");
  __device__ __forceinline__ static int row0() { return 4 * (threadIdx.x % RQ); }
  __device__ __forceinline__ static int col0() { return CPT * (threadIdx.x / RQ); }
  // the CPT weights of k-row kk at the thread's columns
  __device__ __forceinline__ static void weights(const float* wk, float (&w)[CPT]) {
    if constexpr (CPT == 1) {
      w[0] = wk[0];
    } else if constexpr (CPT == 2) {
      const float2 v = *reinterpret_cast<const float2*>(wk);
      w[0] = v.x; w[1] = v.y;
    } else {
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(wk + 4 * q);
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ static void chunk(float (&acc)[R][C], const float* ac,
                                               const float* wc) {
    if (threadIdx.x >= THREADS) return;
    const int r0 = row0(), c0 = col0();
#pragma unroll
    for (int kk = 0; kk < NRT_F32_KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(ac + kk * LD + r0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float w[CPT];
      weights(wc + kk * NP + c0, w);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(av[r], w[c], acc[r][c]);
    }
  }
  template <int ACT>
  __device__ __forceinline__ static void store(const float (&acc)[R][C],
                                               const float* __restrict__ bias, float* act) {
    if (threadIdx.x >= THREADS) return;
    const int r0 = row0(), c0 = col0();
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = nrt_tiled_col(c0 + c);
      const float bj = __ldg(bias + j);
      float4 v;
      v.x = nrt_act(acc[0][c] + bj, ACT);
      v.y = nrt_act(acc[1][c] + bj, ACT);
      v.z = nrt_act(acc[2][c] + bj, ACT);
      v.w = nrt_act(acc[3][c] + bj, ACT);
      *reinterpret_cast<float4*>(act + j * LD + r0) = v;
    }
  }
};

// The net on rows [0, MAP::ROWS) of the points T.ps: the encoding, then
// every layer but the output layer, ending with a barrier.  MAP:
// NrtF32Wide<NP, TM> (rows [0, 16 TM)) or NrtF32Thin<NP, ROWS>.
template <int NP, typename MAP, typename Tile, typename Stream>
__device__ __forceinline__ void nrt_f32_net(const TiledNet& m, const Tile& T, Stream& W) {
  constexpr int LD = Tile::kM + 4, ROWS = MAP::ROWS, KC = Stream::KC;
  nrt_tiled_encode<ROWS>(m, T.ps, [&](int row, int c, float v) { T.act[(NP + c) * LD + row] = v; });
  // (the first chunk's barrier orders the encoding before its reads)
  float acc[MAP::R][MAP::C];
  for (int l = 0; l <= m.L; ++l) {
#pragma unroll
    for (int r = 0; r < MAP::R; ++r)
#pragma unroll
      for (int c = 0; c < MAP::C; ++c) acc[r][c] = 0.f;
    const float* ac = T.act + (size_t)nrt_tiled_kbase(m, l) * LD;
    const int K = nrt_tiled_k(m, l);
    for (int k0 = 0; k0 < K; k0 += KC) {
      const float* wc = W.next(m, T.wbuf);
      if constexpr (KC == NRT_F32_KC) {
        MAP::chunk(acc, ac + (size_t)k0 * LD, wc);
      } else {   // the same sums, 8 k-rows at a time
        const int kc = min(KC, K - k0);
        for (int s = 0; s < kc; s += NRT_F32_KC)
          MAP::chunk(acc, ac + (size_t)(k0 + s) * LD, wc + s * NP);
      }
    }
    __syncthreads();  // every thread is done reading act
    nrt_with_act(m.act, [&](auto a) {
      MAP::template store<decltype(a)::value>(acc, m.b[l], T.act);
    });
    if (l == 0)   // the skip layers read act(enc)
      for (int i = threadIdx.x; i < m.E * ROWS; i += blockDim.x) {
        float* e = T.act + (size_t)(NP + i / ROWS) * LD + i % ROWS;
        *e = nrt_act(*e, m.act);
      }
  }
  __syncthreads();
}

// The SDF: the spheres' smooth-min of the rows, then the net.
template <int NP, int TM, int TPR = 0, typename MAP = NrtF32Wide<NP, TM>, typename Tile,
          typename Stream>
__device__ __forceinline__ void nrt_f32_sdf(const TiledNet& m, const SphereSet& S,
                                            const Tile& T, Stream& W) {
  nrt_tiled_sphere_min<nrt_tiled_rows(NP), MAP::ROWS, TPR>(S, T.sph, T.ps, T.sm);
  nrt_f32_net<NP, MAP>(m, T, W);
}

// Output column j of a row: fmaf in ascending k, then the bias.
template <typename Tile>
__device__ __forceinline__ float nrt_f32_out(const TiledNet& m, const Tile& T, int row,
                                             int j = 0) {
  constexpr int NP = Tile::kNP;
  constexpr int LD = Tile::kM + 4;
  const float* w = m.w_out + (size_t)j * NP;
  float o = 0.f;
  for (int k = 0; k < m.H; ++k) o = fmaf(T.act[k * LD + row], __ldg(w + k), o);
  return o + __ldg(m.b_out + j);
}

// bf16: the weight stream's buffers, the activation buffer (row-major), the sphere
// set, the points and the smooth-min.
template <int NP>
__host__ __device__ inline int nrt_bf16_lda(int EP) { return NP + EP + 8; }

// RING: the bf16 elements of the weight stream's buffers (NrtStream::RING).
template <int NP, int RING = 2 * NP * nrt_bf16_wld(NRT_BF16_KC)>
__host__ __device__ inline size_t nrt_bf16_sdf_smem(int EP, int n_spheres) {
  constexpr int M = nrt_tiled_rows(NP);
  return sizeof(__nv_bfloat16) * ((size_t)RING + (size_t)M * nrt_bf16_lda<NP>(EP)) +
         sizeof(float) * ((size_t)nrt_sphere_smem_floats(n_spheres) + 3 * M + M);
}

template <int NP, int RING = 2 * NP * nrt_bf16_wld(NRT_BF16_KC)>
struct NrtBf16Tile {
  static constexpr int kNP = NP;
  __nv_bfloat16* wbuf;   // [RING] the stream's buffers
  __nv_bfloat16* act;    // [M][lda]
  int lda;
  float* sph;            // the sphere set
  float* ps;             // [M][3]
  float* sm;             // [M]
  __device__ NrtBf16Tile(float* smem, const TiledNet& m, int n_spheres)
      : wbuf(reinterpret_cast<__nv_bfloat16*>(smem)),
        act(wbuf + RING),
        lda(nrt_bf16_lda<NP>(m.EP)),
        sph(reinterpret_cast<float*>(act + (size_t)nrt_tiled_rows(NP) * lda)),
        ps(sph + nrt_sphere_smem_floats(n_spheres)),
        sm(ps + 3 * nrt_tiled_rows(NP)) {}
  __device__ void* end() const { return sm + nrt_tiled_rows(NP); }
};

// Zeroes the encoding's padded columns (once per block; the caller
// synchronises before the first evaluation).
template <typename Tile>
__device__ __forceinline__ void nrt_bf16_pad_init(const TiledNet& m, const Tile& T) {
  constexpr int NP = Tile::kNP;
  constexpr int M = nrt_tiled_rows(NP);
  for (int i = threadIdx.x; i < M * (m.EP - m.E); i += blockDim.x)
    T.act[(size_t)(i / (m.EP - m.E)) * T.lda + NP + m.E + i % (m.EP - m.E)] =
        __float2bfloat16(0.f);
}

// ... and loads the sphere set.
template <typename Tile>
__device__ __forceinline__ void nrt_bf16_sdf_init(const TiledNet& m, const SphereSet& S,
                                                  const Tile& T) {
  nrt_bf16_pad_init(m, T);
  nrt_load_spheres(S, T.sph);
}

// The net on rows [0, ROWS) of the points T.ps with bf16 operands: the
// encoding rounded, every act(h) rounded, bf16 weights, float32 sums; the
// skip layers read the columns skip_operand() writes over the rounded
// encoding after the init layer (the march's act of the rounded encoding,
// or K1's act of the float32 one).  Ends with a barrier.  MI as
// nrt_bf16_chunk: rows [0, 16 MI M / 64).
template <int NP, int MI, typename Tile, typename Stream, typename SkipOperand>
__device__ __forceinline__ void nrt_bf16_net(const TiledNet& m, const Tile& T, Stream& W,
                                             SkipOperand skip_operand) {
  constexpr int M = nrt_tiled_rows(NP), ROWS = 16 * MI * (M / 64), KC = Stream::KC;
  const int lda = T.lda;
  // the encoding rounded to bf16
  nrt_tiled_encode<ROWS>(m, T.ps, [&](int row, int c, float v) {
    T.act[(size_t)row * lda + NP + c] = __float2bfloat16_rn(v);
  });
  float acc[MI][4][4];
  for (int l = 0; l <= m.L; ++l) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    const int K = nrt_tiled_k(m, l), kbase = nrt_tiled_kbase(m, l);
    for (int ch = 0; ch * KC < K; ++ch)
      nrt_bf16_chunk<NP, MI, KC>(acc, T.act, lda, kbase + ch * KC, W.next(m, T.wbuf),
                                 min(KC, K - ch * KC) / 16);
    __syncthreads();  // every warp is done reading act
    nrt_with_act(m.act, [&](auto a) {
      nrt_bf16_store<NP, decltype(a)::value, MI>(acc, m.b[l], T.act, lda);
    });
    if (l == 0) skip_operand();
  }
  __syncthreads();
}

// The SDF of the JAX _make_sdf_eval: the spheres' smooth-min, then the net
// with the skip layers reading act of the rounded encoding, rounded.
template <int NP, int MI, int TPR = 0, typename Tile, typename Stream>
__device__ __forceinline__ void nrt_bf16_sdf(const TiledNet& m, const SphereSet& S,
                                             const Tile& T, Stream& W) {
  constexpr int M = nrt_tiled_rows(NP), ROWS = 16 * MI * (M / 64);
  nrt_tiled_sphere_min<M, ROWS, TPR>(S, T.sph, T.ps, T.sm);
  nrt_bf16_net<NP, MI>(m, T, W, [&] {
    for (int i = threadIdx.x; i < m.E * ROWS; i += blockDim.x) {
      __nv_bfloat16* e = T.act + (size_t)(i % ROWS) * T.lda + NP + i / ROWS;
      *e = __float2bfloat16_rn(nrt_act(__bfloat162float(*e), m.act));
    }
  });
}

// Output column j of a row: fmaf in ascending k, then the bias.
template <typename Tile>
__device__ __forceinline__ float nrt_bf16_out(const TiledNet& m, const Tile& T, int row,
                                              int j = 0) {
  const __nv_bfloat16* h = T.act + (size_t)row * T.lda;
  const float* w = m.w_out + (size_t)j * Tile::kNP;
  float o = 0.f;
  for (int k = 0; k < m.H; ++k) o = fmaf(__bfloat162float(h[k]), __ldg(w + k), o);
  return o + __ldg(m.b_out + j);
}
