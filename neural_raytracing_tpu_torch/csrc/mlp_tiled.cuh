// Register-tiled device SDF of the sphere-trace march K2 (fused_march.cu)
// and the silhouette min-scan K3 (fused_minscan.cu): the sphere set's
// smooth-min (sphere_set.cuh), the encoding and the shift net over the
// packed weights that kernels/fused_march.py pack_shift_weights lays out,
// one code path for both kernels (nrt_f32_sdf / nrt_bf16_sdf and the output
// layer nrt_f32_out / nrt_bf16_out).  K1 and K4-K7 keep the device MLP of
// mlp.cuh.
//
// A block evaluates the net on up to M rows at once; a caller with fewer
// live rows (K2's tail) evaluates only the first 32 or M / 2 of them
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
#define NRT_TILED_MAX_SPHERES 1024  // the sphere set the f32 tile's h rows hold
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
// TN = 64 sums.  With TM = 4 the tile covers the rows [0, 64), with TM = 2
// the rows [0, 32) (2 ty + r), every thread still busy.  Activations are
// stored k-major, act[k * LD + row], LD = M + 4.
// Per k a thread loads TM/4 float4 of activations and TN/4 float4 of weights
// from shared memory for 64 FMAs.  W streams through two KC x NP buffers
// with cp.async (NrtStream): chunk c + 1 loads while chunk c is used, one
// barrier each.

// Copies KC rows of W (a packed [K][NP] f32 matrix, row k0 at src) into dst.
template <int NP>
__device__ __forceinline__ void nrt_f32_issue(const float* __restrict__ src, float* dst) {
  for (int p = threadIdx.x; p < NRT_F32_KC * NP / 4; p += blockDim.x)
    nrt_cp_async16(dst + 4 * p, src + 4 * p);
  nrt_cp_async_commit();
}

// acc += the KC k-rows of act at ac (rows of the thread's tile) x the chunk
// wc of W, by fmaf in ascending k.
template <int NP, int TM>
__device__ __forceinline__ void nrt_f32_chunk(float (&acc)[TM][NP / 16], const float* ac,
                                              const float* wc) {
  constexpr int M = nrt_tiled_rows(NP), LD = M + 4, TN = NP / 16;
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
template <int NP, int ACT, int TM = nrt_tiled_rows(NP) / 16>
__device__ __forceinline__ void nrt_f32_store(const float (&acc)[TM][NP / 16],
                                              const float* __restrict__ bias, float* act) {
  constexpr int M = nrt_tiled_rows(NP), LD = M + 4, TN = NP / 16;
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
// chunks (row stride NRT_BF16_WLD) with cp.async, as the f32 tile's W does.

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

// acc += act[:, ka0 .. ka0 + 16 steps) (the warp's rows) x the chunk wc of W^T.
template <int NP, int MI>
__device__ __forceinline__ void nrt_bf16_chunk(float (&acc)[MI][4][4], const __nv_bfloat16* act,
                                               int lda, int ka0, const __nv_bfloat16* wc,
                                               int steps) {
  constexpr int WM = nrt_tiled_rows(NP) / 64, WN = 8 / WM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (warp / WN) * 16 * MI, col0 = (warp % WN) * 32;
#pragma unroll
  for (int ks = 0; ks < NRT_BF16_KC / 16; ++ks) {
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
        const __nv_bfloat16* p = wc + (col0 + ni * 8 + g) * NRT_BF16_WLD + ks * 16 + 2 * t;
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
// hidden layer), as a stream of chunks through two buffers in shared memory:
// chunk i sits in buffer i % 2.  The caller starts it (chunk 0 in flight)
// before the evaluation's points and spheres; before reading chunk i every
// thread waits for it and passes a barrier, after which buffer (i + 1) % 2
// is free and chunk i + 1 goes there, across a layer's end too.  (Four or
// eight chunks in flight made K2 no faster: H100, PERF.md.)
template <int NP, bool BF16>
struct NrtStream {
  const void* src;   // the layer of the next chunk to issue
  int l, K, c, left; // its layer, that layer's K, its chunk there, the layer's chunks left
  int i = 0;         // the buffer of the next chunk to read

  __device__ __forceinline__ void layer(const TiledNet& m) {
    K = nrt_tiled_k(m, l);
    left = BF16 ? (K + NRT_BF16_KC - 1) / NRT_BF16_KC : K / NRT_F32_KC;
    c = 0;
    src = m.w[l];
  }
  template <typename T>
  __device__ __forceinline__ static T* buffer(T* wbuf, int b) {
    return wbuf + (size_t)b * (BF16 ? NP * NRT_BF16_WLD : NRT_F32_KC * NP);
  }
  // Issues the next chunk into buffer b (nothing past the stream's end).
  template <typename T>
  __device__ __forceinline__ void issue(const TiledNet& m, T* wbuf, int b) {
    if (left == 0) return;
    if constexpr (BF16)
      nrt_bf16_issue<NP>(static_cast<const __nv_bfloat16*>(src), K, c, buffer(wbuf, b));
    else
      nrt_f32_issue<NP>(static_cast<const float*>(src) + (size_t)c * NRT_F32_KC * NP,
                        buffer(wbuf, b));
    ++c;
    if (--left == 0 && ++l <= m.L) layer(m);
  }
  // A new evaluation: its first chunk in flight.
  template <typename T>
  __device__ __forceinline__ void start(const TiledNet& m, T* wbuf) {
    l = 0;
    layer(m);
    issue(m, wbuf, i);
  }
  // -> the next chunk to read, once it landed and everyone is done with the
  // one before, whose buffer the chunk after takes.
  template <typename T>
  __device__ __forceinline__ T* next(const TiledNet& m, T* wbuf) {
    nrt_cp_async_wait_all();
    __syncthreads();
    T* chunk = buffer(wbuf, i);
    i ^= 1;
    issue(m, wbuf, i);
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

// f32: the two weight chunks, the activation buffer (k-major) and the
// smooth-min of the M rows; the sphere set and the points borrow the h rows,
// which are dead from an evaluation's output layer until its init layer
// writes them.
template <int NP>
__host__ __device__ inline size_t nrt_f32_sdf_smem(int EP) {
  constexpr int M = nrt_tiled_rows(NP);
  return sizeof(float) * ((size_t)2 * NRT_F32_KC * NP + (size_t)(NP + EP) * (M + 4) + M);
}

template <int NP>
struct NrtF32Tile {
  float* wbuf;   // [2][KC][NP]
  float* act;    // [NP + EP][M + 4]
  float* sm;     // [M]
  float* sph;    // the sphere set, in the h rows
  float* ps;     // [M][3] the points, after it
  __device__ NrtF32Tile(float* smem, const TiledNet& m, int n_spheres)
      : wbuf(smem),
        act(smem + 2 * NRT_F32_KC * NP),
        sm(act + (size_t)(NP + m.EP) * (nrt_tiled_rows(NP) + 4)),
        sph(act),
        ps(act + nrt_sphere_smem_floats(n_spheres)) {}
  // the end of the tile's shared memory
  __device__ void* end() const { return sm + nrt_tiled_rows(NP); }
};

// Zeroes the encoding's padded rows (once per block).
template <int NP>
__device__ __forceinline__ void nrt_f32_sdf_init(const TiledNet& m, const NrtF32Tile<NP>& T) {
  constexpr int LD = nrt_tiled_rows(NP) + 4;
  for (int i = threadIdx.x; i < (m.EP - m.E) * LD; i += blockDim.x)
    T.act[(size_t)(NP + m.E) * LD + i] = 0.f;
}

template <int NP, int TM>
__device__ __forceinline__ void nrt_f32_sdf(const TiledNet& m, const SphereSet& S,
                                            const NrtF32Tile<NP>& T, NrtStream<NP, false>& W) {
  constexpr int M = nrt_tiled_rows(NP), LD = M + 4, ROWS = 16 * TM;
  nrt_sphere_min(T.sph, S.n, S.k, S.stable, T.ps, T.sm, M, ROWS);
  nrt_tiled_encode<ROWS>(m, T.ps, [&](int row, int c, float v) { T.act[(NP + c) * LD + row] = v; });
  // (the first chunk's barrier orders the encoding before its reads)
  float acc[TM][NP / 16];
  for (int l = 0; l <= m.L; ++l) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < NP / 16; ++c) acc[r][c] = 0.f;
    const float* ac = T.act + (size_t)nrt_tiled_kbase(m, l) * LD;
    const int nc = nrt_tiled_k(m, l) / NRT_F32_KC;
    for (int ch = 0; ch < nc; ++ch)
      nrt_f32_chunk<NP, TM>(acc, ac + (size_t)ch * NRT_F32_KC * LD, W.next(m, T.wbuf));
    __syncthreads();  // every thread is done reading act
    nrt_with_act(m.act, [&](auto a) {
      nrt_f32_store<NP, decltype(a)::value, TM>(acc, m.b[l], T.act);
    });
    if (l == 0)   // the skip layers read act(enc)
      for (int i = threadIdx.x; i < m.E * ROWS; i += blockDim.x) {
        float* e = T.act + (size_t)(NP + i / ROWS) * LD + i % ROWS;
        *e = nrt_act(*e, m.act);
      }
  }
  __syncthreads();
}

template <int NP>
__device__ __forceinline__ float nrt_f32_out(const TiledNet& m, const NrtF32Tile<NP>& T,
                                             int row) {
  constexpr int LD = nrt_tiled_rows(NP) + 4;
  float o = 0.f;
  for (int k = 0; k < m.H; ++k) o = fmaf(T.act[k * LD + row], __ldg(m.w_out + k), o);
  return o + __ldg(m.b_out);
}

// bf16: the two weight chunks, the activation buffer (row-major), the sphere
// set, the points and the smooth-min.
template <int NP>
__host__ __device__ inline int nrt_bf16_lda(int EP) { return NP + EP + 8; }

template <int NP>
__host__ __device__ inline size_t nrt_bf16_sdf_smem(int EP, int n_spheres) {
  constexpr int M = nrt_tiled_rows(NP);
  return sizeof(__nv_bfloat16) *
             ((size_t)2 * NP * NRT_BF16_WLD + (size_t)M * nrt_bf16_lda<NP>(EP)) +
         sizeof(float) * ((size_t)nrt_sphere_smem_floats(n_spheres) + 3 * M + M);
}

template <int NP>
struct NrtBf16Tile {
  __nv_bfloat16* wbuf;   // [2][NP][WLD]
  __nv_bfloat16* act;    // [M][lda]
  int lda;
  float* sph;            // the sphere set
  float* ps;             // [M][3]
  float* sm;             // [M]
  __device__ NrtBf16Tile(float* smem, const TiledNet& m, int n_spheres)
      : wbuf(reinterpret_cast<__nv_bfloat16*>(smem)),
        act(wbuf + 2 * NP * NRT_BF16_WLD),
        lda(nrt_bf16_lda<NP>(m.EP)),
        sph(reinterpret_cast<float*>(act + (size_t)nrt_tiled_rows(NP) * lda)),
        ps(sph + nrt_sphere_smem_floats(n_spheres)),
        sm(ps + 3 * nrt_tiled_rows(NP)) {}
  __device__ void* end() const { return sm + nrt_tiled_rows(NP); }
};

// Zeroes the encoding's padded columns and loads the sphere set (once per
// block; the caller synchronises before the first evaluation).
template <int NP>
__device__ __forceinline__ void nrt_bf16_sdf_init(const TiledNet& m, const SphereSet& S,
                                                  const NrtBf16Tile<NP>& T) {
  constexpr int M = nrt_tiled_rows(NP);
  for (int i = threadIdx.x; i < M * (m.EP - m.E); i += blockDim.x)
    T.act[(size_t)(i / (m.EP - m.E)) * T.lda + NP + m.E + i % (m.EP - m.E)] =
        __float2bfloat16(0.f);
  nrt_load_spheres(S, T.sph);
}

// The bf16 operands of the JAX _make_sdf_eval: the rounded encoding, act of
// the rounded encoding on the skip layers, every act(h) rounded, bf16
// weights, float32 sums.  MI as nrt_bf16_chunk: rows [0, 16 MI M / 64).
template <int NP, int MI>
__device__ __forceinline__ void nrt_bf16_sdf(const TiledNet& m, const SphereSet& S,
                                             const NrtBf16Tile<NP>& T, NrtStream<NP, true>& W) {
  constexpr int M = nrt_tiled_rows(NP), ROWS = 16 * MI * (M / 64);
  const int lda = T.lda;
  nrt_sphere_min(T.sph, S.n, S.k, S.stable, T.ps, T.sm, M, ROWS);
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
    for (int ch = 0; ch * NRT_BF16_KC < K; ++ch)
      nrt_bf16_chunk<NP, MI>(acc, T.act, lda, kbase + ch * NRT_BF16_KC, W.next(m, T.wbuf),
                             min(NRT_BF16_KC, K - ch * NRT_BF16_KC) / 16);
    __syncthreads();  // every warp is done reading act
    nrt_with_act(m.act, [&](auto a) {
      nrt_bf16_store<NP, decltype(a)::value, MI>(acc, m.b[l], T.act, lda);
    });
    if (l == 0)   // the skip layers read act of the rounded encoding, rounded
      for (int i = threadIdx.x; i < m.E * ROWS; i += blockDim.x) {
        __nv_bfloat16* e = T.act + (size_t)(i % ROWS) * lda + NP + i / ROWS;
        *e = __float2bfloat16_rn(nrt_act(__bfloat162float(*e), m.act));
      }
  }
  __syncthreads();
}

template <int NP>
__device__ __forceinline__ float nrt_bf16_out(const TiledNet& m, const NrtBf16Tile<NP>& T,
                                              int row) {
  const __nv_bfloat16* h = T.act + (size_t)row * T.lda;
  float o = 0.f;
  for (int k = 0; k < m.H; ++k) o = fmaf(__bfloat162float(h[k]), __ldg(m.w_out + k), o);
  return o + __ldg(m.b_out);
}
