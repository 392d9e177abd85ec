// K6 and K7 on the f32 register tile of mlp_tiled.cuh: the fused
// SkipConnMLP backward, monolithic (K6) and checkpointed (K7a, K7b), of a
// net on K1's tile (in_size 3, hidden <= 256, freqs <= 128, <= 32 layers).
//
// Replaces the TPU kernels of neural_raytracing_tpu/kernels/fused_mlp.py:
//   K6  _pallas_backward (:235, body _build_bwd_kernel :140)
//   K7a _pallas_backward_segmented, checkpoint call (:449, _build_ckpt_kernel)
//   K7b the same function, segment call (:476, _build_seg_bwd_kernel)
// A net off the tile keeps the kernels of fused_mlp_bwd.cu over mlp.cuh
// (kernels/fused_mlp.py routes by shape, k1_route).  The math is the one
// written at the top of fused_mlp_bwd.cu; dB = 0.
//
// Bound on an H100: f32 FMA issue (IEEE f32, no TF32) over three products
// of the forward's MACs a row: the recompute, the gradient chain and dW.
// fused_mlp_bwd.cu ran them on 32- and 16-row blocks over mlp.cuh's device
// MLP (a scalar weight load for 8 FMAs) and a 64 x 64 dW tile with one
// atomicAdd per output and row slice.  Here four kernels a call, each on
// a register tile:
//   1. nrt_bwd_store_fwd_kernel: K1's f32 forward (nrt_f32_chunk over K1's
//      packed weights, 64 rows a block, the same sums and bits) that writes
//      the pre-activations a call asks for (every hs[k] for K6, the segment
//      boundaries for K7a, a segment's inner layers for K7b) from the
//      accumulators before the activation, and the raw encoding; it starts
//      from x, or from h_in = hs[l0] (K7b's recompute);
//   2. nrt_bwd_chain_kernel: a block carries gH of its 64 rows through the
//      layers, deepest first, in a k-major buffer like the forward's
//      activations.  ga = gH[k+1] W^T is the tile's outer-product product
//      over the TRANSPOSED pack, K = NP: the h columns as one [NP][NP]
//      matrix, a skip layer's act(enc) columns as a second [NP][EPT] one
//      summed into genc_act in shared memory; the epilogue multiplies by
//      act'(hs[k]) (float4 loads) and writes gH[k].  K6 adds the out layer
//      on top and the init layer with the Fourier dx epilogue at the bottom;
//      K7b writes genc_act.  The matrices stream through shared memory
//      (cp.async, two buffers of 32 k-rows of an h matrix at NP 256, 16
//      otherwise), across matrix ends; the epilogue's hs[k] values are
//      loaded into registers before the product, so their latency hides
//      behind it;
//   3. nrt_dw_kernel: every dW = A^T G of a call in one grouped launch:
//      128 x 128 output tiles, 8 x 8 a thread, 32-row chunks copied by
//      cp.async (a float a copy: the encoding's rows are 3 + 2 F wide)
//      into two shared buffers, the activation applied by the thread that
//      copied a value, db from the copied G; the rows split into the fixed
//      number of slices kernels/fused_mlp.py dw_plan gives (a function of
//      n and the widths), each slice's sums to its own workspace;
//   4. nrt_dw_reduce_kernel: the slices summed in slice order.
// No atomics: the same inputs give the same dW bits from run to run, as
// the TPU kernel's grid, run in order, does.
//
// The transposed pack (nrt_mlp_tile_pack_transposes, one launch, cached
// beside the module as K1's pack is): the table [W0T, h_0, e_0, ..., h_{L-1},
// e_{L-1}], e_i null on a plain layer; W0T [NP][EPT] (row j, column e =
// init w[e][j]), h_i [NP][NP] (row j, column c = w[c][j]), e_i [NP][EPT]
// (row j, column e = w[hidden + e][j]); zero past hidden and the encoding.
// EPT = the encoding width rounded up to 64, the thread map's float4 groups.
// The chain's thread map keeps a thread's columns in groups of 4
// contiguous ones (64 q + 4 tx + i), so its matrices are not permuted.
//
// C interface for ctypes: each entry point returns a cudaError_t as int.
#include <stdint.h>

#include "mlp_tiled.cuh"

#define NRT_BWD_M 64                     // rows a block (K1's)
#define NRT_BWD_LD (NRT_BWD_M + 4)       // row stride of the k-major buffers
// k-rows a chunk of the chain's stream: of an h matrix ([NP][NP]; at NP 256
// as K1's forward streams), of an encoding matrix ([NP][EPT])
#define NRT_BWD_KC_H(NP) ((NP) == 256 ? 32 : 16)
#define NRT_BWD_KC_E 16
#define NRT_BWD_FWD_KC(NP) ((NP) == 256 ? 32 : NRT_F32_KC)   // K1's weight stream
#define NRT_BWD_MAX_STEPS (2 * NRT_MAX_LAYERS + 1)
#define NRT_DW_T 128                     // dW output tile
#define NRT_DW_R 32                      // rows a dW chunk
#define NRT_DW_SMEM (2 * 2 * NRT_DW_R * NRT_DW_T * sizeof(float))   // its two buffers of A and G

struct NrtRowPtrs {   // one [n][hidden] buffer per hs / gH index 0..L (nullptr: none)
  float* p[NRT_MAX_LAYERS + 1];
};

// ---- 1. the forward that stores pre-activations ------------------------------

// K1's f32 store (nrt_f32_store at 64 rows) that also writes acc + bias of
// the rows below n and the columns below H to hs (when given).
template <int NP, int ACT>
__device__ __forceinline__ void nrt_bwd_fwd_store(const float (&acc)[4][NP / 16],
                                                  const float* __restrict__ bias, float* act,
                                                  float* __restrict__ hs, int row0, int n, int H) {
  constexpr int LD = NRT_BWD_LD, TN = NP / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int j = tx + 16 * c;
    const float bj = __ldg(bias + j);
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = acc[r][c] + bj;
    if (hs != nullptr && j < H)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (row0 + 4 * ty + r < n) hs[(size_t)(row0 + 4 * ty + r) * H + j] = v[r];
    float4 o;
    o.x = nrt_act(v[0], ACT);
    o.y = nrt_act(v[1], ACT);
    o.z = nrt_act(v[2], ACT);
    o.w = nrt_act(v[3], ACT);
    *reinterpret_cast<float4*>(act + j * LD + ty * 4) = o;
  }
}

// Layers l_first..l_last (0 = init, 1 + i = hidden layer i) of the rows
// [64 b, 64 b + 64): from x (h_in null, l_first 0) or from h_in = hs[l_first - 1]
// ([n][H]); layer l writes hs[l] where hs.p[l] is given; enc_out (optional)
// gets the raw encoding [n][E].
template <int NP, int KC>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_bwd_store_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h_in,
                         int l_first, int l_last, int n, const __grid_constant__ TiledNet m,
                         const __grid_constant__ NrtRowPtrs hs, float* __restrict__ enc_out) {
  constexpr int M = NRT_BWD_M, LD = NRT_BWD_LD, TN = NP / 16;
  extern __shared__ __align__(16) float smem[];
  typedef NrtStream<NP, false, KC> Stream;
  const NrtF32Tile<NP, Stream::RING, M> T(smem, m, 0);   // the points in the h rows
  Stream W;
  const int row0 = blockIdx.x * M;
  W.l = l_first;   // Stream::start from layer l_first
  W.layer(m);
  W.i = 0;
  W.issue(m, T.wbuf, 0);
  nrt_f32_sdf_init(m, T);
  for (int i = threadIdx.x; i < M * 3; i += blockDim.x)
    T.ps[i] = row0 + i / 3 < n ? x[(size_t)row0 * 3 + i] : 0.f;
  __syncthreads();
  nrt_tiled_encode<M>(m, T.ps, [&](int row, int c, float v) {
    T.act[(size_t)(NP + c) * LD + row] = v;
    if (enc_out != nullptr && row0 + row < n) enc_out[(size_t)(row0 + row) * m.E + c] = v;
  });
  if (h_in != nullptr) {
    __syncthreads();   // the points are read: the h rows take act(h_in)
    for (int i = threadIdx.x; i < M * NP; i += blockDim.x) {
      const int row = i / NP, j = i % NP;
      const float h = row0 + row < n && j < m.H ? h_in[(size_t)(row0 + row) * m.H + j] : 0.f;
      T.act[(size_t)j * LD + row] = nrt_act(h, m.act);
    }
    for (int i = threadIdx.x; i < m.E * M; i += blockDim.x) {   // the skip layers read act(enc)
      float* e = T.act + (size_t)(NP + i / M) * LD + i % M;
      *e = nrt_act(*e, m.act);
    }
  }
  // (the first chunk's barrier orders all of this before its reads)
  float acc[4][TN];
  for (int l = l_first; l <= l_last; ++l) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
    const float* ac = T.act + (size_t)nrt_tiled_kbase(m, l) * LD;
    const int K = nrt_tiled_k(m, l);
    for (int k0 = 0; k0 < K; k0 += KC) {
      const float* wc = W.next(m, T.wbuf);
      if constexpr (KC == NRT_F32_KC) {
        nrt_f32_chunk<NP, 4, M>(acc, ac + (size_t)k0 * LD, wc);
      } else {   // the same sums, 8 k-rows at a time
        const int kc = min(KC, K - k0);
        for (int s = 0; s < kc; s += NRT_F32_KC)
          nrt_f32_chunk<NP, 4, M>(acc, ac + (size_t)(k0 + s) * LD, wc + s * NP);
      }
    }
    __syncthreads();  // every thread is done reading act
    nrt_with_act(m.act, [&](auto a) {
      nrt_bwd_fwd_store<NP, decltype(a)::value>(acc, m.b[l], T.act, hs.p[l], row0, n, m.H);
    });
    if (l == 0)   // the skip layers read act(enc)
      for (int i = threadIdx.x; i < m.E * M; i += blockDim.x) {
        float* e = T.act + (size_t)(NP + i / M) * LD + i % M;
        *e = nrt_act(*e, m.act);
      }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");   // chunks past l_last
}

// ---- 2. the gradient chain ------------------------------------------------------

// The chain's view of a net: B and W_out^T from K1's pack, and the matrices
// of the transposed pack in the order the chain reads them (its steps).
struct NrtChainNet {
  const float* B;       // [3][F]
  const float* w_out;   // [O][NP], W_out^T (K1's pack)
  const float* step_w[NRT_BWD_MAX_STEPS];
  int step_width[NRT_BWD_MAX_STEPS];
  int step_kc[NRT_BWD_MAX_STEPS];   // k-rows a chunk of the step
  int steps;
  int F, H, L, skip, act, E, O;
};

// The steps' matrices ([NP][width], chunks of kc k-rows = kc width floats)
// through two shared buffers with cp.async, across a step's end: before
// reading chunk i every thread waits for it and passes a barrier, after
// which the buffer of chunk i - 1 takes chunk i + 1.
template <int NP>
struct NrtChainStream {
  int s, c;     // the next chunk to issue: chunk c of step s
  unsigned i;   // the chunk to read next
  int buf;      // floats a buffer
  __device__ __forceinline__ void issue(const NrtChainNet& t, float* ring, unsigned b) {
    if (s < t.steps) {
      const int w = t.step_width[s], kc = t.step_kc[s];
      const float* src = t.step_w[s] + (size_t)c * kc * w;
      float* dst = ring + (size_t)(b & 1) * buf;
      for (int p = threadIdx.x; p < kc * w / 4; p += blockDim.x)
        nrt_cp_async16(dst + 4 * p, src + 4 * p);
      if (++c == NP / kc) {
        c = 0;
        ++s;
      }
    }
    nrt_cp_async_commit();
  }
  __device__ __forceinline__ void start(const NrtChainNet& t, float* ring, int buf_floats) {
    s = c = 0;
    i = 0;
    buf = buf_floats;
    issue(t, ring, 0);
  }
  __device__ __forceinline__ const float* next(const NrtChainNet& t, float* ring) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const float* chunk = ring + (size_t)(i & 1) * buf;
    issue(t, ring, i + 1);
    ++i;
    return chunk;
  }
};

// acc += gbuf (the NP k-rows of gH, k-major) x the next step's matrix
// [NP][16 TN] in chunks of KC k-rows: thread (ty, tx) owns rows 4 ty .. 4 ty
// + 3 and the columns 64 q + 4 tx + i; fmaf in ascending k.
template <int NP, int TN, int KC>
__device__ __forceinline__ void nrt_chain_product(float (&acc)[4][TN], const float* gbuf,
                                                  NrtChainStream<NP>& S, const NrtChainNet& t,
                                                  float* ring) {
  constexpr int LD = NRT_BWD_LD, W = 16 * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int ch = 0; ch < NP / KC; ++ch) {
    const float* wc = S.next(t, ring);
    const float* ac = gbuf + (size_t)ch * KC * LD + 4 * ty;
    for (int k8 = 0; k8 < KC; k8 += 8) {
#pragma unroll
      for (int kk = k8; kk < k8 + 8; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(ac + kk * LD);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float w[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(wc + kk * W + 64 * q + 4 * tx);
          w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], w[c], acc[r][c]);
      }
    }
  }
}

// 4 values of row `row` of a [n][H] array from column c0 (a float4 when
// `vec`, else one by one); zeros past n and H.
__device__ __forceinline__ void nrt_row4(const float* __restrict__ a, bool vec, int row, int n,
                                         int H, int c0, float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (row >= n) return;
  const float* p = a + (size_t)row * H + c0;
  if (vec) {
    if (c0 < H) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + i < H) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ bool nrt_vec_ok(const float* p, int H) {
  return (H & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The thread's values of hs[k] (rows 4 ty + r, columns 64 q + 4 tx + i at
// h[r][4 q + i]), for nrt_chain_store.
template <int NP>
__device__ __forceinline__ void nrt_chain_hs(const float* __restrict__ hk, int row0, int n, int H,
                                             float (&h)[4][NP / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = nrt_vec_ok(hk, H);
#pragma unroll
  for (int q = 0; q < NP / 64; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v[4];
      nrt_row4(hk, vec, row0 + 4 * ty + r, n, H, 64 * q + 4 * tx, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[r][4 * q + i] = v[i];
    }
}

// gH[k] = acc * act'(hs[k]) (h: nrt_chain_hs's values): into the k-major
// buffer gbuf (the caller has synchronised: nobody reads it any more) and,
// for the rows below n and the columns below H, to gk.
template <int NP, int ACT>
__device__ __forceinline__ void nrt_chain_store(const float (&acc)[4][NP / 16],
                                                const float (&h)[4][NP / 16],
                                                float* __restrict__ gk, float* gbuf, int row0,
                                                int n, int H) {
  constexpr int LD = NRT_BWD_LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool gvec = nrt_vec_ok(gk, H);
#pragma unroll
  for (int q = 0; q < NP / 64; ++q) {
    const int c0 = 64 * q + 4 * tx;
    float gv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 4 * ty + r;
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[r][i] = acc[r][4 * q + i] * nrt_dact(h[r][4 * q + i], ACT);
      if (row < n) {
        float* p = gk + (size_t)row * H + c0;
        if (gvec) {
          if (c0 < H)
            *reinterpret_cast<float4*>(p) = make_float4(gv[r][0], gv[r][1], gv[r][2], gv[r][3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c0 + i < H) p[i] = gv[r][i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(gbuf + (size_t)(c0 + i) * LD + 4 * ty) =
          make_float4(gv[0][i], gv[1][i], gv[2][i], gv[3][i]);
  }
}

// ebuf (genc_act, k-major) += acc at the thread's own positions.
template <int TN>
__device__ __forceinline__ void nrt_chain_add(const float (&acc)[4][TN], float* ebuf) {
  constexpr int LD = NRT_BWD_LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < TN / 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* p = reinterpret_cast<float4*>(ebuf + (size_t)(64 * q + 4 * tx + i) * LD + 4 * ty);
      float4 v = *p;
      v.x += acc[0][4 * q + i];
      v.y += acc[1][4 * q + i];
      v.z += acc[2][4 * q + i];
      v.w += acc[3][4 * q + i];
      *p = v;
    }
}

// genc = acc (gH[0] W0^T) + genc_act * act'(enc) into ebuf, own positions.
template <int TN, int ACT>
__device__ __forceinline__ void nrt_chain_genc(const float (&acc)[4][TN],
                                               const float* __restrict__ enc, float* ebuf,
                                               int row0, int n, int E) {
  constexpr int LD = NRT_BWD_LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < TN / 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 64 * q + 4 * tx + i;
      float* p = ebuf + (size_t)e * LD + 4 * ty;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + 4 * ty + r;
        const float v = row < n && e < E ? __ldg(enc + (size_t)row * E + e) : 0.f;
        p[r] = acc[r][4 * q + i] + p[r] * nrt_dact(v, ACT);
      }
    }
}

// Backprop of rows [64 b, 64 b + 64) through hidden layers [l0, l1).
// top_mode 1 (K6, l1 == L): g_top is the output gradient [n][O] and the out
// layer comes first (writing gH[L]); top_mode 0 (K7b): g_top is gH[l1]
// [n][H].  Writes gH[k] for l0 <= k < l1 (hs.p[k] and gh.p[k] given for
// them, and for L in top_mode 1).  genc_out (optional): genc_act [n][E],
// the act(enc) gradient summed over the skip layers.  dx_out (optional, l0
// == 0, with enc [n][E]): the init layer and the Fourier epilogue.
template <int NP, int TNE>
__global__ void __launch_bounds__(NRT_THREADS, (NP == 128 && TNE <= 12) ? 2 : 1)
nrt_bwd_chain_kernel(const float* __restrict__ x, const float* __restrict__ g_top, int top_mode,
                     int l0, int l1, int n, const __grid_constant__ NrtChainNet t,
                     const __grid_constant__ NrtRowPtrs hs, const __grid_constant__ NrtRowPtrs gh,
                     const float* __restrict__ enc, float* __restrict__ genc_out,
                     float* __restrict__ dx_out) {
  constexpr int M = NRT_BWD_M, LD = NRT_BWD_LD, TN = NP / 16, EPT = 16 * TNE;
  constexpr int KCH = NRT_BWD_KC_H(NP), KCE = NRT_BWD_KC_E;
  extern __shared__ __align__(16) float smem[];
  const int buf = KCH * NP > KCE * EPT ? KCH * NP : KCE * EPT;
  float* ring = smem;                // [2][buf] the stream's buffers
  float* gbuf = ring + 2 * buf;      // [NP][LD] gH, k-major
  float* ebuf = gbuf + NP * LD;      // [EPT][LD] genc_act, then genc
  float* xs = ebuf + EPT * LD;       // [M][3]
  float* gs = xs + 3 * M;            // [O][M] the output gradient (top_mode 1)
  const int row0 = blockIdx.x * M;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  NrtChainStream<NP> S;
  S.start(t, ring, buf);

  for (int i = threadIdx.x; i < 3 * M; i += blockDim.x)
    xs[i] = row0 + i / 3 < n ? x[(size_t)row0 * 3 + i] : 0.f;
  for (int i = threadIdx.x; i < EPT * LD; i += blockDim.x) ebuf[i] = 0.f;
  if (top_mode == 1) {   // gH[L] = (g W_out^T) * act'(hs[L])
    for (int i = threadIdx.x; i < t.O * M; i += blockDim.x) {
      const int o = i / M, r = i % M;
      gs[i] = row0 + r < n ? g_top[(size_t)(row0 + r) * t.O + o] : 0.f;
    }
    float h[4][TN];
    nrt_chain_hs<NP>(hs.p[t.L], row0, n, t.H, h);
    __syncthreads();
    float acc[4][TN];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
    for (int o = 0; o < t.O; ++o) {
      const float4 a = *reinterpret_cast<const float4*>(gs + o * M + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(t.w_out + (size_t)o * NP + 64 * q + 4 * tx));
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][4 * q + i] = fmaf(av[r], w[i], acc[r][4 * q + i]);
      }
    }
    nrt_with_act(t.act, [&](auto a) {
      nrt_chain_store<NP, decltype(a)::value>(acc, h, gh.p[t.L], gbuf, row0, n, t.H);
    });
  } else {               // gH[l1] from g_top
    for (int i = threadIdx.x; i < M * NP; i += blockDim.x) {
      const int r = i / NP, c = i % NP;
      gbuf[(size_t)c * LD + r] =
          row0 + r < n && c < t.H ? g_top[(size_t)(row0 + r) * t.H + c] : 0.f;
    }
  }
  // (the first chunk's barrier orders all of this before its reads)

  for (int k = l1 - 1; k >= l0; --k) {
    if (k % t.skip == 0 && k != t.L - 1) {   // genc_act += gH[k+1] W_enc^T
      float acc[4][TNE];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < TNE; ++c) acc[r][c] = 0.f;
      nrt_chain_product<NP, TNE, KCE>(acc, gbuf, S, t, ring);
      nrt_chain_add<TNE>(acc, ebuf);
    }
    float h[4][TN];
    nrt_chain_hs<NP>(hs.p[k], row0, n, t.H, h);
    float acc[4][TN];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
    nrt_chain_product<NP, TN, KCH>(acc, gbuf, S, t, ring);
    __syncthreads();   // every thread is done reading gbuf
    nrt_with_act(t.act, [&](auto a) {
      nrt_chain_store<NP, decltype(a)::value>(acc, h, gh.p[k], gbuf, row0, n, t.H);
    });
  }

  if (genc_out != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < M * t.E; i += blockDim.x) {
      const int r = i / t.E, e = i % t.E;
      if (row0 + r < n) genc_out[(size_t)(row0 + r) * t.E + e] = ebuf[(size_t)e * LD + r];
    }
  }
  if (dx_out != nullptr) {   // the init layer, then dx
    float acc[4][TNE];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < TNE; ++c) acc[r][c] = 0.f;
    nrt_chain_product<NP, TNE, KCE>(acc, gbuf, S, t, ring);
    nrt_with_act(t.act, [&](auto a) {
      nrt_chain_genc<TNE, decltype(a)::value>(acc, enc, ebuf, row0, n, t.E);
    });
    __syncthreads();
    const int F = t.F;
    // the sin slots take g_sin cos(x B) - g_cos sin(x B)
    for (int i = threadIdx.x; i < M * F; i += blockDim.x) {
      const int r = i % M, f = i / M;
      float mapped = 0.f;
      for (int d = 0; d < 3; ++d) mapped = fmaf(xs[r * 3 + d], __ldg(t.B + d * F + f), mapped);
      float* gsin = ebuf + (size_t)(3 + f) * LD + r;
      *gsin = *gsin * cosf(mapped) - ebuf[(size_t)(3 + F + f) * LD + r] * sinf(mapped);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M * 3; i += blockDim.x) {
      const int r = i / 3, d = i % 3;
      if (row0 + r >= n) continue;
      float acc_d = ebuf[(size_t)d * LD + r];
      for (int f = 0; f < F; ++f)
        acc_d = fmaf(ebuf[(size_t)(3 + f) * LD + r], __ldg(t.B + d * F + f), acc_d);
      dx_out[(size_t)(row0 + r) * 3 + d] = acc_d;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- 3. dW = A^T G, all layers of a call, rows in fixed slices ------------------

// One layer: A = [act1(a1 [n][k1]), act2(a2 [n][k2])], G = g [n][N]; output
// at off: dW [k1 + k2][N] then db [N].
struct NrtDwJob {
  const float* a1;
  const float* a2;
  const float* g;
  long long off;
  int k1, k2, act1, act2, N, tiles_n, tile0;
};

struct NrtDwJobs {
  NrtDwJob job[NRT_MAX_LAYERS + 2];
  int count;
};

// One float of global memory into shared memory, asynchronously; zero
// (nothing read) unless `valid`.
__device__ __forceinline__ void nrt_cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

// One column of a chunk a thread copies: rows row, row + 2, ... of a
// [n][ld] array from p (at `row`), advanced a chunk at a time.
struct NrtDwColumn {
  const float* p;   // null: a column past the job's, zero
  long long ld;
  __device__ __forceinline__ void issue(float* dst, int row, int r_end, const float* any) {
    const float* q = p;
#pragma unroll
    for (int i = 0; i < NRT_DW_R / 2; ++i) {
      const bool ok = p != nullptr && row + 2 * i < r_end;
      nrt_cp_async4(dst + 2 * i * NRT_DW_T, ok ? q : any, ok);
      q += 2 * ld;
    }
    if (p != nullptr) p += NRT_DW_R * ld;
  }
};

// Block (x, y): tile x of the jobs' tiles (in job order, each job's tiles
// row-major over its [k1 + k2][N] output), rows [y R, y R + R) of the slice
// y.  Writes its outputs (and, for a tile of the first 128 k, db) at out +
// y total.  A chunk of NRT_DW_R rows of the tile's A and G columns lands in
// one of two shared buffers by cp.async while the other is used (no
// register holds it); each thread then applies the activation to the A
// values it copied and adds the G values it copied to db.  Each output is
// an fmaf chain over the slice's rows in ascending order; db sums the even
// rows and the odd rows, then the two.
template <int ACT>
__global__ void __launch_bounds__(256, 2)
nrt_dw_kernel(const __grid_constant__ NrtDwJobs J, int n, int rows_per_slice, long long total,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  auto As = reinterpret_cast<float (*)[NRT_DW_R][NRT_DW_T]>(smem);
  auto Gs = reinterpret_cast<float (*)[NRT_DW_R][NRT_DW_T]>(smem + 2 * NRT_DW_R * NRT_DW_T);
  int jb = 0;
  while (jb + 1 < J.count && J.job[jb + 1].tile0 <= (int)blockIdx.x) ++jb;
  const NrtDwJob& jo = J.job[jb];
  const int K = jo.k1 + jo.k2, N = jo.N;
  const int local = blockIdx.x - jo.tile0;
  const int k0 = (local / jo.tiles_n) * NRT_DW_T, j0 = (local % jo.tiles_n) * NRT_DW_T;
  const int r_begin = blockIdx.y * rows_per_slice;
  const int r_end = min(n, r_begin + rows_per_slice);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // the column of A and of G this thread copies, rows rr0, rr0 + 2, ... of a chunk
  const int cc = tid % NRT_DW_T, rr0 = tid / NRT_DW_T;
  const int ka = k0 + cc, jg = j0 + cc;
  NrtDwColumn ca{nullptr, 1}, cg{nullptr, 1};
  bool aact = false;
  if (ka < jo.k1) {
    ca = NrtDwColumn{jo.a1 + (size_t)(r_begin + rr0) * jo.k1 + ka, jo.k1};
    aact = jo.act1 != 0;
  } else if (ka < K) {
    ca = NrtDwColumn{jo.a2 + (size_t)(r_begin + rr0) * jo.k2 + (ka - jo.k1), jo.k2};
    aact = jo.act2 != 0;
  }
  if (jg < N) cg = NrtDwColumn{jo.g + (size_t)(r_begin + rr0) * N + jg, N};
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  float db = 0.f;
  if (r_begin < r_end) {
    ca.issue(&As[0][rr0][cc], r_begin + rr0, r_end, jo.g);
    cg.issue(&Gs[0][rr0][cc], r_begin + rr0, r_end, jo.g);
    nrt_cp_async_commit();
    int b = 0;
    for (int rb = r_begin; rb < r_end; rb += NRT_DW_R) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
      for (int q = 0; q < NRT_DW_R / 2; ++q) {   // the values this thread copied
        float* a = &As[b][rr0 + 2 * q][cc];
        if (aact) *a = nrt_act(*a, ACT);
        db += Gs[b][rr0 + 2 * q][cc];
      }
      __syncthreads();   // the chunk is in; everyone is done with the other buffer
      if (rb + NRT_DW_R < r_end) {
        ca.issue(&As[b ^ 1][rr0][cc], rb + NRT_DW_R + rr0, r_end, jo.g);
        cg.issue(&Gs[b ^ 1][rr0][cc], rb + NRT_DW_R + rr0, r_end, jo.g);
        nrt_cp_async_commit();
      }
#pragma unroll 8
      for (int rr = 0; rr < NRT_DW_R; ++rr) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[b][rr][4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[b][rr][64 + 4 * ty]);
        const float4 g0 = *reinterpret_cast<const float4*>(&Gs[b][rr][4 * tx]);
        const float4 g1 = *reinterpret_cast<const float4*>(&Gs[b][rr][64 + 4 * tx]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p], gv[q], acc[p][q]);
      }
      b ^= 1;
    }
    __syncthreads();   // everyone is done with the buffers
  }
  float* dst = out + (size_t)blockIdx.y * total + jo.off;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int k = k0 + (p < 4 ? 4 * ty + p : 64 + 4 * ty + p - 4);
    if (k >= K) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + (q < 4 ? 4 * tx + q : 64 + 4 * tx + q - 4);
      if (j < N) dst[(size_t)k * N + j] = acc[p][q];
    }
  }
  if (k0 == 0) {   // db: the even rows' sum (threads 0-127) + the odd rows' (128-255)
    float* red = smem;
    if (rr0 == 1) red[cc] = db;
    __syncthreads();
    if (rr0 == 0 && jg < N) dst[(size_t)K * N + jg] = db + red[cc];
  }
}

// out[e] = part[0][e] + part[1][e] + ... in slice order.
__global__ void nrt_dw_reduce_kernel(const float* __restrict__ part, long long total, int slices,
                                     float* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int sl = 1; sl < slices; ++sl) s += part[(size_t)sl * total + e];
    out[e] = s;
  }
}

// ---- 4. the transposed pack -------------------------------------------------------

struct NrtTransposePack {
  const float* src[NRT_MAX_LAYERS + 1];   // init w [E][H], hidden i w [fan_in][H]
  float* dst[2 * NRT_MAX_LAYERS + 1];     // W0T, h_0, e_0, ..., h_{L-1}, e_{L-1}
  int H, E, NP, EPT;
};

__global__ void nrt_mlp_tile_pack_t_kernel(const __grid_constant__ NrtTransposePack p) {
  const int s = blockIdx.y;
  float* dst = p.dst[s];
  if (dst == nullptr) return;   // the e matrix of a plain layer
  const bool hpart = s % 2 == 1;
  const int W = hpart ? p.NP : p.EPT, cols = hpart ? p.H : p.E;
  const float* w = p.src[s == 0 ? 0 : 1 + (s - 1) / 2];
  const int first = s > 0 && !hpart ? p.H : 0;   // the fan-in row of column 0
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < p.NP * W; e += gridDim.x * blockDim.x) {
    const int j = e / W, c = e % W;
    dst[e] = j < p.H && c < cols ? w[(size_t)(first + c) * p.H + j] : 0.f;
  }
}

// ---- C interface ---------------------------------------------------------------------

static int nrt_ept(int freqs) { return (3 + 2 * freqs + 63) / 64 * 64; }

static void nrt_fill_rows(NrtRowPtrs& out, int L, void* const* ptrs) {
  for (int k = 0; k <= NRT_MAX_LAYERS; ++k)
    out.p[k] = k <= L ? static_cast<float*>(ptrs[k]) : nullptr;
}

template <int NP>
static size_t nrt_store_fwd_smem(int EP) {
  typedef NrtStream<NP, false, NRT_BWD_FWD_KC(NP)> Stream;
  return nrt_f32_sdf_smem<NP, Stream::RING, NRT_BWD_M>(EP);
}

// weights: K1's packed f32 table (kernels/fused_mlp.py tile_layout).
// Hidden layers l_first - 1 .. l_last - 1 (and the init layer with
// l_first 0); hs_ptrs: L + 1 entries.
extern "C" int nrt_mlp_tile_store_forward(const float* x, const float* h_in, int l_first,
                                          int l_last, void* const* hs_ptrs, float* enc_out, int n,
                                          int in_size, int freqs, int hidden, int num_layers,
                                          int skip, int out_size, int act,
                                          const void* const* weights, void* stream) {
  TiledNet m;
  NrtRowPtrs hs;
  if (n < 0 || in_size != 3 || out_size <= 0 ||
      !nrt_tiled_fill(m, freqs, hidden, num_layers, skip, act, 0, weights) || l_first < 0 ||
      l_first > l_last || l_last > num_layers)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;   // (an empty tensor's address may be null)
  if ((h_in == nullptr) != (l_first == 0)) return (int)cudaErrorInvalidValue;
  nrt_fill_rows(hs, num_layers, hs_ptrs);
  const int grid = (n + NRT_BWD_M - 1) / NRT_BWD_M;
  if (m.NP == 128)
    return nrt_launch(nrt_bwd_store_fwd_kernel<128, NRT_BWD_FWD_KC(128)>, grid,
                      nrt_store_fwd_smem<128>(m.EP), stream, x, h_in, l_first, l_last, n, m, hs,
                      enc_out);
  return nrt_launch(nrt_bwd_store_fwd_kernel<256, NRT_BWD_FWD_KC(256)>, grid,
                    nrt_store_fwd_smem<256>(m.EP), stream, x, h_in, l_first, l_last, n, m, hs,
                    enc_out);
}

typedef void (*NrtChainKernel)(const float*, const float*, int, int, int, int, const NrtChainNet,
                               const NrtRowPtrs, const NrtRowPtrs, const float*, float*, float*);

template <int NP>
static NrtChainKernel nrt_chain_kernel(int tne) {
  switch (tne) {
    case 4: return nrt_bwd_chain_kernel<NP, 4>;
    case 8: return nrt_bwd_chain_kernel<NP, 8>;
    case 12: return nrt_bwd_chain_kernel<NP, 12>;
    case 16: return nrt_bwd_chain_kernel<NP, 16>;
    default: return nrt_bwd_chain_kernel<NP, 20>;
  }
}

static size_t nrt_chain_smem(int NP, int EPT, int out_size) {
  const int kch = NRT_BWD_KC_H(NP);
  const int buf = kch * NP > NRT_BWD_KC_E * EPT ? kch * NP : NRT_BWD_KC_E * EPT;
  return sizeof(float) * ((size_t)2 * buf + (size_t)(NP + EPT) * NRT_BWD_LD + 3 * NRT_BWD_M +
                          (size_t)out_size * NRT_BWD_M);
}

// weights: K1's packed f32 table (B, out w); wt: the transposed pack's table
// [W0T, h_0, e_0, ..., h_{L-1}, e_{L-1}] (e_i null on a plain layer).
extern "C" int nrt_mlp_tile_backward(const float* x, const float* g_top, int top_mode, int l0,
                                     int l1, void* const* hs_ptrs, void* const* gh_ptrs,
                                     const float* enc, float* genc_out, float* dx_out, int n,
                                     int in_size, int freqs, int hidden, int num_layers, int skip,
                                     int out_size, int act, const void* const* weights,
                                     const void* const* wt, void* stream) {
  if (n < 0 || in_size != 3 || out_size <= 0 || num_layers < 0 || num_layers > NRT_MAX_LAYERS ||
      skip <= 0 || freqs < 0 || freqs > 128 || hidden <= 0 || hidden > 256 || act < 0 ||
      act > NRT_IDENTITY || l0 < 0 || l1 > num_layers || l0 > l1 ||
      (top_mode == 1 && l1 != num_layers))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;   // (an empty tensor's address may be null)
  if (dx_out != nullptr && (l0 != 0 || enc == nullptr)) return (int)cudaErrorInvalidValue;
  const int NP = hidden <= 128 ? 128 : 256, EPT = nrt_ept(freqs);
  NrtChainNet t;
  t.B = static_cast<const float*>(weights[0]);
  t.w_out = static_cast<const float*>(weights[1 + 2 * (num_layers + 1)]);
  t.F = freqs;
  t.H = hidden;
  t.L = num_layers;
  t.skip = skip;
  t.act = act;
  t.E = 3 + 2 * freqs;
  t.O = out_size;
  const int kch = NRT_BWD_KC_H(NP);
  int s = 0;
  auto step = [&](const void* w, int width, int kc) {
    t.step_w[s] = static_cast<const float*>(w);
    t.step_width[s] = width;
    t.step_kc[s++] = kc;
  };
  for (int k = l1 - 1; k >= l0; --k) {
    if (k % skip == 0 && k != num_layers - 1) {
      if (wt[2 + 2 * k] == nullptr) return (int)cudaErrorInvalidValue;
      step(wt[2 + 2 * k], EPT, NRT_BWD_KC_E);
    }
    step(wt[1 + 2 * k], NP, kch);
  }
  if (dx_out != nullptr) step(wt[0], EPT, NRT_BWD_KC_E);
  t.steps = s;
  while (s < NRT_BWD_MAX_STEPS) step(nullptr, 0, 1);
  NrtRowPtrs hs, gh;
  nrt_fill_rows(hs, num_layers, hs_ptrs);
  nrt_fill_rows(gh, num_layers, gh_ptrs);
  const NrtChainKernel kernel =
      NP == 128 ? nrt_chain_kernel<128>(EPT / 16) : nrt_chain_kernel<256>(EPT / 16);
  return nrt_launch(kernel, (n + NRT_BWD_M - 1) / NRT_BWD_M, nrt_chain_smem(NP, EPT, out_size),
                    stream, x, g_top, top_mode, l0, l1, n, t, hs, gh, enc, genc_out, dx_out);
}

template <typename F>
static int nrt_with_act_host(int act, F f) {
  switch (act) {
    case NRT_LEAKY_RELU: return f(NrtActCode<NRT_LEAKY_RELU>());
    case NRT_RELU: return f(NrtActCode<NRT_RELU>());
    case NRT_SOFTPLUS: return f(NrtActCode<NRT_SOFTPLUS>());
    case NRT_SIGMOID: return f(NrtActCode<NRT_SIGMOID>());
    case NRT_TANH: return f(NrtActCode<NRT_TANH>());
    case NRT_ELU: return f(NrtActCode<NRT_ELU>());
    default: return f(NrtActCode<NRT_IDENTITY>());
  }
}

// count layers: a1/a2/g their arrays (a2 null: none), dims count x 5 ints
// [k1, act1, k2, act2, N], off count x 8 bytes: each output's offset in out
// ([k1 + k2][N] dW, then [N] db), total the floats of out.  The rows split
// into `slices` of rows_per_slice; with more than one slice the sums go to
// partial ([slices][total]) and a second launch adds them in slice order.
extern "C" int nrt_mlp_tile_dw(int count, const void* const* a1, const void* const* a2,
                               const void* const* g, const int* dims, const long long* off,
                               long long total, int n, int slices, int rows_per_slice, int act,
                               float* partial, float* out, void* stream) {
  if (count <= 0 || count > NRT_MAX_LAYERS + 2 || n < 0 || slices <= 0 || rows_per_slice <= 0 ||
      (long long)slices * rows_per_slice < n || total <= 0 || (slices > 1 && partial == nullptr) ||
      act < 0 || act > NRT_IDENTITY)
    return (int)cudaErrorInvalidValue;
  NrtDwJobs J;
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    NrtDwJob& j = J.job[i];
    j.a1 = static_cast<const float*>(a1[i]);
    j.a2 = static_cast<const float*>(a2[i]);
    j.g = static_cast<const float*>(g[i]);
    j.k1 = dims[5 * i];
    j.act1 = dims[5 * i + 1];
    j.k2 = dims[5 * i + 2];
    j.act2 = dims[5 * i + 3];
    j.N = dims[5 * i + 4];
    j.off = off[i];
    if (j.k1 <= 0 || j.k2 < 0 || j.N <= 0 || (n > 0 && j.k2 > 0 && j.a2 == nullptr) ||
        j.off + (long long)(j.k1 + j.k2 + 1) * j.N > total)
      return (int)cudaErrorInvalidValue;
    j.tiles_n = (j.N + NRT_DW_T - 1) / NRT_DW_T;
    j.tile0 = tiles;
    tiles += j.tiles_n * ((j.k1 + j.k2 + NRT_DW_T - 1) / NRT_DW_T);
  }
  J.count = count;
  float* dst = slices > 1 ? partial : out;
  const dim3 grid(tiles, slices);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = (cudaError_t)nrt_with_act_host(act, [&](auto a) {
    const cudaError_t e = cudaFuncSetAttribute(nrt_dw_kernel<decltype(a)::value>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)NRT_DW_SMEM);
    if (e != cudaSuccess) return (int)e;
    nrt_dw_kernel<decltype(a)::value><<<grid, 256, NRT_DW_SMEM, st>>>(J, n, rows_per_slice, total,
                                                                       dst);
    return (int)cudaGetLastError();
  });
  if (err != cudaSuccess || slices == 1) return (int)err;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  nrt_dw_reduce_kernel<<<(int)blocks, 256, 0, st>>>(partial, total, slices, out);
  return (int)cudaGetLastError();
}

// src: the module's [init w, layer 0 w, ..., layer L-1 w] (float32
// [fan_in][hidden]); dst: the transposed pack's table (1 + 2 L entries,
// e_i null on a plain layer).
extern "C" int nrt_mlp_tile_pack_transposes(const void* const* src, void* const* dst, int freqs,
                                            int hidden, int num_layers, void* stream) {
  if (num_layers < 0 || num_layers > NRT_MAX_LAYERS || freqs < 0 || freqs > 128 || hidden <= 0 ||
      hidden > 256)
    return (int)cudaErrorInvalidValue;
  NrtTransposePack p;
  p.H = hidden;
  p.E = 3 + 2 * freqs;
  p.NP = hidden <= 128 ? 128 : 256;
  p.EPT = nrt_ept(freqs);
  for (int l = 0; l <= NRT_MAX_LAYERS; ++l)
    p.src[l] = l <= num_layers ? static_cast<const float*>(src[l]) : nullptr;
  const int slots = 1 + 2 * num_layers;
  for (int s = 0; s <= 2 * NRT_MAX_LAYERS; ++s)
    p.dst[s] = s < slots ? static_cast<float*>(dst[s]) : nullptr;
  const int most = p.NP * (p.NP > p.EPT ? p.NP : p.EPT);
  const int per_slot = (most + NRT_THREADS - 1) / NRT_THREADS;
  const dim3 grid(per_slot < 64 ? per_slot : 64, slots);
  nrt_mlp_tile_pack_t_kernel<<<grid, NRT_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

static int nrt_attr(const void* kernel, int threads, size_t smem, int* blocks, int* regs,
                    int* local) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  return 0;
}

// The kernels for this net, as the library reports them: info = [chain
// blocks per SM, registers, local bytes, dynamic shared bytes; store
// forward the same four; dW the same four].
extern "C" int nrt_mlp_tile_bwd_info(int freqs, int hidden, int out_size, int act, int* info) {
  if (freqs < 0 || freqs > 128 || hidden <= 0 || hidden > 256 || out_size <= 0 || act < 0 ||
      act > NRT_IDENTITY || info == nullptr)
    return (int)cudaErrorInvalidValue;
  const int NP = hidden <= 128 ? 128 : 256, EPT = nrt_ept(freqs);
  const int EP = (3 + 2 * freqs + 7) / 8 * 8;
  const size_t chain_smem = nrt_chain_smem(NP, EPT, out_size);
  const void* chain = (const void*)(NP == 128 ? nrt_chain_kernel<128>(EPT / 16)
                                              : nrt_chain_kernel<256>(EPT / 16));
  const size_t fwd_smem = NP == 128 ? nrt_store_fwd_smem<128>(EP) : nrt_store_fwd_smem<256>(EP);
  const void* fwd = NP == 128 ? (const void*)nrt_bwd_store_fwd_kernel<128, NRT_BWD_FWD_KC(128)>
                              : (const void*)nrt_bwd_store_fwd_kernel<256, NRT_BWD_FWD_KC(256)>;
  int rc = nrt_attr(chain, NRT_THREADS, chain_smem, info, info + 1, info + 2);
  info[3] = (int)chain_smem;
  if (rc == 0) rc = nrt_attr(fwd, NRT_THREADS, fwd_smem, info + 4, info + 5, info + 6);
  info[7] = (int)fwd_smem;
  if (rc == 0)
    rc = nrt_with_act_host(act, [&](auto a) {
      return nrt_attr((const void*)nrt_dw_kernel<decltype(a)::value>, 256, NRT_DW_SMEM, info + 8,
                      info + 9, info + 10);
    });
  info[11] = (int)NRT_DW_SMEM;
  return rc;
}
