// K6 and K7: the fused SkipConnMLP backward, monolithic and checkpointed.
//
// Replaces the TPU kernels of neural_raytracing_tpu/kernels/fused_mlp.py:
//   K6  _pallas_backward            (recompute the forward, backprop every layer)
//   K7a _pallas_backward_segmented, checkpoint call (boundary pre-activations)
//   K7b _pallas_backward_segmented, segment call (backprop layers [l0, l1))
// Math (enc = [x, sin xB, cos xB], hs[0] = enc W0 + b0,
// hs[i+1] = a_i W_{1+i} + b_{1+i} with a_i = act(hs[i]) (++ act(enc) on a
// skip layer), out = act(hs[L]) W_out + b_out; gH[k] = dL/d hs[k]):
//   gH[L] = (g W_out^T) * act'(hs[L])
//   ga    = gH[i+1] W_{1+i}^T;  gH[i] = ga[:, :H] * act'(hs[i]);  genc_act += ga[:, H:] (skip)
//   dW_{1+i} = a_i^T gH[i+1],  db = sum gH[i+1];  dW_out = act(hs[L])^T g;  dW0 = enc^T gH[0]
//   genc  = gH[0] W0^T + genc_act * act'(enc)
//   dx    = genc[:, :in] + (g_sin cos(xB) - g_cos sin(xB)) B^T       (dB = 0)
//
// Design for the card.  The TPU kernel runs its grid in order and carries
// dW in VMEM; here blocks run in parallel, so the work is split in three
// kernels that share the device MLP of mlp.cuh:
//   1. nrt_mlp_store_fwd_kernel: the forward over 32-row tiles, writing the
//      requested pre-activations hs[k] (all of them for K6, the segment
//      boundaries for K7a, one segment's inner layers for K7b) and the raw
//      encoding to a global workspace;
//   2. nrt_mlp_bwd_layers_kernel: the routine "backprop through layers
//      [l0, l1)" that K6 and K7b share, over 16-row tiles with gH and the
//      split gradient in shared memory, reading hs[k] from the workspace and
//      writing every gH[k] back to it.  K6 adds the out layer before it and
//      the init layer + dx epilogue after it, in the same kernel;
//   3. nrt_mlp_outer_kernel: dW = A^T G (+ the bias row, db = sum G) as a
//      split-over-rows product: 64x64 output tiles, 16 rows per stage in
//      shared memory, 4x4 outputs per thread, one atomicAdd per output and
//      row slice.  Atomics sum the slices in a varying order.
// Workspace (float32, the wrapper allocates it): K6 keeps hs and gH of all
// L + 1 layers, 2 (L + 1) N H floats plus N E for enc (1.37 GB for the 16x256
// weight net at N = 38,400); K7 keeps the (S + 1) boundaries and one
// segment's hs and gH.  Shared memory: the forward 32 (E + 2H) floats
// (99 KB for the weight net), the backward 16 (H + max(H + E) + E) floats
// (66 KB).  Bound on an H100: f32 FMA issue, 6 x the forward MACs per row
// (recompute, gradient, dW); the workspace adds ~4 (L + 1) N H bytes of
// traffic, a fraction of a millisecond at 3.35 TB/s.
//
// C interface for ctypes: each entry point returns a cudaError_t as int.
#include "mlp.cuh"

#define NRT_BWD_ROWS 16

struct LayerPtrs {   // one [n, H] buffer per hs / gH index 0..L (nullptr: none)
  float* p[NRT_MAX_LAYERS + 1];
};

struct TWeights {    // transposed weights: [0] init [H, E], [1 + i] layer i
  const float* wt[NRT_MAX_LAYERS + 2];   // [H, fan_in], [L + 1] out [O, H]
};

// dst[r][j] = sum_k s[r*ld + k] * W[k*N + j]   (r < R, j < N)
template <int RT>
__device__ void nrt_mm_rt(const float* s, int ld, int K, const float* __restrict__ W,
                          int N, float* dst, int ldd, int R) {
  const int n_items = (R / RT) * N;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int j = item % N;
    const int r0 = (item / N) * RT;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    nrt_accum<RT>(acc, s + r0 * ld, ld, K, W, N, j);
#pragma unroll
    for (int r = 0; r < RT; ++r) dst[(r0 + r) * ldd + j] = acc[r];
  }
}

__device__ __forceinline__ void nrt_mm(const float* s, int ld, int K,
                                       const float* __restrict__ W, int N,
                                       float* dst, int ldd, int R) {
  if (N >= 32 && R % NRT_RT == 0)
    nrt_mm_rt<NRT_RT>(s, ld, K, W, N, dst, ldd, R);
  else
    nrt_mm_rt<1>(s, ld, K, W, N, dst, ldd, R);
}

// Writes rows [0, R) x [0, C) of the tile buffer src (stride lds) to
// dst[(row0 + r) * C + c] for rows below n.
__device__ __forceinline__ void nrt_store_rows(const float* src, int lds, int C,
                                               float* dst, int row0, int R, int n) {
  for (int idx = threadIdx.x; idx < R * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C;
    if (row0 + r < n) dst[(size_t)(row0 + r) * C + c] = src[r * lds + c];
  }
}

__device__ __forceinline__ void nrt_load_rows(float* dst, int ldd, int C,
                                              const float* src, int row0, int R, int n) {
  for (int idx = threadIdx.x; idx < R * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C;
    dst[r * ldd + c] = row0 + r < n ? src[(size_t)(row0 + r) * C + c] : 0.f;
  }
}

__device__ __forceinline__ void nrt_act_rows(float* buf, int ld, int C, int R, int act) {
  for (int idx = threadIdx.x; idx < R * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C;
    buf[r * ld + c] = nrt_act(buf[r * ld + c], act);
  }
}

// ---- 1. forward that stores pre-activations --------------------------------
// From x (h_in == nullptr): hs[0] = init(enc), then layers l_start..l_end-1
// (l_start must be 0).  From h_in = hs[l_start]: layers l_start..l_end-1.
// Layer i writes hs[i + 1] where hs.p[i + 1] != nullptr; enc_out (optional)
// gets the raw encoding.
__global__ void __launch_bounds__(NRT_THREADS)
nrt_mlp_store_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h_in,
                         int l_start, int l_end, int n,
                         const __grid_constant__ MLPWeights m,
                         const __grid_constant__ LayerPtrs hs,
                         float* __restrict__ enc_out) {
  extern __shared__ __align__(16) float smem[];
  const int R = NRT_ROWS;
  const int in = m.in_size, H = m.hidden, E = in + 2 * m.freqs;
  const int es = nrt_round4(E), hsz = nrt_round4(H);
  float* xs = smem;                       // [R][in]
  float* enc = xs + nrt_round4(R * in);   // [R][es]
  float* cur = enc + R * es;              // [R][hsz]
  float* nxt = cur + R * hsz;             // [R][hsz]
  const int row0 = blockIdx.x * R;

  nrt_load_rows(xs, in, in, x, row0, R, n);
  __syncthreads();
  nrt_fourier_encode(m, xs, R, enc, es);
  __syncthreads();
  if (enc_out) nrt_store_rows(enc, es, E, enc_out, row0, R, n);
  if (h_in == nullptr) {
    nrt_linear(enc, es, E, nullptr, 0, 0, m.w[0], m.b[0], H, cur, hsz, R, -1);
  } else {
    nrt_load_rows(cur, hsz, H, h_in, row0, R, n);
  }
  __syncthreads();
  if (h_in == nullptr && hs.p[0]) nrt_store_rows(cur, hsz, H, hs.p[0], row0, R, n);
  nrt_act_rows(enc, es, E, R, m.act);   // skip layers see act(enc)
  nrt_act_rows(cur, hsz, H, R, m.act);
  __syncthreads();

  for (int i = l_start; i < l_end; ++i) {
    const bool skip = (i % m.skip) == 0 && i != m.num_layers - 1;
    nrt_linear(cur, hsz, H, enc, es, skip ? E : 0, m.w[1 + i], m.b[1 + i], H,
               nxt, hsz, R, -1);
    __syncthreads();
    if (hs.p[i + 1]) nrt_store_rows(nxt, hsz, H, hs.p[i + 1], row0, R, n);
    nrt_act_rows(nxt, hsz, H, R, m.act);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ---- 2. backprop through layers [l0, l1) -----------------------------------
// top_mode 1: g_top is the net's output gradient [n, O] and l1 == L (K6);
// top_mode 0: g_top is gH[l1] [n, H] (K7b).  Writes gH[k] for l0 <= k < l1
// (and gH[L] in top_mode 1).  genc_out (optional): the act(enc) part of the
// gradient, summed over the segment's skip layers.  dx_out (optional,
// l0 == 0): the init layer and the Fourier epilogue (K6).
__global__ void __launch_bounds__(NRT_THREADS)
nrt_mlp_bwd_layers_kernel(const float* __restrict__ x, const float* __restrict__ g_top,
                          int top_mode, int l0, int l1, int n,
                          const __grid_constant__ MLPWeights m,
                          const __grid_constant__ TWeights t,
                          const __grid_constant__ LayerPtrs hs,
                          const __grid_constant__ LayerPtrs gh_out,
                          float* __restrict__ genc_out, float* __restrict__ dx_out) {
  extern __shared__ __align__(16) float smem[];
  const int R = NRT_BWD_ROWS;
  const int in = m.in_size, F = m.freqs, H = m.hidden, O = m.out_size;
  const int E = in + 2 * F;
  const int es = nrt_round4(E), hsz = nrt_round4(H);
  const int gas = nrt_round4(H + E);
  float* xs = smem;                       // [R][in]
  float* gh = xs + nrt_round4(R * in);    // [R][hsz]   gradient at hs[k]
  float* ga = gh + R * hsz;               // [R][gas]   gradient at a layer's input
  float* genc = ga + R * gas;             // [R][es]    act(enc) gradient, then genc
  const int row0 = blockIdx.x * R;

  nrt_load_rows(xs, in, in, x, row0, R, n);
  for (int idx = threadIdx.x; idx < R * E; idx += blockDim.x)
    genc[(idx / E) * es + idx % E] = 0.f;
  if (top_mode == 1) {
    nrt_load_rows(ga, gas, O, g_top, row0, R, n);
    __syncthreads();
    nrt_mm(ga, gas, O, t.wt[m.num_layers + 1], H, gh, hsz, R);   // g W_out^T
    __syncthreads();
    const float* hL = hs.p[m.num_layers];
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H, c = idx % H;
      const float h = row0 + r < n ? hL[(size_t)(row0 + r) * H + c] : 0.f;
      gh[r * hsz + c] *= nrt_dact(h, m.act);
    }
    __syncthreads();
    nrt_store_rows(gh, hsz, H, gh_out.p[m.num_layers], row0, R, n);
  } else {
    nrt_load_rows(gh, hsz, H, g_top, row0, R, n);
  }
  __syncthreads();

  for (int k = l1 - 1; k >= l0; --k) {
    const bool skip = (k % m.skip) == 0 && k != m.num_layers - 1;
    const int fan_in = skip ? H + E : H;
    nrt_mm(gh, hsz, H, t.wt[1 + k], fan_in, ga, gas, R);         // gH[k+1] W^T
    __syncthreads();
    const float* hk = hs.p[k];
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H, c = idx % H;
      const float h = row0 + r < n ? hk[(size_t)(row0 + r) * H + c] : 0.f;
      gh[r * hsz + c] = ga[r * gas + c] * nrt_dact(h, m.act);
    }
    if (skip)
      for (int idx = threadIdx.x; idx < R * E; idx += blockDim.x) {
        const int r = idx / E, e = idx % E;
        genc[r * es + e] += ga[r * gas + H + e];
      }
    __syncthreads();
    nrt_store_rows(gh, hsz, H, gh_out.p[k], row0, R, n);
  }

  if (genc_out) nrt_store_rows(genc, es, E, genc_out, row0, R, n);
  if (dx_out == nullptr) return;

  // init layer and the Fourier epilogue
  nrt_mm(gh, hsz, H, t.wt[0], E, ga, gas, R);                    // gH[0] W0^T
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * E; idx += blockDim.x) {
    const int r = idx / E, e = idx % E;
    const float* xr = xs + r * in;
    float v;
    if (e < in) {
      v = xr[e];
    } else {
      const int f = (e - in) % F;
      float mapped = 0.f;
      for (int d = 0; d < in; ++d) mapped = fmaf(xr[d], __ldg(m.B + d * F + f), mapped);
      v = e < in + F ? sinf(mapped) : cosf(mapped);
    }
    genc[r * es + e] = ga[r * gas + e] + genc[r * es + e] * nrt_dact(v, m.act);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * F; idx += blockDim.x) {
    const int r = idx / F, f = idx % F;
    const float* xr = xs + r * in;
    float mapped = 0.f;
    for (int d = 0; d < in; ++d) mapped = fmaf(xr[d], __ldg(m.B + d * F + f), mapped);
    ga[r * gas + f] = genc[r * es + in + f] * cosf(mapped) -
                      genc[r * es + in + F + f] * sinf(mapped);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * in; idx += blockDim.x) {
    const int r = idx / in, d = idx % in;
    if (row0 + r >= n) continue;
    float acc = genc[r * es + d];
    for (int f = 0; f < F; ++f) acc = fmaf(ga[r * gas + f], __ldg(m.B + d * F + f), acc);
    dx_out[(size_t)(row0 + r) * in + d] = acc;
  }
}

// ---- 3. dW = A^T G, split over rows -----------------------------------------
// A row = [act1(A1[row, :K1]), act2(A2[row, :K2]), 1 if bias]; dst is
// [K1 + K2 + bias, N] and must hold zeros (or a partial sum) on entry.
#define NRT_OT 64   // output tile
#define NRT_OS 16   // rows per stage

__device__ __forceinline__ float nrt_maybe_act(float v, int act) {
  return act < 0 ? v : nrt_act(v, act);
}

__global__ void __launch_bounds__(256)
nrt_mlp_outer_kernel(const float* __restrict__ A1, int lda1, int K1, int act1,
                     const float* __restrict__ A2, int lda2, int K2, int act2,
                     int bias, const float* __restrict__ G, int ldg, int N,
                     int n, int rows_per_slice, float* __restrict__ dst) {
  __shared__ __align__(16) float As[NRT_OS][NRT_OT];
  __shared__ __align__(16) float Gs[NRT_OS][NRT_OT];
  const int K = K1 + K2 + bias;
  const int j0 = blockIdx.x * NRT_OT, k0 = blockIdx.y * NRT_OT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r_begin = blockIdx.z * rows_per_slice;
  const int r_end = min(n, r_begin + rows_per_slice);
  float acc[4][4] = {};

  for (int rb = r_begin; rb < r_end; rb += NRT_OS) {
    for (int idx = threadIdx.x; idx < NRT_OS * NRT_OT; idx += blockDim.x) {
      const int rr = idx / NRT_OT, cc = idx % NRT_OT;
      const int row = rb + rr, k = k0 + cc, j = j0 + cc;
      float a = 0.f, g = 0.f;
      if (row < r_end) {
        if (k < K1)
          a = nrt_maybe_act(A1[(size_t)row * lda1 + k], act1);
        else if (k < K1 + K2)
          a = nrt_maybe_act(A2[(size_t)row * lda2 + (k - K1)], act2);
        else if (k < K)
          a = 1.f;
        if (j < N) g = G[(size_t)row * ldg + j];
      }
      As[rr][cc] = a;
      Gs[rr][cc] = g;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < NRT_OS; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&As[rr][ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&Gs[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], gv[q], acc[p][q]);
    }
    __syncthreads();
  }
  for (int p = 0; p < 4; ++p) {
    const int k = k0 + ty * 4 + p;
    if (k >= K) break;
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j < N) atomicAdd(dst + (size_t)k * N + j, acc[p][q]);
    }
  }
}

// ---- C interface -------------------------------------------------------------

static bool nrt_fill_layer_ptrs(LayerPtrs& out, int L, void* const* ptrs) {
  for (int k = 0; k <= NRT_MAX_LAYERS; ++k)
    out.p[k] = k <= L ? static_cast<float*>(ptrs[k]) : nullptr;
  return true;
}

extern "C" int nrt_mlp_store_forward(const float* x, const float* h_in, int l_start,
                                     int l_end, void* const* hs_ptrs, float* enc_out,
                                     int n, int in_size, int freqs, int hidden,
                                     int num_layers, int skip, int out_size, int act,
                                     const void* const* weights, void* stream) {
  MLPWeights m;
  LayerPtrs hs;
  if (n < 0 || !nrt_fill_weights(m, in_size, freqs, hidden, num_layers, skip,
                                 out_size, act, weights) ||
      l_start < 0 || l_end > num_layers || l_start > l_end ||
      (h_in == nullptr && l_start != 0))
    return (int)cudaErrorInvalidValue;
  nrt_fill_layer_ptrs(hs, num_layers, hs_ptrs);
  const int R = NRT_ROWS;
  const int E = in_size + 2 * freqs;
  const size_t smem = sizeof(float) *
      (nrt_round4(R * in_size) + (size_t)R * (nrt_round4(E) + 2 * nrt_round4(hidden)));
  cudaError_t err = cudaFuncSetAttribute(
      nrt_mlp_store_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  nrt_mlp_store_fwd_kernel<<<(n + R - 1) / R, NRT_THREADS, smem, (cudaStream_t)stream>>>(
      x, h_in, l_start, l_end, n, m, hs, enc_out);
  return (int)cudaGetLastError();
}

extern "C" int nrt_mlp_backward_layers(const float* x, const float* g_top, int top_mode,
                                       int l0, int l1, void* const* hs_ptrs,
                                       void* const* gh_ptrs,
                                       const void* const* wt_ptrs, float* genc_out,
                                       float* dx_out, int n, int in_size, int freqs,
                                       int hidden, int num_layers, int skip,
                                       int out_size, int act,
                                       const void* const* weights, void* stream) {
  MLPWeights m;
  LayerPtrs hs, gh;
  TWeights t;
  if (n < 0 || !nrt_fill_weights(m, in_size, freqs, hidden, num_layers, skip,
                                 out_size, act, weights) ||
      l0 < 0 || l1 > num_layers || l0 > l1 || (top_mode == 1 && l1 != num_layers) ||
      (dx_out != nullptr && l0 != 0))
    return (int)cudaErrorInvalidValue;
  nrt_fill_layer_ptrs(hs, num_layers, hs_ptrs);
  nrt_fill_layer_ptrs(gh, num_layers, gh_ptrs);
  for (int i = 0; i < NRT_MAX_LAYERS + 2; ++i)
    t.wt[i] = i < num_layers + 2 ? static_cast<const float*>(wt_ptrs[i]) : nullptr;
  const int R = NRT_BWD_ROWS;
  const int E = in_size + 2 * freqs;
  const size_t smem = sizeof(float) *
      (nrt_round4(R * in_size) +
       (size_t)R * (nrt_round4(hidden) + nrt_round4(hidden + E) + nrt_round4(E)));
  cudaError_t err = cudaFuncSetAttribute(
      nrt_mlp_bwd_layers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  nrt_mlp_bwd_layers_kernel<<<(n + R - 1) / R, NRT_THREADS, smem, (cudaStream_t)stream>>>(
      x, g_top, top_mode, l0, l1, n, m, t, hs, gh, genc_out, dx_out);
  return (int)cudaGetLastError();
}

extern "C" int nrt_mlp_outer(const float* A1, int lda1, int K1, int act1,
                             const float* A2, int lda2, int K2, int act2, int bias,
                             const float* G, int ldg, int N, int n, float* dst,
                             void* stream) {
  if (n < 0 || K1 < 0 || K2 < 0 || N <= 0 || (K2 > 0 && A2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int K = K1 + K2 + (bias ? 1 : 0);
  if (n == 0 || K == 0) return 0;
  const int tiles = ((N + NRT_OT - 1) / NRT_OT) * ((K + NRT_OT - 1) / NRT_OT);
  // about four waves of blocks over the 132 SMs, at least 256 rows a slice
  int slices = (528 + tiles - 1) / tiles;
  slices = max(1, min(slices, (n + 255) / 256));
  int rows = (n + slices - 1) / slices;
  rows = (rows + NRT_OS - 1) / NRT_OS * NRT_OS;
  slices = (n + rows - 1) / rows;
  dim3 grid((N + NRT_OT - 1) / NRT_OT, (K + NRT_OT - 1) / NRT_OT, slices);
  nrt_mlp_outer_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      A1, lda1, K1, act1, A2, lda2, K2, act2, bias ? 1 : 0, G, ldg, N, n, rows, dst);
  return (int)cudaGetLastError();
}
