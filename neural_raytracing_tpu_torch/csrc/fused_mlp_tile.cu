// K1 on the tiles: the fused Fourier-encode + SkipConnMLP forward of a net
// with in_size 3, hidden <= 256, freqs <= 128 and at most 32 layers (every
// fused net the port builds), and the kernel that packs its weights.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_mlp.py
// (_pallas_forward, body _build_kernel :44-91) in both compute dtypes; a net
// off these widths keeps the first kernel (fused_mlp.cu over mlp.cuh), which
// kernels/fused_mlp.py k1_route picks by shape before the launch.
//
// Bound on an H100: f32 FMA issue for K1 (2 x MACs a row at 67 TFLOP/s;
// 0.708 ms for the 16x256 weight net at 16,384 rows), the tensor cores and
// the elementwise work beside them (sin/cos, the activations, the
// roundings) for K1-bf16.  The first kernel gave a thread 8 rows of one
// output column and read each weight from L2 with a scalar load for 8 FMAs:
// 14-19 TFLOP/s.  This one runs the net on the tiles of mlp_tiled.cuh that
// the march kernels K2-K4 use (one code path, nrt_f32_net / nrt_bf16_net):
//   - a block owns NRT_K1_ROWS = 64 rows: the whole tile at NP 256, half
//     of the 128-row tile at NP 128 (with an activation buffer of that
//     size, so two blocks fit an SM: of 64 and 128 rows, 64 was as fast or
//     faster at every row count the main paths launch, on an H100);
//   - f32: each thread keeps an outer-product tile of 64 (32 at NP 128)
//     sums in registers and loads its operands from shared memory as
//     float4s; each layer's W streams once a block through shared memory
//     (cp.async, two buffers of 8 k-rows, 32 at NP 256), so a weight read
//     from L2 feeds 64 FMAs;
//   - bf16: mma.sync m16n8k16 over bf16 activations in shared memory, W^T
//     streamed in 64-k chunks.  K1's rounding, not the
//     march's: the init layer reads the rounded encoding and the skip
//     layers act() of the FLOAT32 encoding, rounded (the JAX kernel's
//     :77-84), so the encoding is computed a second time after the init
//     layer (cheap beside the layers; mlp.cuh does the same);
//   - the output layer: a thread per (row, column) of the out_size columns,
//     fmaf in ascending k, then the bias.
// Every f32 sum is the first kernel's: fmaf in ascending k (the h columns,
// then the encoding on a skip layer), the padded k rows adding exactly 0,
// then the bias; x.B by fmaf in ascending d with the same sinf / cosf; so
// K1's outputs equal the first kernel's bit for bit.
//
// The weights are packed once per net and version (kernels/fused_mlp.py
// tile_pack caches them on the module) by nrt_mlp_tile_pack, one launch
// that reads the module's [fan_in, fan_out] float32 arrays and writes the
// layout of mlp_tiled.cuh: f32 matrices [K][NP] with the columns in the
// order nrt_tiled_col gives, or bf16 W^T [NP][K], biases [NP], out w
// [out_size][NP] (bf16 values with bf16 operands), out b, B.
//
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include "mlp_tiled.cuh"

// k rows of W a chunk of the weight stream (two buffers).  Of the shapes
// tried on an H100 these were fastest: larger f32 chunks at NP 256 (fewer
// barriers for the weight net), none at NP 128 (where a larger ring costs
// the shift net its second block a SM), 64 k for bf16.
#define NRT_K1_F32_KC(NP) ((NP) == 256 ? 32 : NRT_F32_KC)
#define NRT_K1_BF16_KC 64
// rows a block
#define NRT_K1_ROWS 64

// out[row0 + r][j] = f(r, j) for the rows below n and the O columns.
template <int ROWS, typename Out>
__device__ __forceinline__ void nrt_tile_write(float* __restrict__ out, int n, int O, int row0,
                                               Out f) {
  for (int i = threadIdx.x; i < ROWS * O; i += blockDim.x) {
    const int r = i % ROWS, j = i / ROWS;
    if (row0 + r < n) out[(size_t)(row0 + r) * O + j] = f(r, j);
  }
}

// ---- K1: f32 -------------------------------------------------------------------

template <int NP, int M, int KC>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_mlp_tile_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int O,
                        const __grid_constant__ TiledNet m) {
  constexpr int TM = M / 16;
  extern __shared__ __align__(16) float smem[];
  typedef NrtStream<NP, false, KC> Stream;
  const NrtF32Tile<NP, Stream::RING, M> T(smem, m, 0);   // the points in the h rows
  Stream W;
  const int row0 = blockIdx.x * M;
  W.start(m, T.wbuf);
  nrt_f32_sdf_init(m, T);
  nrt_tile_rows<M>(x, n, row0, T.ps);
  __syncthreads();
  nrt_f32_net<NP, NrtF32Wide<NP, TM, M>>(m, T, W);
  nrt_tile_write<M>(out, n, O, row0, [&](int r, int j) { return nrt_f32_out(m, T, r, j); });
}

// ---- K1-bf16: the tensor cores ------------------------------------------------------

template <int NP, int MI>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_mlp_tile_bf16_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int O,
                         const __grid_constant__ TiledNet m) {
  constexpr int ROWS = 16 * MI * (nrt_tiled_rows(NP) / 64);
  extern __shared__ __align__(16) float smem[];
  typedef NrtStream<NP, true, NRT_K1_BF16_KC> Stream;
  const NrtBf16Tile<NP, Stream::RING> T(smem, m, 0);  // the points after the activations
  Stream W;
  const int row0 = blockIdx.x * ROWS;
  W.start(m, T.wbuf);
  nrt_bf16_pad_init(m, T);
  nrt_tile_rows<ROWS>(x, n, row0, T.ps);
  __syncthreads();
  nrt_bf16_net<NP, MI>(m, T, W, [&] {
    // the skip layers' operand: act() of the float32 encoding, rounded
    nrt_tiled_encode<ROWS>(m, T.ps, [&](int row, int c, float v) {
      T.act[(size_t)row * T.lda + NP + c] = __float2bfloat16_rn(nrt_act(v, m.act));
    });
  });
  nrt_tile_write<ROWS>(out, n, O, row0, [&](int r, int j) { return nrt_bf16_out(m, T, r, j); });
}

// ---- launch -----------------------------------------------------------------------

// The kernel for (bf16, NP), its dynamic shared memory and its rows.
struct NrtTileLaunch {
  void (*kernel)(const float*, float*, int, int, const TiledNet);
  size_t smem;
  int rows;
};

template <int NP>
static NrtTileLaunch nrt_tile_config(int bf16, int EP) {
  constexpr int M = NRT_K1_ROWS, MI = NRT_K1_ROWS / 16 / (nrt_tiled_rows(NP) / 64);
  static_assert(16 * MI * (nrt_tiled_rows(NP) / 64) == M, "a bf16 block's rows");
  typedef NrtStream<NP, false, NRT_K1_F32_KC(NP)> F32Stream;
  typedef NrtStream<NP, true, NRT_K1_BF16_KC> Bf16Stream;
  if (bf16)
    return NrtTileLaunch{nrt_mlp_tile_bf16_kernel<NP, MI>,
                         nrt_bf16_sdf_smem<NP, Bf16Stream::RING>(EP, 0), M};
  return NrtTileLaunch{nrt_mlp_tile_f32_kernel<NP, M, NRT_K1_F32_KC(NP)>,
                       nrt_f32_sdf_smem<NP, F32Stream::RING, M>(EP), M};
}

static NrtTileLaunch nrt_tile_config(int bf16, int NP, int EP) {
  return NP == 128 ? nrt_tile_config<128>(bf16, EP) : nrt_tile_config<256>(bf16, EP);
}

// weights: the packed table [B, init w, init b, layer 0 w, layer 0 b, ...,
// out w, out b].
extern "C" int nrt_mlp_tile_forward(const float* x, float* out, int n, int in_size, int freqs,
                                    int hidden, int num_layers, int skip, int out_size, int act,
                                    int bf16, const void* const* weights, void* stream) {
  TiledNet m;
  if (n < 0 || in_size != 3 || out_size <= 0 ||
      !nrt_tiled_fill(m, freqs, hidden, num_layers, skip, act, bf16, weights))
    return (int)cudaErrorInvalidValue;
  const NrtTileLaunch c = nrt_tile_config(bf16, m.NP, m.EP);
  return nrt_launch(c.kernel, (n + c.rows - 1) / c.rows, c.smem, stream, x, out, n, out_size,
                    m);
}

// The kernel for this net: info = [blocks per SM (its occupancy), rows a
// block, registers a thread, local memory a thread in bytes (spills),
// dynamic shared memory a block in bytes].  Returns a cudaError_t as int.
extern "C" int nrt_mlp_tile_info(int bf16, int freqs, int hidden, int* info) {
  if (freqs < 0 || freqs > 128 || hidden <= 0 || hidden > 256 || info == nullptr)
    return (int)cudaErrorInvalidValue;
  const int E = 3 + 2 * freqs, r = bf16 ? 16 : 8;
  const NrtTileLaunch c = nrt_tile_config(bf16, hidden <= 128 ? 128 : 256, (E + r - 1) / r * r);
  cudaError_t err = cudaFuncSetAttribute(
      c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  cudaFuncAttributes attr;
  int blocks = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, c.kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.kernel, NRT_THREADS,
                                                        c.smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = c.rows;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = (int)c.smem;
  return 0;
}

// ---- the pack ---------------------------------------------------------------------

// One slot of the table: 0 B, 2 l + 1 the matrix and 2 l + 2 the bias of
// layer l (0 = init, 1 + i = hidden layer i, L + 1 = out).
struct NrtPackNet {
  const float* src[2 * NRT_MAX_LAYERS + 5];
  void* dst[2 * NRT_MAX_LAYERS + 5];
  int F, H, L, skip, O, E, EP, NP, bf16;
};

// The value of element e of packed matrix l (< L + 1) from its [fan_in, H]
// source: row k of the activation buffer (h at [0, NP), the encoding at
// [NP, NP + EP)) that the layer reads, logical column j.
__device__ __forceinline__ float nrt_pack_w(const NrtPackNet& p, int l, int k, int j) {
  const float* w = p.src[2 * l + 1];
  if (j >= p.H) return 0.f;
  const bool skip = l > 0 && (l - 1) % p.skip == 0 && l - 1 != p.L - 1;
  const int k_h = l == 0 ? 0 : p.NP;   // the layer's first encoding row
  if (l > 0 && k < p.NP) return k < p.H ? w[(size_t)k * p.H + j] : 0.f;
  if (l > 0 && !skip) return 0.f;
  const int e = k - k_h;
  return e < p.E ? w[(size_t)((l == 0 ? 0 : p.H) + e) * p.H + j] : 0.f;
}

__global__ void nrt_mlp_tile_pack_kernel(const __grid_constant__ NrtPackNet p) {
  const int s = blockIdx.y, L = p.L;
  int count;
  if (s == 0) {
    count = 3 * p.F;
  } else if (s == 2 * (L + 1) + 1) {      // out w [O][NP]
    count = p.O * p.NP;
  } else if (s == 2 * (L + 1) + 2) {      // out b [O]
    count = p.O;
  } else if (s % 2 == 0) {                // a bias [NP]
    count = p.NP;
  } else {                                // a matrix [K][NP] or W^T [NP][K]
    const int l = (s - 1) / 2, i = l - 1;
    const int K = l == 0 ? p.EP : (i % p.skip == 0 && i != L - 1 ? p.NP + p.EP : p.NP);
    count = K * p.NP;
  }
  const float* src = p.src[s];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < count; e += gridDim.x * blockDim.x) {
    if (s == 0 || s == 2 * (L + 1) + 2) {
      static_cast<float*>(p.dst[s])[e] = src[e];
    } else if (s == 2 * (L + 1) + 1) {
      const int o = e / p.NP, k = e % p.NP;
      float v = k < p.H ? src[(size_t)k * p.O + o] : 0.f;
      if (p.bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      static_cast<float*>(p.dst[s])[e] = v;
    } else if (s % 2 == 0) {
      static_cast<float*>(p.dst[s])[e] = e < p.H ? src[e] : 0.f;
    } else {
      const int l = (s - 1) / 2;
      if (p.bf16) {                       // W^T: e = n K + k
        const int K = count / p.NP, nn = e / K, k = e % K;
        static_cast<__nv_bfloat16*>(p.dst[s])[e] = __float2bfloat16_rn(nrt_pack_w(p, l, k, nn));
      } else {                            // e = k NP + physical column
        const int k = e / p.NP, col = e % p.NP;
        static_cast<float*>(p.dst[s])[e] = nrt_pack_w(p, l, k, nrt_tiled_col(col));
      }
    }
  }
}

// src: the module's table [B, init w, init b, layer 0 w, layer 0 b, ..., out
// w, out b] (float32, [fan_in, fan_out]); dst: the packed table, the
// layout of kernels/fused_mlp.py tile_layout.
extern "C" int nrt_mlp_tile_pack(const void* const* src, void* const* dst, int freqs, int hidden,
                                 int num_layers, int skip, int out_size, int bf16,
                                 void* stream) {
  if (num_layers < 0 || num_layers > NRT_MAX_LAYERS || skip <= 0 || freqs < 0 ||
      freqs > 128 || hidden <= 0 || hidden > 256 || out_size <= 0)
    return (int)cudaErrorInvalidValue;
  NrtPackNet p;
  p.F = freqs;
  p.H = hidden;
  p.L = num_layers;
  p.skip = skip;
  p.O = out_size;
  p.E = 3 + 2 * freqs;
  const int r = bf16 ? 16 : 8;
  p.EP = (p.E + r - 1) / r * r;
  p.NP = hidden <= 128 ? 128 : 256;
  p.bf16 = bf16;
  const int slots = 2 * (num_layers + 2) + 1;
  for (int s = 0; s < slots; ++s) {
    p.src[s] = static_cast<const float*>(src[s]);
    p.dst[s] = dst[s];
  }
  // a row of blocks a slot: at most 64, a skip layer's matrix in a few passes
  const int most = (p.NP + p.EP) * p.NP;
  const int per_slot = (most + NRT_THREADS - 1) / NRT_THREADS;
  const dim3 grid(per_slot < 64 ? per_slot : 64, slots);
  nrt_mlp_tile_pack_kernel<<<grid, NRT_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
