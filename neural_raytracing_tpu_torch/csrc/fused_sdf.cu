// K5: fused SphereSDF evaluation, one value per point.
//
// Replaces the TPU kernel neural_raytracing_tpu/kernels/fused_sdf.py
// (_pallas_forward / _build_kernel):
//   sd(p) = smooth_min_i(|T_i p - c_i| - r_i) + shift_mlp(p)
// with the clamped or the exact (stable) smooth-min: the inner evaluation
// of the loop kernels K2, K3 and K4, once per point.  Only the points are
// read and one float per point written; the transformed points ([points,
// spheres, 3] in the plain version) never leave the block.
// Bound on an H100: f32 FMA issue of the shift net (2 * 165,504 flops per
// point for the 8x128 net, beside 31 * 128 for the spheres).
//
// Two routes, picked by shape before the launch (kernels/fused_sdf.py
// k5_route):
//   - the tile (nrt_fused_sdf_tile): a shift net K1's tile takes (in_size
//     3, hidden <= 256, freqs <= 128) runs as K1's f32 kernel runs it
//     (fused_mlp_tile.cu): a block owns NRT_K5_ROWS = 64 points (K1's rows;
//     on an H100 32 points a block, four blocks an SM, was slower at both
//     10,000 and 65,536 points), each
//     thread an outer-product tile of sums in registers, each layer's W
//     streamed once a block through shared memory from the cached pack of
//     kernels/fused_mlp.py tile_pointers, the one K1-K4 read; the sphere set
//     and the points borrow the activation buffer's h rows, as in K2-K4;
//   - the general route (nrt_fused_sphere_sdf), the first kernel: 32 points
//     a block over the device MLP of mlp.cuh, each weight a scalar L2 load
//     for a few FMAs; for a net off the tile, or a sphere set the tile's h
//     rows cannot hold.
// Both take the spheres' smooth-min in the same order (8 lanes a row, K4's
// nrt_sphere_min_lanes) and the net's sums are the tile's (fmaf in
// ascending k, then the bias), so the two routes give the same bits.
// C interface for ctypes: returns a cudaError_t as int (0 = launched).
#include "mlp_tiled.cuh"

// ---- the general route ------------------------------------------------------------

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

// ---- the tile ------------------------------------------------------------------------

// k rows of W a chunk of the weight stream, and points a block: K1's
#define NRT_K5_KC(NP) ((NP) == 256 ? 32 : NRT_F32_KC)
#define NRT_K5_ROWS 64

template <int NP, int M, int KC>
__global__ void __launch_bounds__(NRT_THREADS, NP == 128 ? 2 : 1)
nrt_fused_sdf_tile_kernel(const float* __restrict__ p, float* __restrict__ out, int n,
                          SphereSet S, const __grid_constant__ TiledNet m) {
  constexpr int TM = M / 16;
  extern __shared__ __align__(16) float smem[];
  typedef NrtStream<NP, false, KC> Stream;
  const NrtF32Tile<NP, Stream::RING, M> T(smem, m, S.n);
  Stream W;
  const int row0 = blockIdx.x * M;
  W.start(m, T.wbuf);
  nrt_f32_sdf_init(m, T);
  nrt_load_spheres(S, T.sph);
  nrt_tile_rows<M>(p, n, row0, T.ps);
  __syncthreads();
  // the general route's order: 8 lanes a row (the net's first barrier
  // orders these reads of the h rows before its first store there)
  nrt_sphere_min_lanes<8>(T.sph, S.n, S.k, S.stable, T.ps, T.sm, M);
  nrt_f32_net<NP, NrtF32Wide<NP, TM, M>>(m, T, W);
  for (int r = threadIdx.x; r < M; r += blockDim.x)
    if (row0 + r < n) out[row0 + r] = T.sm[r] + nrt_f32_out(m, T, r);
}

struct NrtK5Launch {
  void (*kernel)(const float*, float*, int, SphereSet, const TiledNet);
  size_t smem;
};

template <int NP>
static NrtK5Launch nrt_k5_config(int EP) {
  typedef NrtStream<NP, false, NRT_K5_KC(NP)> Stream;
  return NrtK5Launch{nrt_fused_sdf_tile_kernel<NP, NRT_K5_ROWS, NRT_K5_KC(NP)>,
                     nrt_f32_sdf_smem<NP, Stream::RING, NRT_K5_ROWS>(EP)};
}

static NrtK5Launch nrt_k5_config(int NP, int EP) {
  return NP == 128 ? nrt_k5_config<128>(EP) : nrt_k5_config<256>(EP);
}

// The sphere set and the points fit the h rows of a tile (as
// kernels/fused_sdf.py k5_tile_spheres says).
static bool nrt_k5_fits(int NP, int n_spheres) {
  return nrt_sphere_smem_floats(n_spheres) + 3 * NRT_K5_ROWS <= NP * (NRT_K5_ROWS + 4);
}

// weights: the packed table of fused_mlp_tile.cu's pack kernel (f32).
extern "C" int nrt_fused_sdf_tile(const float* p, float* out, int n, const float* tfs,
                                  const float* centers, const float* radii, int n_spheres,
                                  float k, int stable, int freqs, int hidden, int num_layers,
                                  int skip, int act, const void* const* weights, void* stream) {
  TiledNet m;
  if (n < 0 || n_spheres <= 0 ||
      !nrt_tiled_fill(m, freqs, hidden, num_layers, skip, act, 0, weights) ||
      !nrt_k5_fits(m.NP, n_spheres))
    return (int)cudaErrorInvalidValue;
  const NrtK5Launch c = nrt_k5_config(m.NP, m.EP);
  return nrt_launch(c.kernel, (n + NRT_K5_ROWS - 1) / NRT_K5_ROWS, c.smem, stream, p, out, n,
                    SphereSet{tfs, centers, radii, n_spheres, k, stable}, m);
}

// The tile kernel for these widths: info = [blocks per SM (its occupancy),
// registers a thread, local memory a thread in bytes, dynamic shared memory
// a block in bytes].  Returns a cudaError_t as int.
extern "C" int nrt_fused_sdf_tile_info(int freqs, int hidden, int* info) {
  if (freqs < 0 || freqs > 128 || hidden <= 0 || hidden > 256 || info == nullptr)
    return (int)cudaErrorInvalidValue;
  const NrtK5Launch c = nrt_k5_config(hidden <= 128 ? 128 : 256, (3 + 2 * freqs + 7) / 8 * 8);
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
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)c.smem;
  return 0;
}
