// Device SphereSDF sphere set shared by the fused march (fused_march.cu, K2),
// the fused silhouette min-scan (fused_minscan.cu, K3), the shadow march
// (fused_shadow.cu, K4) and the fused SDF (fused_sdf.cu, K5), so every
// kernel evaluates exactly the same field:
//   sd(p) = smooth_min_i(|T_i p - c_i| - r_i) + shift_mlp(p)
// The smooth-min is the clamped -log(max(sum exp(-k d), 1e-4)) / k of the
// reference, or the exact logsumexp form (stable = 1).  The shift MLP is the
// tiled net of mlp_tiled.cuh, or the device MLP of mlp.cuh in K5's route
// for a net off the tile.
#pragma once

#include "mlp.cuh"

struct SphereSet {
  const float* tfs;      // [n, 3, 3], identity already added
  const float* centers;  // [n, 3]
  const float* radii;    // [n]
  int n;
  float k;
  int stable;            // 1: exact logsumexp smooth-min; 0: clamped
};

// Shared floats the packed sphere set takes (13 per sphere, 16-byte padded).
__host__ __device__ inline int nrt_sphere_smem_floats(int n) { return nrt_round4(n * 13); }

// Packs the sphere set into shared memory: tfs row-major (9), center (3),
// radius (1) per sphere.  The caller synchronises before use.
__device__ inline void nrt_load_spheres(const SphereSet& S, float* sph) {
  for (int i = threadIdx.x; i < S.n; i += blockDim.x) {
    for (int c = 0; c < 9; ++c) sph[i * 13 + c] = S.tfs[i * 9 + c];
    for (int c = 0; c < 3; ++c) sph[i * 13 + 9 + c] = S.centers[i * 3 + c];
    sph[i * 13 + 12] = S.radii[i];
  }
}

// The smooth-min of the sphere set at row r of the points ps ([.][3]) -> sm[r],
// summed by tpr lanes of one warp (contiguous, a power of two, at most 32):
// lane `lane` takes every tpr-th sphere from `lane`, then the lanes' sums
// meet in a butterfly.  Every lane of the warp calls it.
__device__ __forceinline__ void nrt_sphere_row(const float* sph, int n_sph, float k,
                                               int stable, const float* ps, float* sm,
                                               int r, int lane, int tpr) {
  const float px = ps[r * 3 + 0], py = ps[r * 3 + 1], pz = ps[r * 3 + 2];
  float m = -INFINITY, s = 0.f;  // stable: running max of -k d and sum exp(-k d - m)
  for (int i = lane; i < n_sph; i += tpr) {
    const float* t = sph + i * 13;
    const float qx = t[0] * px + t[1] * py + t[2] * pz - t[9];
    const float qy = t[3] * px + t[4] * py + t[5] * pz - t[10];
    const float qz = t[6] * px + t[7] * py + t[8] * pz - t[11];
    const float d = sqrtf(qx * qx + qy * qy + qz * qz) - t[12];
    const float e = -k * d;
    if (stable) {
      if (e > m) {
        s = s * expf(m - e) + 1.f;
        m = e;
      } else {
        s += expf(e - m);
      }
    } else {
      s += expf(e);
    }
  }
  // reduce across the tpr lanes of this row (contiguous within a warp)
  for (int off = tpr / 2; off > 0; off /= 2) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    if (stable) {
      const float mm = fmaxf(m, m2);
      s = (m == -INFINITY ? 0.f : s * expf(m - mm)) +
          (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mm));
      m = mm;
    } else {
      s += s2;
    }
  }
  if (lane == 0)
    sm[r] = stable ? -(m + logf(s)) / k : -logf(fmaxf(s, 1e-4f)) / k;
}

// Smooth-min of the sphere set at the R points ps ([R][3]) -> sm[R].
// blockDim.x / R threads share a row (a power of two, at most 32, with
// R * (blockDim.x / R) == blockDim.x); each takes every tpr-th sphere.  With
// rows >= 0 only the rows [0, rows) are evaluated, each in the same order as
// with all R (rows a multiple of the rows a warp holds, 32 / tpr).
__device__ void nrt_sphere_min(const float* sph, int n_sph, float k,
                               int stable, const float* ps, float* sm, int R,
                               int rows = -1) {
  const int tpr = blockDim.x / R;
  const int r = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  if (rows >= 0 && r >= rows) return;   // whole warps
  nrt_sphere_row(sph, n_sph, k, stable, ps, sm, r, lane, tpr);
}

// The same for the rows [0, rows) with TPR lanes a row whatever rows (K4's
// order, and K5's on both routes: 32 rows of 256 threads): the block's threads take
// blockDim.x / TPR rows at a time, so a thin step keeps every thread busy
// (rows a multiple of the 32 / TPR rows of a warp).
template <int TPR>
__device__ void nrt_sphere_min_lanes(const float* sph, int n_sph, float k, int stable,
                                     const float* ps, float* sm, int rows) {
  const int per = blockDim.x / TPR;
  for (int r = threadIdx.x / TPR; r < rows; r += per)   // whole warps
    nrt_sphere_row(sph, n_sph, k, stable, ps, sm, r, threadIdx.x % TPR, TPR);
}
