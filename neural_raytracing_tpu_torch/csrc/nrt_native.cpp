// Native CPU ops for neural_raytracing_tpu_torch (the host C++/OpenMP
// library of ``neural_raytracing_tpu_torch/native``).
//
// Role parity with the reference's pytorch3d/csrc (KNN, point-mesh
// distances) and pytorch3d/pathtracer/scene.py (mesh_intersect /
// mesh_intersect_test, Moller-Trumbore over face chunks): host-side
// geometry utilities used for dataset generation, mesh-derived ground
// truth and diagnostics.  The device path has its own implementation in
// PyTorch (shapes/mesh.py); these ops serve the host where a Python loop
// would be prohibitive.  The code below is the JAX package's own host
// library, line for line, so the two give the same bits.
//
// Exposed as a plain C ABI for ctypes binding (no pybind11).
// Parallelized over rays/queries with OpenMP.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 sub(const Vec3 &a, const Vec3 &b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline Vec3 cross(const Vec3 &a, const Vec3 &b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float dot(const Vec3 &a, const Vec3 &b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline Vec3 normalize(const Vec3 &a) {
  float n = std::sqrt(dot(a, a));
  if (n < 1e-12f) return {0.f, 0.f, 0.f};
  return {a.x / n, a.y / n, a.z / n};
}
inline Vec3 load(const float *p) { return {p[0], p[1], p[2]}; }

constexpr float kEps = 1e-8f;

// Moller-Trumbore single ray/triangle intersection.
// Returns t (or -1), barycentric (u, v).
inline float ray_tri(const Vec3 &ro, const Vec3 &rd, const Vec3 &v0,
                     const Vec3 &v1, const Vec3 &v2, float *u_out,
                     float *v_out) {
  Vec3 e1 = sub(v1, v0);
  Vec3 e2 = sub(v2, v0);
  Vec3 pv = cross(rd, e2);
  float det = dot(e1, pv);
  if (std::fabs(det) < kEps) return -1.f;
  float inv_det = 1.f / det;
  Vec3 tv = sub(ro, v0);
  float u = dot(tv, pv) * inv_det;
  if (u < 0.f || u > 1.f) return -1.f;
  Vec3 qv = cross(tv, e1);
  float v = dot(rd, qv) * inv_det;
  if (v < 0.f || u + v > 1.f) return -1.f;
  float t = dot(e2, qv) * inv_det;
  if (t <= kEps) return -1.f;
  *u_out = u;
  *v_out = v;
  return t;
}

}  // namespace

extern "C" {

// Closest-hit intersection of R rays against F triangles.
//   rays    [R, 6] (origin ++ direction)
//   verts   [V, 3], faces [F, 3] int32
// outputs:
//   t       [R]   (inf where miss)
//   face    [R]   int32 (-1 where miss)
//   uv      [R,2] barycentric
//   normal  [R,3] geometric normal (faces the ray origin)
//   hit     [R]   uint8
void nrt_mesh_intersect(const float *rays, int64_t n_rays, const float *verts,
                        const int32_t *faces, int64_t n_faces, float max_t,
                        float *t_out, int32_t *face_out, float *uv_out,
                        float *normal_out, uint8_t *hit_out) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rays; ++r) {
    Vec3 ro = load(rays + 6 * r);
    Vec3 rd = load(rays + 6 * r + 3);
    float best_t = max_t;
    int32_t best_f = -1;
    float best_u = 0.f, best_v = 0.f;
    for (int64_t f = 0; f < n_faces; ++f) {
      Vec3 v0 = load(verts + 3 * faces[3 * f + 0]);
      Vec3 v1 = load(verts + 3 * faces[3 * f + 1]);
      Vec3 v2 = load(verts + 3 * faces[3 * f + 2]);
      float u, v;
      float t = ray_tri(ro, rd, v0, v1, v2, &u, &v);
      if (t > 0.f && t < best_t) {
        best_t = t;
        best_f = static_cast<int32_t>(f);
        best_u = u;
        best_v = v;
      }
    }
    bool hit = best_f >= 0;
    t_out[r] = hit ? best_t : std::numeric_limits<float>::infinity();
    face_out[r] = best_f;
    uv_out[2 * r] = best_u;
    uv_out[2 * r + 1] = best_v;
    Vec3 n = {0.f, 0.f, 0.f};
    if (hit) {
      Vec3 v0 = load(verts + 3 * faces[3 * best_f + 0]);
      Vec3 v1 = load(verts + 3 * faces[3 * best_f + 1]);
      Vec3 v2 = load(verts + 3 * faces[3 * best_f + 2]);
      n = normalize(cross(sub(v1, v0), sub(v2, v0)));
      // orient towards the ray origin
      if (dot(n, rd) > 0.f) n = {-n.x, -n.y, -n.z};
    }
    normal_out[3 * r] = n.x;
    normal_out[3 * r + 1] = n.y;
    normal_out[3 * r + 2] = n.z;
    hit_out[r] = hit ? 1 : 0;
  }
}

// Any-hit (shadow) test: writes 1 where the ray is NOT blocked before
// max_t[r].
void nrt_mesh_intersect_test(const float *rays, int64_t n_rays,
                             const float *verts, const int32_t *faces,
                             int64_t n_faces, const float *max_t,
                             uint8_t *not_blocked) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rays; ++r) {
    Vec3 ro = load(rays + 6 * r);
    Vec3 rd = load(rays + 6 * r + 3);
    float limit = max_t[r];
    uint8_t blocked = 0;
    for (int64_t f = 0; f < n_faces; ++f) {
      Vec3 v0 = load(verts + 3 * faces[3 * f + 0]);
      Vec3 v1 = load(verts + 3 * faces[3 * f + 1]);
      Vec3 v2 = load(verts + 3 * faces[3 * f + 2]);
      float u, v;
      float t = ray_tri(ro, rd, v0, v1, v2, &u, &v);
      if (t > 0.f && t < limit) {
        blocked = 1;
        break;
      }
    }
    not_blocked[r] = blocked ? 0 : 1;
  }
}

// Brute-force k-nearest-neighbors (role parity with csrc/knn).
//   points [N, 3], queries [Q, 3] -> idx [Q, k] int32, dist2 [Q, k]
void nrt_knn(const float *points, int64_t n_points, const float *queries,
             int64_t n_queries, int32_t k, int32_t *idx_out,
             float *dist_out) {
#pragma omp parallel for schedule(static)
  for (int64_t q = 0; q < n_queries; ++q) {
    Vec3 qp = load(queries + 3 * q);
    int32_t *idx = idx_out + q * k;
    float *dst = dist_out + q * k;
    for (int32_t j = 0; j < k; ++j) {
      idx[j] = -1;
      dst[j] = std::numeric_limits<float>::infinity();
    }
    for (int64_t p = 0; p < n_points; ++p) {
      Vec3 d = sub(load(points + 3 * p), qp);
      float d2 = dot(d, d);
      if (d2 < dst[k - 1]) {
        // insertion into the sorted top-k
        int32_t j = k - 1;
        while (j > 0 && dst[j - 1] > d2) {
          dst[j] = dst[j - 1];
          idx[j] = idx[j - 1];
          --j;
        }
        dst[j] = d2;
        idx[j] = static_cast<int32_t>(p);
      }
    }
  }
}

// Minimum distance from each ray to a point cloud (role parity with
// scene.py ray_point_dist / mesh_level_surfaces).
void nrt_ray_point_min_dist(const float *rays, int64_t n_rays,
                            const float *points, int64_t n_points,
                            float *dist_out) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rays; ++r) {
    Vec3 ro = load(rays + 6 * r);
    Vec3 rd = normalize(load(rays + 6 * r + 3));
    float best = std::numeric_limits<float>::infinity();
    for (int64_t p = 0; p < n_points; ++p) {
      Vec3 w = sub(load(points + 3 * p), ro);
      float along = dot(w, rd);
      if (along < 0.f) along = 0.f;  // clamp to the ray start
      Vec3 closest = {ro.x + along * rd.x, ro.y + along * rd.y,
                      ro.z + along * rd.z};
      Vec3 d = sub(load(points + 3 * p), closest);
      float d2 = dot(d, d);
      if (d2 < best) best = d2;
    }
    dist_out[r] = std::sqrt(best);
  }
}

int nrt_native_version() { return 1; }

}  // extern "C"
