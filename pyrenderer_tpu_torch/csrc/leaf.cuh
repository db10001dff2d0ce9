// Device helpers shared by the cluster-sweep (cluster.cu) and binned
// (binned.cu) kernels: the constants of the ClusterScene layout, the ray
// row, the slab test of a box, the Moeller-Trumbore and watertight
// triangle tests, the int64 (t, slot) key of a hit and its warp minimum.
//
// Arithmetic follows the plain twins operation for operation
// (accel/clusters.py _slab and _leaf, core/intersect.py _mt_terms,
// core/watertight.py watertight_terms). The build passes -fmad=false and
// no fast-math flag: no a*b - c*d is contracted into an FMA (the Dekker
// split of the watertight fallback depends on it) and every division is
// the IEEE quotient. min/max propagate NaN as torch.minimum does: padded
// clusters, bins and supercluster rows have all-NaN boxes and must never
// cross, which fminf/fmaxf (NaN-dropping) would let them do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kLane = 128;      // triangles per cluster = row stride
constexpr int kGroup = 16;      // clusters per supercluster
constexpr int kTriRows = 16;    // table rows per cluster (9 used)
constexpr float kMissT = 3.0e38f;
// float32(1 + gamma(3)) of accel/clusters.py SLAB_WIDEN
constexpr float kSlabWiden = 0x1.000006p+0f;
constexpr float kEdgeRelTol = 0x1p-22f;  // core/watertight.py _EDGE_REL_TOL
constexpr float kSplit = 4097.0f;        // Dekker split for float32

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t1;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int64_t i) {
  const float4 a = reinterpret_cast<const float4*>(rays)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(rays)[2 * i + 1];
  Ray r;
  r.ox = a.x; r.oy = a.y; r.oz = a.z;
  r.dx = a.w; r.dy = b.x; r.dz = b.y;
  r.t1 = b.z;
  r.ix = 1.0f / (r.dx == 0.0f ? 1e-20f : r.dx);
  r.iy = 1.0f / (r.dy == 0.0f ? 1e-20f : r.dy);
  r.iz = 1.0f / (r.dz == 0.0f ? 1e-20f : r.dz);
  return r;
}

// Slab test of the box b[0..5] = bmin|bmax (lanes 0..5 of a table row):
// accel/clusters.py _slab (the TPU's _box_slab) with NaN-propagating
// min/max. Also gives the box's entry distance t_near: once the box
// crossed, it still crosses under a smaller non-NaN bound b exactly when
// t_near <= b.
__device__ __forceinline__ bool slab_near(const float* __restrict__ b,
                                          const Ray& r, float t0, float bound,
                                          float* t_near_out) {
  const float lox = (b[0] - r.ox) * r.ix;
  const float loy = (b[1] - r.oy) * r.iy;
  const float loz = (b[2] - r.oz) * r.iz;
  const float hix = (b[3] - r.ox) * r.ix;
  const float hiy = (b[4] - r.oy) * r.iy;
  const float hiz = (b[5] - r.oz) * r.iz;
  const float t_near = nmax(nmax(nmin(lox, hix), nmin(loy, hiy)),
                            nmax(nmin(loz, hiz), t0));
  const float t_far =
      nmin(nmin(nmax(lox, hix), nmax(loy, hiy)), nmax(loz, hiz)) * kSlabWiden;
  *t_near_out = t_near;
  return t_near <= nmin(t_far, bound);
}

__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float t0, float bound) {
  float t_near;
  return slab_near(b, r, t0, bound, &t_near);
}

// One int64 key per hit: float bits << 32 | slot. t > t0 > 0, so the float
// bits order like the floats, and the minimum key is the minimum t with a
// tie to the lowest slot; a miss is pack_key(kMissT, -1).
__device__ __forceinline__ int64_t pack_key(float t, int32_t slot) {
  return (int64_t)(((uint64_t)__float_as_uint(t) << 32) | (uint32_t)slot);
}

// The minimum key of the warp, in every lane (all 32 lanes must call it).
__device__ __forceinline__ int64_t warp_min(int64_t key) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d /= 2) {
    const int64_t other = __shfl_xor_sync(kAll, key, d);
    key = other < key ? other : key;
  }
  return key;
}

// Moeller-Trumbore in the order of core/intersect.py _mt_terms; true when
// the triangle is hit at t0 < t < t1.
__device__ __forceinline__ bool mt_test(const float* __restrict__ c,
                                        const Ray& r, float t0, float t1,
                                        float* t_out) {
  const float v0x = c[0 * kLane], v0y = c[1 * kLane], v0z = c[2 * kLane];
  const float e1x = c[3 * kLane], e1y = c[4 * kLane], e1z = c[5 * kLane];
  const float e2x = c[6 * kLane], e2y = c[7 * kLane], e2z = c[8 * kLane];
  const float cx = e1y * r.dz - e1z * r.dy;
  const float cy = e1z * r.dx - e1x * r.dz;
  const float cz = e1x * r.dy - e1y * r.dx;
  const float det = cx * e2x + cy * e2y + cz * e2z;
  const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float qx = sy * e2z - sz * e2y;
  const float qy = sz * e2x - sx * e2z;
  const float qz = sx * e2y - sy * e2x;
  const float t = -inv * (qx * e1x + qy * e1y + qz * e1z);
  const float u = -inv * (qx * r.dx + qy * r.dy + qz * r.dz);
  const float v = inv * (cx * sx + cy * sy + cz * sz);
  *t_out = t;
  return fabsf(det) > 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
         1.0f - u - v >= 0.0f && t > t0 && t < t1;
}

// Per-ray constants of the watertight test (core/watertight.py
// watertight_terms): kz = the first axis of largest |d|, kx = kz + 1,
// ky = kz + 2 (mod 3), and the shear sx, sy, sz.
struct Shear {
  int kz;
  float sx, sy, sz;
};

__device__ __forceinline__ float pick(int k, float x, float y, float z) {
  return k == 0 ? x : (k == 1 ? y : z);
}

__device__ __forceinline__ Shear make_shear(const Ray& r) {
  const float ax = fabsf(r.dx), ay = fabsf(r.dy), az = fabsf(r.dz);
  Shear s;
  s.kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  const int kx = s.kz == 2 ? 0 : s.kz + 1;
  const int ky = kx == 2 ? 0 : kx + 1;
  const float d_x = pick(kx, r.dx, r.dy, r.dz);
  const float d_y = pick(ky, r.dx, r.dy, r.dz);
  const float d_z = pick(s.kz, r.dx, r.dy, r.dz);
  s.sx = -d_x / d_z;
  s.sy = -d_y / d_z;
  s.sz = 1.0f / d_z;
  return s;
}

__device__ __forceinline__ void shear_vertex(float vx, float vy, float vz,
                                             const Ray& r, const Shear& s,
                                             float* x, float* y, float* z) {
  const float tx = vx - r.ox, ty = vy - r.oy, tz = vz - r.oz;
  const int kx = s.kz == 2 ? 0 : s.kz + 1;
  const int ky = kx == 2 ? 0 : kx + 1;
  const float px = pick(kx, tx, ty, tz);
  const float py = pick(ky, tx, ty, tz);
  const float pz = pick(s.kz, tx, ty, tz);
  *x = px + s.sx * pz;
  *y = py + s.sy * pz;
  *z = pz;
}

// _two_product_err: fl(a*b) + err == a*b exactly (Dekker).
__device__ __forceinline__ void two_product(float a, float b, float* p,
                                            float* err) {
  *p = a * b;
  float ah = a * kSplit;
  ah = ah - (ah - a);
  const float al = a - ah;
  float bh = b * kSplit;
  bh = bh - (bh - b);
  const float bl = b - bh;
  *err = ((ah * bh - *p) + ah * bl + al * bh) + al * bl;
}

// core/watertight.py edge_fn: a*b - c*d, compensated where it cancels.
__device__ __forceinline__ float edge_fn(float a, float b, float c, float d) {
  const float p1 = a * b;
  const float p2 = c * d;
  const float e = p1 - p2;
  if (fabsf(e) <= (fabsf(p1) + fabsf(p2)) * kEdgeRelTol) {
    float q1, r1, q2, r2;
    two_product(a, b, &q1, &r1);
    two_product(c, d, &q2, &r2);
    return (q1 - q2) + (r1 - r2);
  }
  return e;
}

// The watertight test of core/watertight.py watertight_terms; true when the
// triangle is hit at t0 < t < t1.
__device__ __forceinline__ bool wt_test(const float* __restrict__ c,
                                        const Ray& r, const Shear& s,
                                        float t0, float t1, float* t_out) {
  const float v0x = c[0 * kLane], v0y = c[1 * kLane], v0z = c[2 * kLane];
  const float v1x = v0x + c[3 * kLane], v1y = v0y + c[4 * kLane],
              v1z = v0z + c[5 * kLane];
  const float v2x = v0x + c[6 * kLane], v2y = v0y + c[7 * kLane],
              v2z = v0z + c[8 * kLane];
  float x0, y0, z0, x1, y1, z1, x2, y2, z2;
  shear_vertex(v0x, v0y, v0z, r, s, &x0, &y0, &z0);
  shear_vertex(v1x, v1y, v1z, r, s, &x1, &y1, &z1);
  shear_vertex(v2x, v2y, v2z, r, s, &x2, &y2, &z2);
  const float e0 = edge_fn(x1, y2, y1, x2);
  const float e1 = edge_fn(x2, y0, y2, x0);
  const float e2 = edge_fn(x0, y1, y0, x1);
  const bool mixed = (e0 < 0.0f || e1 < 0.0f || e2 < 0.0f) &&
                     (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f);
  const float det = e0 + e1 + e2;
  const float t_scaled = e0 * (z0 * s.sz) + e1 * (z1 * s.sz) + e2 * (z2 * s.sz);
  const float t = t_scaled / (det == 0.0f ? 1.0f : det);
  *t_out = t;
  return !mixed && fabsf(det) > 0.0f && t > t0 && t < t1;
}

template <bool Watertight>
__device__ __forceinline__ bool tri_test(const float* __restrict__ c,
                                         const Ray& r, const Shear& s,
                                         float t0, float t1, float* t) {
  return Watertight ? wt_test(c, r, s, t0, t1, t) : mt_test(c, r, t0, t1, t);
}

inline unsigned int n_blocks(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

// Blocks of kThreads for one warp per item.
inline unsigned int warp_blocks(int64_t n) {
  constexpr int per_block = kThreads / kWarp;
  return (unsigned int)((n + per_block - 1) / per_block);
}

}  // namespace
