// Device helpers of the two estimators' bounce kernels (pbrt.cu, reference.cu):
// the counter draws, three-vector arithmetic in PyTorch's order, the hit
// geometry, the Lambert sample, the light point and the face-row gather.
//
// Arithmetic follows the eager bounces operation for operation (the library
// builds with -fmad=false and no fast-math flag): each constant is the float
// of the double PyTorch takes, a dot product's sum is PyTorch's reduction
// order for three elements ((x0 + x2) + x1), and a cross product contracts
// as PyTorch's linalg.cross kernel does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// rng.py's use slots
constexpr int kBsdf0 = 4;       // U_BSDF_0: (u1, u2)
constexpr int kLightPrim = 7;   // U_LIGHT_PRIM
constexpr int kLightFace = 8;   // U_LIGHT_FACE
constexpr int kLightU = 9;      // U_LIGHT_U: (u, v)

// core/sampling.py's constants, each the float of the double PyTorch takes
constexpr double kPiD = 3.141592653589793;
constexpr float kInvPi = (float)(1.0 / kPiD);
constexpr float kPi4 = (float)(kPiD / 4);
constexpr float kPi2 = (float)(kPiD / 2);
constexpr float kAxisEps = (float)1e-6;

// The counter operands of one launch: the pixel (per lane, int32 or int64
// by `wide` bit 0, stride 0 for one broadcast value), the sample (per lane
// by `wide` bit 1, or null and folded into sample_const), the key and the
// rounds.
struct Counter {
  const void* pixel;
  int64_t pixel_stride;
  const void* sample;
  int64_t sample_stride;
  uint32_t sample_const;
  int wide;
  uint32_t k0;
  int rounds;
  int bounce;

  // both words of the lane's draw in use slot `use`
  __device__ __forceinline__ void words(int64_t i, int use, uint32_t* w0, uint32_t* w1) const {
    uint32_t c1 = sample_const;
    if (sample) c1 |= word(sample, sample_stride, wide & 2, i) << 12;
    c1 |= (uint32_t)bounce << 4;
    c1 |= (uint32_t)use;
    threefry2x32(k0, word(pixel, pixel_stride, wide & 1, i), c1, rounds, w0, w1);
  }

  __device__ __forceinline__ float uniform(int64_t i, int use) const {
    uint32_t w0, w1;
    words(i, use, &w0, &w1);
    return to_unit(w0);
  }

  __device__ __forceinline__ void uniform2(int64_t i, int use, float* u0, float* u1) const {
    uint32_t w0, w1;
    words(i, use, &w0, &w1);
    *u0 = to_unit(w0);
    *u1 = to_unit(w1);
  }
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }

// torch.sum(x, dim=-1) over three elements: PyTorch's reduction splits a
// row of three between two threads (x0 + x2 and x1) and adds their sums
__device__ __forceinline__ float sum3(V3 a) { return (a.x + a.z) + a.y; }

// _dot: the products, then their sum
__device__ __forceinline__ float dot(V3 a, V3 b) { return sum3(mul(a, b)); }

// a * b - c * d as torch.linalg.cross's kernel computes it (PyTorch builds
// with contraction: the first product is fused into the subtraction of the
// rounded second)
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {cross_term(a.y, b.z, a.z, b.y), cross_term(a.z, b.x, a.x, b.z),
          cross_term(a.x, b.y, a.y, b.x)};
}

// torch.maximum / torch.minimum against a constant: NaN propagates
__device__ __forceinline__ float maximum(float x, float c) { return isnan(x) ? x : fmaxf(x, c); }
__device__ __forceinline__ float minimum(float x, float c) { return isnan(x) ? x : fminf(x, c); }

// sampling.safe_sqrt
__device__ __forceinline__ float safe_sqrt(float x) { return x <= 0.0f ? 0.0f : sqrtf(x); }

// sampling.safe_normalize: v * (1 / sqrt(|v|^2)), 0 where |v| = 0
__device__ __forceinline__ V3 safe_normalize(V3 v) {
  const float ss = sum3(mul(v, v));
  const bool zero = ss == 0.0f;
  const float inv = 1.0f / sqrtf(zero ? 1.0f : ss);
  const float k = zero ? 0.0f : inv;
  return {v.x * k, v.y * k, v.z * k};
}

// bsdf.lambert_sample: the cosine-weighted direction in the frame of nrm
// (sampling.concentric_sample_disk, cosine_sample_hemisphere, rotate_z_to
// with make_frame's special cases at n ~ +-y) and its pdf
__device__ __forceinline__ V3 lambert_sample(V3 n, float u1, float u2, float* pdf) {
  const float ox = 2.0f * u1 - 1.0f;
  const float oy = 2.0f * u2 - 1.0f;
  const bool use_x = fabsf(ox) > fabsf(oy);
  const float r = use_x ? ox : oy;
  const float safe_ox = ox == 0.0f ? 1.0f : ox;
  const float safe_oy = oy == 0.0f ? 1.0f : oy;
  const float theta = use_x ? kPi4 * (oy / safe_ox) : kPi2 - kPi4 * (ox / safe_oy);
  const bool zero = (ox == 0.0f) & (oy == 0.0f);
  const float dx = zero ? 0.0f : r * cosf(theta);
  const float dy = zero ? 0.0f : r * sinf(theta);
  const float dz = safe_sqrt(1.0f - dx * dx - dy * dy);

  const bool neg_y = fabsf(n.y + 1.0f) < kAxisEps;
  const bool pos_y = fabsf(n.y - 1.0f) < kAxisEps;
  const V3 n_frame = pos_y ? V3{0.0f, 1.0f, 0.0f} : (neg_y ? V3{-0.0f, -1.0f, -0.0f} : n);
  const bool axis = pos_y | neg_y;
  const V3 gx = safe_normalize({-n.z, 0.0f, n.x});
  const V3 gz = safe_normalize(cross(gx, n));
  const V3 x_hat = axis ? V3{1.0f, 0.0f, 0.0f} : gx;
  const V3 z_hat = axis ? V3{0.0f, 0.0f, 1.0f} : gz;
  const V3 world = add(add(scale(dx, x_hat), scale(dy, z_hat)), scale(dz, n_frame));
  const V3 wi = safe_normalize(world);
  *pdf = fabsf(dot(n, wi)) * kInvPi;
  return wi;
}

// Add the warp's lanes with `live` to *n_rays: one atomic a warp. Every
// thread of the warp calls it.
__device__ __forceinline__ void count_lanes(bool live, float* n_rays) {
  const unsigned int mask = __ballot_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0 && mask) atomicAdd(n_rays, (float)__popc(mask));
}

// The face row of lane i: a gather from the (T, K) face table by the hit id
// (clamped at 0, int32 or int64 by wide_tri) or, where gather is 0, the
// lane's own row of an (N, K) table (TraceTables.fetch_face_fn's rows).
__device__ __forceinline__ const float* face_row(const float* rows, int64_t row_stride,
                                                 int gather, const void* tri, bool wide_tri,
                                                 int64_t i) {
  if (!gather) return rows + i * row_stride;
  int64_t f = wide_tri ? ((const int64_t*)tri)[i] : (int64_t)((const int32_t*)tri)[i];
  return rows + (f < 0 ? 0 : f) * row_stride;
}

// integrator._hit_geometry on a packed face row (v0|e1|e2 in columns 0-8,
// the normal's sign in 12, sided in 14): the distance t, the hit point p,
// the geometric normal with the face's sign, and that normal turned to face
// the ray on one-sided faces (flip: it was turned).
struct Hit {
  float t;
  V3 p, n_geo, nrm;
  bool flip;
};

__device__ __forceinline__ Hit hit_geometry(V3 o, V3 d, const float* row) {
  const V3 v0 = load3(row), e1 = load3(row + 3), e2 = load3(row + 6);
  const float sign = row[12];
  const bool sided = row[14] > 0.5f;
  Hit h;
  const float det = dot(cross(e1, d), e2);
  const float safe_det = det == 0.0f ? 1.0f : det;
  const V3 s = sub(o, v0);
  h.t = -dot(cross(s, e2), e1) / safe_det;
  h.p = add(o, scale(h.t, d));
  h.n_geo = scale(sign, safe_normalize(cross(e1, e2)));
  h.flip = !sided && dot(h.n_geo, neg(d)) < 0.0f;
  h.nrm = h.flip ? neg(h.n_geo) : h.n_geo;
  return h;
}

// integrator._sample_light_point for lane i: a uniform light prim (drawn
// only where there is more than one), a uniform face of it, a
// sqrt-barycentric point, from the light table (integrator.pack_light_data:
// v0|v1|v2|em|sign|pdf_A) of n_lights lights of f_max rows each and their
// face counts light_nfaces (int64 where `wide_nfaces`, else int32). The
// point p, its normal n, the table's em and the area pdf.
struct LightPoint {
  V3 p, n, em;
  float pdf_a;
};

__device__ __forceinline__ LightPoint light_point(const Counter& ctr, int64_t i,
                                                  const float* light_data, int64_t light_stride,
                                                  const void* light_nfaces, bool wide_nfaces,
                                                  int n_lights, int f_max) {
  int64_t li = 0;
  if (n_lights > 1) {
    const float up = ctr.uniform(i, kLightPrim);
    li = (int64_t)(up * (float)n_lights);
    li = li < 0 ? 0 : (li > n_lights - 1 ? n_lights - 1 : li);
  }
  const int64_t nfaces = wide_nfaces ? ((const int64_t*)light_nfaces)[li]
                                     : (int64_t)((const int32_t*)light_nfaces)[li];
  const float uf = ctr.uniform(i, kLightFace);
  int64_t fi = (int64_t)(uf * (float)nfaces);
  fi = fi < 0 ? 0 : fi;
  fi = fi < nfaces - 1 ? fi : nfaces - 1;
  const float* lrow = light_data + (li * f_max + fi) * light_stride;
  const V3 l0 = load3(lrow), l1 = load3(lrow + 3), l2 = load3(lrow + 6);
  float u, v;
  ctr.uniform2(i, kLightU, &u, &v);
  const float su = sqrtf(u);
  const float a = su * (1.0f - v);
  const float b = su * v;
  LightPoint lp;
  lp.p = add(add(scale(a, l0), scale(b, l1)), scale(1.0f - a - b, l2));
  lp.n = scale(lrow[12], safe_normalize(cross(sub(l1, l0), sub(l2, l0))));
  lp.em = load3(lrow + 9);
  lp.pdf_a = lrow[13];
  return lp;
}

}  // namespace
