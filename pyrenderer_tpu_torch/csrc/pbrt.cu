// The pbrt estimator's bounce (core/integrator_pbrt.py trace_pbrt) as two
// kernels around its two queries (wrapper: kernels/pbrt.py):
//   pbrt_hit_kernel, after the closest-hit query: the hit geometry, the
//     emission with its MIS weight, the light point and the shadow ray;
//   pbrt_scatter_kernel, after the any-hit query: the NEE term of a clear
//     shadow ray, the lane's BSDF sampler, the throughput, Russian
//     roulette and the next ray.
//
// Replaces no TPU kernel: the JAX package's bounce is jnp ops that XLA
// fuses inside its lax.scan. Eager PyTorch has no such fusion, and the
// eager bounce is ~400 small launches whose host dispatch, not the device,
// bounds a pass. These kernels make a bounce four launches (B1, pbrt_hit,
// B2, pbrt_scatter), on CUDA float32 wavefronts that carry no gradient;
// everything else runs the eager loop.
//
// What bounds them on this card: the launch. A lane reads and writes ~200
// bytes and does a few hundred fp32 operations (two or three Threefry
// evaluations among them); at 2^16 lanes that is ~13 MB or ~20 MFLOP, a
// few microseconds at 3.35 TB/s, near a launch's own cost.
//
// The design: one thread a lane. A dead lane writes its zero shadow
// interval and its unchanged state, and exits. Each kernel draws its own
// uniforms (threefry.cuh) from the counter (pixel, (sample << 12) |
// (bounce << 4) | use), with rng.py's use slots, and only those its lane
// uses: the RNG is counter-based, so the values are the twin's wherever
// they are read. Likewise only the lane's own sampler runs (lambert, metal
// or glass), where the eager bounce computes all three on every lane and
// selects. Both kernels add their live lanes to the rays traced with one
// atomic a warp, of integer counts, exact below 2^24.
//
// Arithmetic follows the eager bounce operation for operation and with
// its functions (sqrtf, sinf, cosf, powf(u, 1/3) and IEEE division; the
// library builds with -fmad=false and no fast-math flag): each constant is
// the float of the double PyTorch takes, a dot product's sum is PyTorch's
// reduction order for three elements ((x0 + x2) + x1), and a cross product
// contracts as PyTorch's linalg.cross kernel does. The result is the eager
// bounce's bit for bit on nearly every lane; the math library's functions
// (sinf, cosf, powf), compiled here without contraction and in PyTorch
// with it, may part in the last ulp on a few.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// rng.py's use slots
constexpr int kBsdf0 = 4;       // U_BSDF_0: (u1, u2)
constexpr int kBsdf2 = 6;       // U_BSDF_2: u3
constexpr int kLightPrim = 7;   // U_LIGHT_PRIM
constexpr int kLightFace = 8;   // U_LIGHT_FACE
constexpr int kLightU = 9;      // U_LIGHT_U: (u, v)
constexpr int kRoulette = 11;   // U_RR

// scene/types.py's material codes
constexpr int kLambert = 0;
constexpr int kMetal = 2;

// core/sampling.py's constants, each the float of the double PyTorch takes
constexpr double kPiD = 3.141592653589793;
constexpr float kInvPi = (float)(1.0 / kPiD);
constexpr float kPi4 = (float)(kPiD / 4);
constexpr float kPi2 = (float)(kPiD / 2);
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kAxisEps = (float)1e-6;

// flags: bit 0 the lane is an NEE candidate, bit 1 its normal was flipped
// toward the ray (the geometric normal is -nrm)
constexpr uint8_t kCandidate = 1;
constexpr uint8_t kFlipped = 2;

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

// bsdf.power_heuristic
__device__ __forceinline__ float power_heuristic(float pf, float pg) {
  const float f2 = pf * pf;
  const float g2 = pg * pg;
  return f2 / maximum(f2 + g2, (float)1e-20);
}

// bsdf.reflect: v - (2 (v . n)) n
__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  return sub(v, scale(2.0f * dot(v, n), n));
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

// bsdf.metal_sample: the mirror direction plus roughness times a point in
// the unit ball (bsdf.point_in_unit_sphere), normalised; ok where it
// leaves the surface
__device__ __forceinline__ V3 metal_sample(V3 rd, V3 n, float roughness, float u1, float u2,
                                           float u3, bool* ok) {
  const float cos_t = 1.0f - 2.0f * u1;
  const float sin_t = safe_sqrt(1.0f - cos_t * cos_t);
  const float phi = kTwoPi * u2;
  const float r = powf(u3, kThird);
  const float rs = r * sin_t;
  const V3 ball = {rs * cosf(phi), rs * sinf(phi), r * cos_t};
  const V3 wi = safe_normalize(add(reflect(rd, n), scale(roughness, ball)));
  *ok = dot(wi, n) > 0.0f;
  return wi;
}

// bsdf.dielectric_sample: Snell refraction (bsdf.refract), or reflection
// where it cannot refract or the Schlick draw (bsdf.schlick) chooses it;
// n is the geometric normal before any flip
__device__ __forceinline__ V3 dielectric_sample(V3 rd, V3 n, float ior, float u) {
  const bool front = dot(rd, n) < 0.0f;
  const V3 n_eff = front ? n : neg(n);
  const float eta = front ? 1.0f / ior : ior;
  const float cos_theta = minimum(dot(neg(rd), n_eff), 1.0f);
  const float sin_theta = safe_sqrt(1.0f - cos_theta * cos_theta);
  const bool cannot_refract = eta * sin_theta > 1.0f;
  float r0 = (1.0f - eta) / (1.0f + eta);
  r0 = r0 * r0;
  const float schlick = r0 + (1.0f - r0) * powf(1.0f - cos_theta, 5.0f);
  V3 wi;
  if (cannot_refract | (u < schlick)) {
    wi = reflect(rd, n_eff);
  } else {
    const float cos_r = minimum(dot(neg(rd), n_eff), 1.0f);
    const V3 perp = scale(eta, add(rd, scale(cos_r, n_eff)));
    const float par = -safe_sqrt(fabsf(1.0f - dot(perp, perp)));
    wi = add(perp, scale(par, n_eff));
  }
  return safe_normalize(wi);
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

// wide: bit 0 pixel, 1 sample, 2 tri, 3 light_nfaces are int64 (else int32).
// In: the rays ro, rd (N, 3), the closest query's hit and tri, the face
// rows (K >= 22, the extended table of integrator.pack_face_data), the
// light table (integrator.pack_light_data) and light_nfaces, beta (N, 3),
// prev_pdf, prev_spec. In place: radiance (N, 3), alive. Out: the shadow
// ray s_ro (the hit point of a live lane, else ro), s_rd, s_t1 (0 where
// the lane is no NEE candidate), the shading normal nrm (N, 3), the NEE
// term nee (N, 3) that a clear shadow ray adds (candidates only), flags.
// n_rays gets the lanes alive on entry.
__global__ void __launch_bounds__(kThreads) pbrt_hit_kernel(
    int64_t n, Counter ctr, const float* __restrict__ ro, const float* __restrict__ rd,
    const bool* __restrict__ hit, const void* __restrict__ tri,
    const float* __restrict__ rows, int64_t row_stride, int gather,
    const float* __restrict__ light_data, int64_t light_stride,
    const void* __restrict__ light_nfaces, int n_lights, int f_max,
    const float* __restrict__ beta, float* __restrict__ radiance, bool* __restrict__ alive,
    const float* __restrict__ prev_pdf, const bool* __restrict__ prev_spec, float shadow_scale,
    float* __restrict__ s_ro, float* __restrict__ s_rd, float* __restrict__ s_t1,
    float* __restrict__ nrm_out, float* __restrict__ nee_out, uint8_t* __restrict__ flags,
    float* __restrict__ n_rays) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < n;
  const bool live = in && alive[i];
  count_lanes(live, n_rays);
  if (!in) return;
  const V3 o = load3(ro + 3 * i), d = load3(rd + 3 * i);
  if (!live || !hit[i]) {
    // dead, or escaped: no emission, no shadow ray
    if (live) alive[i] = false;
    store3(s_ro + 3 * i, o);
    store3(s_rd + 3 * i, d);
    s_t1[i] = 0.0f;
    flags[i] = 0;
    return;
  }

  const float* row = face_row(rows, row_stride, gather, tri, ctr.wide & 4, i);
  const V3 v0 = load3(row), e1 = load3(row + 3), e2 = load3(row + 6);
  const float sign = row[12];
  const bool emissive = row[13] > 0.5f;
  const bool sided = row[14] > 0.5f;
  const int mat = (int)row[15];
  const float hit_pdf_a = row[21];

  // the hit geometry, re-derived from the face
  const float det = dot(cross(e1, d), e2);
  const float safe_det = det == 0.0f ? 1.0f : det;
  const V3 s = sub(o, v0);
  const float t = -dot(cross(s, e2), e1) / safe_det;
  const V3 p = add(o, scale(t, d));
  const V3 n_geo = scale(sign, safe_normalize(cross(e1, e2)));
  const bool flip = !sided && dot(n_geo, neg(d)) < 0.0f;
  const V3 nrm = flip ? neg(n_geo) : n_geo;

  // emission with MIS against the light sampler
  const float cos_l = dot(neg(d), nrm);
  if (emissive && cos_l > 0.0f) {
    float w_mis = 1.0f;
    if (ctr.bounce != 0 && !prev_spec[i]) {
      const float dist_sq_hit = maximum(t * t, (float)1e-12);
      const float pdf_light_sa = hit_pdf_a * dist_sq_hit / maximum(cos_l, (float)1e-6);
      w_mis = power_heuristic(prev_pdf[i], pdf_light_sa);
    }
    const V3 em = load3(row + 16);
    const V3 b = load3(beta + 3 * i);
    store3(radiance + 3 * i, add(load3(radiance + 3 * i), scale(w_mis, mul(em, b))));
  }
  if (emissive) {
    alive[i] = false;
    store3(s_ro + 3 * i, o);
    store3(s_rd + 3 * i, d);
    s_t1[i] = 0.0f;
    flags[i] = 0;
    return;
  }
  store3(s_ro + 3 * i, p);
  store3(nrm_out + 3 * i, nrm);
  uint8_t f = flip ? kFlipped : 0;
  V3 wl = d;
  float t1 = 0.0f;
  if (mat == kLambert) {
    // NEE: a uniform light prim, a uniform face of it, a sqrt-barycentric
    // point (integrator._sample_light_point)
    int64_t li = 0;
    if (n_lights > 1) {
      const float up = ctr.uniform(i, kLightPrim);
      li = (int64_t)(up * (float)n_lights);
      li = li < 0 ? 0 : (li > n_lights - 1 ? n_lights - 1 : li);
    }
    const int64_t nfaces = (ctr.wide & 8) ? ((const int64_t*)light_nfaces)[li]
                                          : (int64_t)((const int32_t*)light_nfaces)[li];
    const float uf = ctr.uniform(i, kLightFace);
    int64_t fi = (int64_t)(uf * (float)nfaces);
    fi = fi < 0 ? 0 : fi;
    fi = fi < nfaces - 1 ? fi : nfaces - 1;
    const float* lrow = light_data + (li * f_max + fi) * light_stride;
    const V3 l0 = load3(lrow), l1 = load3(lrow + 3), l2 = load3(lrow + 6);
    const V3 em = load3(lrow + 9);
    const float lsign = lrow[12];
    const float pdf_a = lrow[13];
    float u, v;
    ctr.uniform2(i, kLightU, &u, &v);
    const float su = sqrtf(u);
    const float a = su * (1.0f - v);
    const float b = su * v;
    const V3 p2 = add(add(scale(a, l0), scale(b, l1)), scale(1.0f - a - b, l2));
    const V3 n2 = scale(lsign, safe_normalize(cross(sub(l1, l0), sub(l2, l0))));

    const V3 to_light = sub(p2, p);
    const float dist_sq = maximum(dot(to_light, to_light), (float)1e-12);
    const float dist = sqrtf(dist_sq);
    wl = {to_light.x / dist, to_light.y / dist, to_light.z / dist};
    const float cos_surf = dot(nrm, wl);
    const float cos_light = dot(n2, neg(wl));
    if (cos_surf > 0.0f && cos_light > 0.0f) {
      f |= kCandidate;
      t1 = dist * shadow_scale;
      const float pdf_nee_sa = pdf_a * dist_sq / maximum(cos_light, (float)1e-6);
      // bsdf.lambert_pdf: cos_surf > 0 here
      const float w_nee = power_heuristic(pdf_nee_sa, cos_surf * kInvPi);
      const V3 albedo = load3(row + 9);
      const float k = w_nee * cos_surf / maximum(pdf_nee_sa, (float)1e-12);
      const V3 contrib = scale(k, mul(scale(kInvPi, albedo), em));
      store3(nee_out + 3 * i, mul(load3(beta + 3 * i), contrib));
    }
  }
  store3(s_rd + 3 * i, wl);
  s_t1[i] = t1;
  flags[i] = f;
}

// In: the counter, the face rows as pbrt_hit_kernel took them, the any-hit
// query's occ, pbrt_hit_kernel's s_ro (the hit point), nrm, nee and flags,
// roulette (Russian roulette runs at this bounce), t_max. In place: ro, rd,
// beta, radiance, alive; out: prev_pdf, prev_spec, t1 (the next closest
// query's interval: t_max where alive, else 0). n_rays gets the lanes
// alive on entry (the shadow rays the eager bounce counts).
__global__ void __launch_bounds__(kThreads) pbrt_scatter_kernel(
    int64_t n, Counter ctr, const void* __restrict__ tri, const float* __restrict__ rows,
    int64_t row_stride, int gather, const bool* __restrict__ occ,
    const float* __restrict__ s_ro, const float* __restrict__ nrm_in,
    const float* __restrict__ nee, const uint8_t* __restrict__ flags,
    float* __restrict__ ro, float* __restrict__ rd, float* __restrict__ beta,
    float* __restrict__ radiance, bool* __restrict__ alive, float* __restrict__ prev_pdf,
    bool* __restrict__ prev_spec, float* __restrict__ t1, int roulette, float t_max,
    float* __restrict__ n_rays) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < n;
  const bool live = in && alive[i];
  count_lanes(live, n_rays);
  if (!in) return;
  if (!live) {
    t1[i] = 0.0f;
    return;
  }
  const uint8_t f = flags[i];
  if ((f & kCandidate) && !occ[i]) {
    store3(radiance + 3 * i, add(load3(radiance + 3 * i), load3(nee + 3 * i)));
  }

  const float* row = face_row(rows, row_stride, gather, tri, ctr.wide & 4, i);
  const V3 albedo = load3(row + 9);
  const int mat = (int)row[15];
  const V3 nrm = load3(nrm_in + 3 * i);
  const V3 d = load3(rd + 3 * i);

  V3 wi, sc;
  float pdf = 1.0f;
  bool ok = true;
  if (mat == kLambert) {
    float u1, u2;
    ctr.uniform2(i, kBsdf0, &u1, &u2);
    wi = lambert_sample(nrm, u1, u2, &pdf);
    sc = albedo;
  } else if (mat == kMetal) {
    float u1, u2;
    ctr.uniform2(i, kBsdf0, &u1, &u2);
    const float u3 = ctr.uniform(i, kBsdf2);
    wi = metal_sample(d, nrm, row[20], u1, u2, u3, &ok);
    sc = scale(ok ? 1.0f : 0.0f, albedo);
  } else {
    // every face that is neither lambert nor metal scatters as clear glass
    const float u3 = ctr.uniform(i, kBsdf2);
    wi = dielectric_sample(d, (f & kFlipped) ? neg(nrm) : nrm, row[19], u3);
    sc = {1.0f, 1.0f, 1.0f};
  }
  V3 b = mul(load3(beta + 3 * i), sc);
  bool still = ok;
  if (roulette && still) {
    const float u_rr = ctr.uniform(i, kRoulette);
    const float m = fmaxf(fmaxf(b.x, b.y), b.z);
    const float amax = isnan(b.x) | isnan(b.y) | isnan(b.z) ? nanf("") : m;
    const float p_cont = minimum(maximum(amax, 0.05f), 1.0f);
    still = u_rr < p_cont;
    if (still) b = scale(1.0f / p_cont, b);
  }
  store3(beta + 3 * i, b);
  alive[i] = still;
  prev_pdf[i] = pdf;
  prev_spec[i] = mat != kLambert;
  if (still) {
    store3(ro + 3 * i, load3(s_ro + 3 * i));
    store3(rd + 3 * i, wi);
  }
  t1[i] = still ? t_max : 0.0f;
}

unsigned int blocks_for(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// The hit half of one pbrt bounce for n lanes; operands as pbrt_hit_kernel
// says, the counter's as Counter says.
int pr_pbrt_hit(int64_t n, int bounce, uint32_t k0, int rounds, const void* pixel,
                int64_t pixel_stride, const void* sample, int64_t sample_stride,
                uint32_t sample_const, int wide, const float* ro, const float* rd,
                const bool* hit, const void* tri, const float* rows, int64_t row_stride,
                int gather, const float* light_data, int64_t light_stride,
                const void* light_nfaces, int n_lights, int f_max, const float* beta,
                float* radiance, bool* alive, const float* prev_pdf, const bool* prev_spec,
                float shadow_scale, float* s_ro, float* s_rd, float* s_t1, float* nrm,
                float* nee, uint8_t* flags, float* n_rays, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Counter ctr = {pixel, pixel_stride, sample, sample_stride, sample_const,
                       wide, k0, rounds, bounce};
  pbrt_hit_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      n, ctr, ro, rd, hit, tri, rows, row_stride, gather, light_data, light_stride,
      light_nfaces, n_lights, f_max, beta, radiance, alive, prev_pdf, prev_spec, shadow_scale,
      s_ro, s_rd, s_t1, nrm, nee, flags, n_rays);
  return (int)cudaGetLastError();
}

// The scatter half of one pbrt bounce; operands as pbrt_scatter_kernel says.
int pr_pbrt_scatter(int64_t n, int bounce, uint32_t k0, int rounds, const void* pixel,
                    int64_t pixel_stride, const void* sample, int64_t sample_stride,
                    uint32_t sample_const, int wide, const void* tri, const float* rows,
                    int64_t row_stride, int gather, const bool* occ, const float* s_ro,
                    const float* nrm, const float* nee, const uint8_t* flags, float* ro,
                    float* rd, float* beta, float* radiance, bool* alive, float* prev_pdf,
                    bool* prev_spec, float* t1, int roulette, float t_max, float* n_rays,
                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Counter ctr = {pixel, pixel_stride, sample, sample_stride, sample_const,
                       wide, k0, rounds, bounce};
  pbrt_scatter_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      n, ctr, tri, rows, row_stride, gather, occ, s_ro, nrm, nee, flags, ro, rd, beta,
      radiance, alive, prev_pdf, prev_spec, t1, roulette, t_max, n_rays);
  return (int)cudaGetLastError();
}

}  // extern "C"
