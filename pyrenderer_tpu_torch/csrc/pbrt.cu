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
// atomic a warp, of integer counts, exact below 2^24; the hit kernel counts
// the same way the lanes each query tests (closest_rays, shadow_rays).
//
// Arithmetic follows the eager bounce operation for operation and with
// its functions (sqrtf, sinf, cosf, powf(u, 1/3) and IEEE division; the
// library builds with -fmad=false and no fast-math flag): each constant is
// the float of the double PyTorch takes, a dot product's sum is PyTorch's
// reduction order for three elements ((x0 + x2) + x1), and a cross product
// contracts as PyTorch's linalg.cross kernel does. The result is the eager
// bounce's bit for bit on nearly every lane; the math library's functions
// (sinf, cosf, powf), compiled here without contraction and in PyTorch
// with it, may part in the last ulp on a few. The helpers it shares with
// the reference estimator's bounce kernels (reference.cu) are bounce.cuh's.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;

// rng.py's use slots of the pbrt bounce alone (bounce.cuh has the shared ones)
constexpr int kBsdf2 = 6;       // U_BSDF_2: u3
constexpr int kRoulette = 11;   // U_RR

// scene/types.py's material codes
constexpr int kLambert = 0;
constexpr int kMetal = 2;

// core/bsdf.py's constants, each the float of the double PyTorch takes
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kThird = (float)(1.0 / 3.0);

// flags: bit 0 the lane is an NEE candidate, bit 1 its normal was flipped
// toward the ray (the geometric normal is -nrm)
constexpr uint8_t kCandidate = 1;
constexpr uint8_t kFlipped = 2;

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

// One live lane of pbrt_hit_kernel, its operands as the kernel's; returns
// whether the lane is an NEE candidate (a shadow ray with an open interval).
__device__ __forceinline__ bool hit_lane(
    int64_t i, const Counter& ctr, const float* __restrict__ ro, const float* __restrict__ rd,
    const bool* __restrict__ hit, const void* __restrict__ tri,
    const float* __restrict__ rows, int64_t row_stride, int gather,
    const float* __restrict__ light_data, int64_t light_stride,
    const void* __restrict__ light_nfaces, int n_lights, int f_max,
    const float* __restrict__ beta, float* __restrict__ radiance, bool* __restrict__ alive,
    const float* __restrict__ prev_pdf, const bool* __restrict__ prev_spec, float shadow_scale,
    float* __restrict__ s_ro, float* __restrict__ s_rd, float* __restrict__ s_t1,
    float* __restrict__ nrm_out, float* __restrict__ nee_out, uint8_t* __restrict__ flags) {
  const V3 o = load3(ro + 3 * i), d = load3(rd + 3 * i);
  if (!hit[i]) {
    // escaped: no emission, no shadow ray
    alive[i] = false;
    store3(s_ro + 3 * i, o);
    store3(s_rd + 3 * i, d);
    s_t1[i] = 0.0f;
    flags[i] = 0;
    return false;
  }

  const float* row = face_row(rows, row_stride, gather, tri, ctr.wide & 4, i);
  const bool emissive = row[13] > 0.5f;
  const int mat = (int)row[15];
  const float hit_pdf_a = row[21];

  // the hit geometry, re-derived from the face
  const Hit h = hit_geometry(o, d, row);
  const float t = h.t;
  const V3 p = h.p, nrm = h.nrm;
  const bool flip = h.flip;

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
    return false;
  }
  store3(s_ro + 3 * i, p);
  store3(nrm_out + 3 * i, nrm);
  uint8_t f = flip ? kFlipped : 0;
  V3 wl = d;
  float t1 = 0.0f;
  if (mat == kLambert) {
    // NEE: a uniform light prim, a uniform face of it, a sqrt-barycentric
    // point (integrator._sample_light_point)
    const LightPoint lp = light_point(ctr, i, light_data, light_stride, light_nfaces,
                                      ctr.wide & 8, n_lights, f_max);
    const V3 p2 = lp.p, n2 = lp.n, em = lp.em;
    const float pdf_a = lp.pdf_a;
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
  return (f & kCandidate) != 0;
}

// wide: bit 0 pixel, 1 sample, 2 tri, 3 light_nfaces are int64 (else int32).
// In: the rays ro, rd (N, 3), the closest query's hit and tri, the face
// rows (K >= 22, the extended table of integrator.pack_face_data), the
// light table (integrator.pack_light_data) and light_nfaces, beta (N, 3),
// prev_pdf, prev_spec. In place: radiance (N, 3), alive. Out: the shadow
// ray s_ro (the hit point of a live lane, else ro), s_rd, s_t1 (0 where
// the lane is no NEE candidate), the shading normal nrm (N, 3), the NEE
// term nee (N, 3) that a clear shadow ray adds (candidates only), flags.
// n_rays and closest_rays get the lanes alive on entry (those the closest
// query tested), shadow_rays the NEE candidates (those the any-hit query
// tests).
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
    float* __restrict__ n_rays, float* __restrict__ closest_rays,
    float* __restrict__ shadow_rays) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < n;
  const bool live = in && alive[i];
  count_lanes(live, n_rays);
  count_lanes(live, closest_rays);
  bool candidate = false;
  if (live) {
    candidate = hit_lane(i, ctr, ro, rd, hit, tri, rows, row_stride, gather, light_data,
                         light_stride, light_nfaces, n_lights, f_max, beta, radiance, alive,
                         prev_pdf, prev_spec, shadow_scale, s_ro, s_rd, s_t1, nrm_out, nee_out,
                         flags);
  } else if (in) {
    // dead: no emission, no shadow ray
    store3(s_ro + 3 * i, load3(ro + 3 * i));
    store3(s_rd + 3 * i, load3(rd + 3 * i));
    s_t1[i] = 0.0f;
    flags[i] = 0;
  }
  count_lanes(candidate, shadow_rays);
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
                float* nee, uint8_t* flags, float* n_rays, float* closest_rays,
                float* shadow_rays, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Counter ctr = {pixel, pixel_stride, sample, sample_stride, sample_const,
                       wide, k0, rounds, bounce};
  pbrt_hit_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      n, ctr, ro, rd, hit, tri, rows, row_stride, gather, light_data, light_stride,
      light_nfaces, n_lights, f_max, beta, radiance, alive, prev_pdf, prev_spec, shadow_scale,
      s_ro, s_rd, s_t1, nrm, nee, flags, n_rays, closest_rays, shadow_rays);
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
