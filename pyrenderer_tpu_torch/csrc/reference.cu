// The reference estimator's bounce (core/integrator.py trace_reference) as
// two kernels around its two queries (wrapper: kernels/reference.py):
//   reference_hit_kernel, after the closest-hit query: the hit geometry,
//     the emission of a light hit, the Lambert sample and the throughput,
//     the light point, the shadow ray, the NEE term its clearance would
//     add, and the next ray and interval;
//   reference_nee_kernel, after the any-hit query: that NEE term where the
//     shadow ray is clear.
//
// Replaces no TPU kernel: the JAX package's bounce is jnp ops that XLA
// fuses inside its lax.scan. Eager PyTorch has no such fusion, and the
// eager bounce is ~250 small launches whose host dispatch, and three host
// waits (sampling._axis), bound a pass. These kernels make a bounce four
// launches (the closest-hit query, reference_hit, the any-hit query,
// reference_nee), on CUDA float32 wavefronts that carry no gradient;
// everything else (CPU, float64, gradients, the debug records) runs the
// eager loop.
//
// What bounds them on this card: the launch. A live lane of reference_hit
// reads and writes ~180 bytes and does a few hundred fp32 operations (three
// Threefry evaluations among them); at 2^16 lanes that is ~12 MB, a few
// microseconds at 3.35 TB/s, near a launch's own cost. reference_nee moves
// 38 bytes a lane.
//
// The design: one thread a lane. A dead lane writes its zero shadow and
// next intervals and exits. The hit kernel draws its own uniforms
// (threefry.cuh) from the counter, with rng.py's use slots: the RNG is
// counter-based, so the values are the twin's wherever they are read. It
// writes the next ray over ro, rd and t1 (the closest query has read them)
// and the shadow ray into s_ro, s_rd, s_t1, which the any-hit query reads.
// The eager order holds: the emission is added before the NEE term, and
// the NEE term is beta after this bounce's update times the coupling. The
// hit kernel adds to the rays traced the lanes alive on entry and those
// alive after the hit (the eager loop's two counts), with one atomic a
// warp, of integer counts, exact below 2^24.
//
// Arithmetic follows the eager bounce operation for operation and with its
// functions (bounce.cuh): the result is the eager bounce's bit for bit on
// nearly every lane; the math library's sinf and cosf, compiled here
// without contraction and in PyTorch with it, may part in the last ulp on
// a few.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;

// flags: bit 0 the lane's shadow ray carries an NEE term (both cosines
// positive)
constexpr uint8_t kCandidate = 1;

// Add the warp's lanes with `a` and those with `b` to *n_rays: one atomic
// a warp. Every thread of the warp calls it.
__device__ __forceinline__ void count_lanes2(bool a, bool b, float* n_rays) {
  const int k = __popc(__ballot_sync(0xffffffffu, a)) + __popc(__ballot_sync(0xffffffffu, b));
  if ((threadIdx.x & 31) == 0 && k) atomicAdd(n_rays, (float)k);
}

// wide: bit 0 pixel, 1 sample, 2 tri, 3 light_nfaces are int64 (else int32).
// In: the closest query's hit and tri, the face rows (K >= 16, the base
// table of integrator.pack_face_data), the light table
// (integrator.pack_light_data, em the emitter's albedo) and light_nfaces,
// the light color (3), shadow_scale (1 - shadow_eps), t_max. In place:
// the rays ro, rd (N, 3; the next bounce's where the lane lives on), beta,
// radiance (N, 3), alive; out: t1 (the next closest query's interval:
// t_max where alive, else 0), the shadow ray s_ro, s_rd, s_t1 (0 where the
// lane is dead; ro and rd there), the NEE term nee (N, 3; candidates only)
// and flags. n_rays gets the lanes alive on entry and after the hit.
__global__ void __launch_bounds__(kThreads) reference_hit_kernel(
    int64_t n, Counter ctr, float* __restrict__ ro, float* __restrict__ rd,
    const bool* __restrict__ hit, const void* __restrict__ tri,
    const float* __restrict__ rows, int64_t row_stride, int gather,
    const float* __restrict__ light_data, int64_t light_stride,
    const void* __restrict__ light_nfaces, int n_lights, int f_max,
    const float* __restrict__ light_color, float shadow_scale, float t_max,
    float* __restrict__ beta, float* __restrict__ radiance, bool* __restrict__ alive,
    float* __restrict__ t1, float* __restrict__ s_ro, float* __restrict__ s_rd,
    float* __restrict__ s_t1, float* __restrict__ nee_out, uint8_t* __restrict__ flags,
    float* __restrict__ n_rays) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < n;
  const bool live = in && alive[i];
  const bool hit_i = live && hit[i];
  const float* row = hit_i ? face_row(rows, row_stride, gather, tri, ctr.wide & 4, i) : nullptr;
  const bool emissive = hit_i && row[13] > 0.5f;
  count_lanes2(live, hit_i && !emissive, n_rays);
  if (!in) return;
  const V3 o = load3(ro + 3 * i), d = load3(rd + 3 * i);
  if (hit_i) {
    // the hit geometry, re-derived from the face
    const Hit h = hit_geometry(o, d, row);
    const V3 b = load3(beta + 3 * i);
    if (emissive) {
      // reference tracing.py:129-139: the light color, weight 1 at bounce
      // 0 and the cosine after
      const float d1 = dot(neg(d), h.nrm);
      if (d1 > 0.0f) {
        const float w = ctr.bounce == 0 ? 1.0f : d1;
        store3(radiance + 3 * i,
               add(load3(radiance + 3 * i), scale(w, mul(load3(light_color), b))));
      }
    } else {
      // the Lambert cosine sample and the throughput (tracing.py:145-149:
      // attenuation * cos / pdf / pi, 0 where n . wi is 0)
      float u1, u2, pdf;
      ctr.uniform2(i, kBsdf0, &u1, &u2);
      const V3 wi = lambert_sample(h.nrm, u1, u2, &pdf);
      const float cos_wi = dot(h.nrm, wi);
      const float safe_pdf = pdf == 0.0f ? 1.0f : pdf;
      const float k = maximum(cos_wi, 0.0f) / safe_pdf * kInvPi;
      const V3 albedo = load3(row + 9);
      const V3 new_beta = cos_wi != 0.0f ? scale(k, albedo) : V3{0.0f, 0.0f, 0.0f};
      const V3 nb = mul(b, new_beta);
      store3(beta + 3 * i, nb);

      // NEE (tracing.py:92-108): one light point, the coupling
      // em * cos1 * cos2 / dist^2, a shadow ray ending a relative margin
      // short of the light
      const LightPoint lp = light_point(ctr, i, light_data, light_stride, light_nfaces,
                                        ctr.wide & 8, n_lights, f_max);
      const V3 to_light = sub(lp.p, h.p);
      const float dist_sq = maximum(dot(to_light, to_light), (float)1e-12);
      const float dist = sqrtf(dist_sq);
      const V3 w = {to_light.x / dist, to_light.y / dist, to_light.z / dist};
      const float dot1 = dot(h.nrm, w);
      const float dot2 = dot(lp.n, neg(w));
      uint8_t f = 0;
      if (dot1 > 0.0f && dot2 > 0.0f) {
        f = kCandidate;
        store3(nee_out + 3 * i, mul(nb, scale(dot1 * dot2 / dist_sq, lp.em)));
      }
      store3(s_ro + 3 * i, h.p);
      store3(s_rd + 3 * i, w);
      s_t1[i] = dist * shadow_scale;
      flags[i] = f;
      store3(ro + 3 * i, h.p);
      store3(rd + 3 * i, wi);
      t1[i] = t_max;
      return;
    }
  }
  // dead, escaped or on a light: the path ends, no shadow ray
  if (live) alive[i] = false;
  store3(s_ro + 3 * i, o);
  store3(s_rd + 3 * i, d);
  s_t1[i] = 0.0f;
  flags[i] = 0;
  t1[i] = 0.0f;
}

// In: flags, the any-hit query's occ, reference_hit_kernel's nee. In place:
// radiance gets nee where the lane is a candidate and its shadow ray clear.
__global__ void __launch_bounds__(kThreads) reference_nee_kernel(
    int64_t n, const uint8_t* __restrict__ flags, const bool* __restrict__ occ,
    const float* __restrict__ nee, float* __restrict__ radiance) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || !(flags[i] & kCandidate) || occ[i]) return;
  store3(radiance + 3 * i, add(load3(radiance + 3 * i), load3(nee + 3 * i)));
}

unsigned int blocks_for(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// The hit half of one reference bounce for n lanes; operands as
// reference_hit_kernel says, the counter's as Counter (bounce.cuh) says.
int pr_reference_hit(int64_t n, int bounce, uint32_t k0, int rounds, const void* pixel,
                     int64_t pixel_stride, const void* sample, int64_t sample_stride,
                     uint32_t sample_const, int wide, float* ro, float* rd, const bool* hit,
                     const void* tri, const float* rows, int64_t row_stride, int gather,
                     const float* light_data, int64_t light_stride, const void* light_nfaces,
                     int n_lights, int f_max, const float* light_color, float shadow_scale,
                     float t_max, float* beta, float* radiance, bool* alive, float* t1,
                     float* s_ro, float* s_rd, float* s_t1, float* nee, uint8_t* flags,
                     float* n_rays, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Counter ctr = {pixel, pixel_stride, sample, sample_stride, sample_const,
                       wide, k0, rounds, bounce};
  reference_hit_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      n, ctr, ro, rd, hit, tri, rows, row_stride, gather, light_data, light_stride,
      light_nfaces, n_lights, f_max, light_color, shadow_scale, t_max, beta, radiance, alive,
      t1, s_ro, s_rd, s_t1, nee, flags, n_rays);
  return (int)cudaGetLastError();
}

// The NEE half of one reference bounce; operands as reference_nee_kernel
// says.
int pr_reference_nee(int64_t n, const uint8_t* flags, const bool* occ, const float* nee,
                     float* radiance, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  reference_nee_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      n, flags, occ, nee, radiance);
  return (int)cudaGetLastError();
}

}  // extern "C"
