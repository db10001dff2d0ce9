// Binned (bin, ray) pair traversal for Hopper (sm_90a): the candidate-bin
// prepass, the peel of further candidates, and the closest-hit leaf over
// sorted pairs, resident and streamed.
//
// Replaces the four TPU kernels of pyrenderer_tpu/kernels/pallas_binned.py:
//   pr_binned_prepass       -> _prepass_kernel (:167, via _prepass_call)
//   pr_binned_peel          -> _peel_kernel (:216, via _peel_call)
//   pr_binned_leaf          -> _leaf_kernel (:236, via _leaf_call)
//   pr_binned_leaf_streamed -> _leaf_kernel_streamed (:439, via
//                              _leaf_call_streamed)
//
// A bin is kBin adjacent clusters (512 triangles, accel/clusters.py BIN).
// The prepass slab-tests each ray against every bin box and keeps the first
// W crossing bins in ascending order; kernels/binned.py sorts the (bin, ray)
// pairs by bin, and the leaf tests each pair's ray against the bin's 512
// triangles. On the TPU the prepass worked on 128-ray tiles with rays in
// lanes, extracted set bits with a vectorised ctz, and the leaf packed
// (t | index in bin) into one int32 key so that min and argmin were one
// lane reduction. Here each thread owns one ray (prepass, peel) and each
// warp one pair (leaf), bits are peeled with __ffs as soon as a 32-bin word
// is formed, and the leaf's result is the exact float32 t with its slot,
// written as one int64 key (float bits << 32 | slot) that the per-ray
// reduce takes the minimum of: t > t0 > 0, so the float bits order like the
// floats.
//
// What bounds each kernel on this card:
// - prepass: per ray, (bins padded to 32) slab tests of ~20 flops against
//   boxes staged in shared memory (224 boxes, 5.25 KiB at terrain100k);
//   compute, and one pass over the ray rows.
// - peel: per ray, n_words words read and written; memory, tiny.
// - leaf: per pair, kBin x 128 triangle tests of ~60 (MT) or ~75
//   (watertight) fp32 operations; the table is read from L1/L2 (the pairs
//   arrive sorted by bin), so the operations bound it. The first port ran
//   one thread per pair, 512 dependent tests in a serial loop: the 71,755
//   pairs of the terrain100k bounce-1 wavefront gave ~17 warps an SM, too
//   few to hide each test's latency, and divergent rays made the watertight
//   test select every sheared vertex (pick) and divide for every triangle.
//
// The leaf's design (both variants): one warp per pair, lanes over the
// bin's triangles. Lane l tests triangles l, l + 32, l + 64 and l + 96 of
// each of the bin's 4 clusters, so each table row is one coalesced
// 128-byte read per warp and the ray one broadcast; each lane keeps its
// best key and the warp takes the minimum with __shfl_xor_sync (warp_min),
// as the cluster sweep's leaf does (cluster.cu). Triangles are accepted
// against the ray's t1, never a running best, so the key minimum keeps the
// lowest slot among equal t whatever the lanes' order: the keys are those
// of the thread-per-pair kernel bit for bit. In a warp the ray, and so the
// watertight shear's axis kz, is uniform: the test is instantiated once per
// kz (lane_key_wt) without selects, runs the plain arithmetic of two
// triangles before any branch, and divides only where the edges agree and
// det != 0. The resident leaf reads the (K*16, 128) table; the
// streamed leaf gives each CUDA block one bin's run of at most 16 sorted
// pairs (kernels/binned.py blocks_for, RUN_PAIRS), copies the bin's 4 x 9 x
// 128 floats (18,432 bytes) into shared memory with cp.async (what the
// TPU's scalar-prefetched index-map DMA did), and its 4 warps take the
// run's pairs in turn.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "leaf.cuh"

namespace {

constexpr int kBin = 4;                    // clusters per bin (accel/clusters.py BIN)
constexpr int32_t kSentinel = 0x7FFFFFFF;  // an empty candidate slot (kernels/binned.py SENTINEL)
constexpr int kStageBoxes = 512;           // bin boxes staged in shared memory per pass
constexpr int kBoxFloats = 6;              // bmin.xyz | bmax.xyz
constexpr int kBinFloats = kBin * 9 * kLane;  // one bin's triangle rows v0|e1|e2

// Moves the lowest set bits of `bits` (word w of a ray's crossing bits)
// into ids[*filled .. w_slots) as bin ids, ascending; returns the bits left.
__device__ __forceinline__ uint32_t peel_word(uint32_t bits, int w,
                                              int32_t* __restrict__ ids,
                                              int w_slots, int* filled) {
  while (bits != 0u && *filled < w_slots) {
    ids[(*filled)++] = w * 32 + (__ffs(bits) - 1);
    bits &= bits - 1u;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
binned_prepass_kernel(const float* __restrict__ bin_box, int n_words,
                      const float* __restrict__ rays, float t0, int64_t n,
                      int w_slots, int32_t* __restrict__ ids_out,
                      bool* __restrict__ ovf_out,
                      int32_t* __restrict__ words_out) {
  __shared__ float sbox[kStageBoxes * kBoxFloats];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const Ray r = live ? load_ray(rays, i) : Ray{};
  int32_t* ids = ids_out + i * w_slots;
  int filled = 0;
  bool left = false;
  const int n_boxes = n_words * 32;
  for (int base = 0; base < n_boxes; base += kStageBoxes) {
    const int count = min(kStageBoxes, n_boxes - base);
    __syncthreads();
    for (int k = threadIdx.x; k < count * kBoxFloats; k += blockDim.x) {
      const int b = k / kBoxFloats;
      sbox[k] = bin_box[(int64_t)(base + b) * kLane + (k - b * kBoxFloats)];
    }
    __syncthreads();
    if (!live) continue;
    for (int wl = 0; wl < count / 32; ++wl) {
      const int w = base / 32 + wl;
      uint32_t bits = 0u;
      for (int b = 0; b < 32; ++b) {
        if (slab(sbox + (wl * 32 + b) * kBoxFloats, r, t0, r.t1)) bits |= 1u << b;
      }
      bits = peel_word(bits, w, ids, w_slots, &filled);
      left |= bits != 0u;
      if (words_out != nullptr) words_out[i * n_words + w] = (int32_t)bits;
    }
  }
  if (!live) return;
  for (int s = filled; s < w_slots; ++s) ids[s] = kSentinel;
  ovf_out[i] = left;
}

__global__ void __launch_bounds__(kThreads)
binned_peel_kernel(const int32_t* __restrict__ words_in, int n_words,
                   int64_t n, int w_slots, int32_t* __restrict__ ids_out,
                   bool* __restrict__ ovf_out,
                   int32_t* __restrict__ words_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t* ids = ids_out + i * w_slots;
  int filled = 0;
  bool left = false;
  for (int w = 0; w < n_words; ++w) {
    const uint32_t bits = peel_word((uint32_t)words_in[i * n_words + w], w,
                                    ids, w_slots, &filled);
    left |= bits != 0u;
    words_out[i * n_words + w] = (int32_t)bits;
  }
  for (int s = filled; s < w_slots; ++s) ids[s] = kSentinel;
  ovf_out[i] = left;
}

constexpr int kSteps = kLane / kWarp;  // triangles per lane in a cluster
// triangles whose plain arithmetic a lane runs before any branch: their
// independent chains hide each other's latency (4 take too many registers)
constexpr int kBatch = 2;

// The watertight test of leaf.cuh's wt_test with the shear's axes fixed at
// compile time (kz = KZ, the ray's make_shear(r).kz, the same for the whole
// warp): the same operations in the same order, so the same bits, without
// pick()'s selects. shear_kz is shear_vertex; wt_vertices the sheared
// vertices of the triangle at c.
template <int KZ>
__device__ __forceinline__ void shear_kz(float vx, float vy, float vz,
                                         const Ray& r, const Shear& s,
                                         float* x, float* y, float* z) {
  constexpr int KX = KZ == 2 ? 0 : KZ + 1;
  constexpr int KY = KX == 2 ? 0 : KX + 1;
  const float tx = vx - r.ox, ty = vy - r.oy, tz = vz - r.oz;
  const float pz = pick(KZ, tx, ty, tz);
  *x = pick(KX, tx, ty, tz) + s.sx * pz;
  *y = pick(KY, tx, ty, tz) + s.sy * pz;
  *z = pz;
}

template <int KZ>
__device__ __forceinline__ void wt_vertices(const float* __restrict__ c,
                                            const Ray& r, const Shear& s,
                                            float* x, float* y, float* z) {
  const float v0x = c[0 * kLane], v0y = c[1 * kLane], v0z = c[2 * kLane];
  const float v1x = v0x + c[3 * kLane], v1y = v0y + c[4 * kLane],
              v1z = v0z + c[5 * kLane];
  const float v2x = v0x + c[6 * kLane], v2y = v0y + c[7 * kLane],
              v2z = v0z + c[8 * kLane];
  shear_kz<KZ>(v0x, v0y, v0z, r, s, &x[0], &y[0], &z[0]);
  shear_kz<KZ>(v1x, v1y, v1z, r, s, &x[1], &y[1], &z[1]);
  shear_kz<KZ>(v2x, v2y, v2z, r, s, &x[2], &y[2], &z[2]);
}

// edge_fn's uncompensated a*b - c*d; sets *fix where edge_fn compensates.
__device__ __forceinline__ float edge_plain(float a, float b, float c, float d,
                                            bool* fix) {
  const float p1 = a * b;
  const float p2 = c * d;
  const float e = p1 - p2;
  *fix |= fabsf(e) <= (fabsf(p1) + fabsf(p2)) * kEdgeRelTol;
  return e;
}

// The best key of one lane over triangles lane, lane + 32, lane + 64 and
// lane + 96 of each of a bin's kBin clusters (cluster ci's rows at tri +
// ci * stride, row stride kLane; `first` the bin's first slot), watertight.
// Each of a cluster's rows is one coalesced 128-byte read (or a
// conflict-free shared-memory read) per warp. The lane runs the plain edge
// values of kBatch triangles straight through, then per triangle the rare
// branches: edge_fn's compensated values (vertices re-read) where an edge
// cancels, and the quotient t_scaled / det only where the edges agree and
// det != 0 (a ray crosses about one of a bin's triangles).
template <int KZ>
__device__ __forceinline__ int64_t lane_key_wt(const float* __restrict__ tri,
                                               int stride, int first, int lane,
                                               const Ray& r, const Shear& s,
                                               float t0) {
  int64_t key = pack_key(kMissT, -1);
  for (int ci = 0; ci < kBin; ++ci) {
    const float* cl = tri + ci * stride + lane;
#pragma unroll
    for (int k0 = 0; k0 < kSteps; k0 += kBatch) {
      float e[kBatch][3], z[kBatch][3];
      bool fix[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        float x[3], y[3];
        wt_vertices<KZ>(cl + (k0 + b) * kWarp, r, s, x, y, z[b]);
        fix[b] = false;
        e[b][0] = edge_plain(x[1], y[2], y[1], x[2], &fix[b]);
        e[b][1] = edge_plain(x[2], y[0], y[2], x[0], &fix[b]);
        e[b][2] = edge_plain(x[0], y[1], y[0], x[1], &fix[b]);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (fix[b]) {
          float x[3], y[3];
          wt_vertices<KZ>(cl + (k0 + b) * kWarp, r, s, x, y, z[b]);
          e[b][0] = edge_fn(x[1], y[2], y[1], x[2]);
          e[b][1] = edge_fn(x[2], y[0], y[2], x[0]);
          e[b][2] = edge_fn(x[0], y[1], y[0], x[1]);
        }
        const float e0 = e[b][0], e1 = e[b][1], e2 = e[b][2];
        const bool mixed = (e0 < 0.0f || e1 < 0.0f || e2 < 0.0f) &&
                           (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f);
        const float det = e0 + e1 + e2;
        if (mixed || !(fabsf(det) > 0.0f)) continue;
        const float t_scaled = e0 * (z[b][0] * s.sz) + e1 * (z[b][1] * s.sz) +
                               e2 * (z[b][2] * s.sz);
        const float t = t_scaled / det;
        if (t > t0 && t < r.t1) {
          const int64_t hit = pack_key(t, first + ci * kLane + (k0 + b) * kWarp + lane);
          key = hit < key ? hit : key;
        }
      }
    }
  }
  return key;
}

// lane_key_wt with Moeller-Trumbore leaves (leaf.cuh mt_test).
__device__ __forceinline__ int64_t lane_key_mt(const float* __restrict__ tri,
                                               int stride, int first, int lane,
                                               const Ray& r, float t0) {
  int64_t key = pack_key(kMissT, -1);
  for (int ci = 0; ci < kBin; ++ci) {
    const float* cl = tri + ci * stride + lane;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      float t;
      if (mt_test(cl + k * kWarp, r, t0, r.t1, &t)) {
        const int64_t hit = pack_key(t, first + ci * kLane + k * kWarp + lane);
        key = hit < key ? hit : key;
      }
    }
  }
  return key;
}

// The closest hit of one ray over the kBin x 128 triangles of `bin`, by the
// whole warp (every lane calls it with the same ray): the minimum key, in
// every lane. Triangles are accepted against the ray's t1, so the key
// minimum is the minimum t with a tie to the lowest slot, in whatever order
// the lanes test them; a miss, and a dead ray (t1 <= t0, or NaN), give
// pack_key(kMissT, -1).
template <bool Watertight>
__device__ __forceinline__ int64_t bin_key(const float* __restrict__ tri,
                                           int stride, int bin, const Ray& r,
                                           float t0, int lane) {
  if (!(r.t1 > t0)) return pack_key(kMissT, -1);
  const int first = bin * kBin * kLane;
  if (!Watertight) return warp_min(lane_key_mt(tri, stride, first, lane, r, t0));
  const Shear s = make_shear(r);   // warp-uniform: one branch per pair
  int64_t key;
  if (s.kz == 0) {
    key = lane_key_wt<0>(tri, stride, first, lane, r, s, t0);
  } else if (s.kz == 1) {
    key = lane_key_wt<1>(tri, stride, first, lane, r, s, t0);
  } else {
    key = lane_key_wt<2>(tri, stride, first, lane, r, s, t0);
  }
  return warp_min(key);
}

// One warp per sorted pair q; lane 0 writes keys[q].
template <bool Watertight>
__global__ void __launch_bounds__(kThreads)
binned_leaf_kernel(const float* __restrict__ tri,
                   const int32_t* __restrict__ sortd,
                   const int64_t* __restrict__ pair_ray, int64_t p,
                   const float* __restrict__ rays, float t0,
                   int64_t* __restrict__ keys) {
  const int64_t q = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (q >= p) return;   // the whole warp
  const int32_t bin = sortd[q];
  int64_t key = pack_key(kMissT, -1);
  if (bin != kSentinel) {
    key = bin_key<Watertight>(tri + (int64_t)bin * kBin * kTriRows * kLane,
                              kTriRows * kLane, bin, load_ray(rays, pair_ray[q]),
                              t0, lane);
  }
  if (lane == 0) keys[q] = key;
}

// 16 bytes from global to shared memory without a register round trip
// (both addresses 16-byte aligned); cp_async_wait waits for all of them.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One CUDA block per row of `blocks` = (bin, start, count): the sorted pairs
// start .. start + count - 1, all of bin `bin`; bin -1 marks an unused row.
// The block copies the bin's 4 x 9 rows into shared memory, then its warps
// take the run's pairs in turn, one warp per pair as in binned_leaf_kernel.
template <bool Watertight>
__global__ void __launch_bounds__(kThreads)
binned_leaf_streamed_kernel(const float* __restrict__ tri,
                            const int32_t* __restrict__ blocks,
                            const int64_t* __restrict__ pair_ray,
                            const float* __restrict__ rays, float t0,
                            int64_t* __restrict__ keys) {
  __shared__ __align__(16) float stri[kBinFloats];
  const int32_t* blk = blocks + 3 * (int64_t)blockIdx.x;
  const int32_t bin = blk[0];
  if (bin < 0) return;  // the same for the whole block: before the barrier
  const float* src = tri + (int64_t)bin * kBin * kTriRows * kLane;
  constexpr int kClusterFloats = 9 * kLane;
  for (int k = 4 * threadIdx.x; k < kBinFloats; k += 4 * blockDim.x) {
    const int ci = k / kClusterFloats;
    cp_async16(stri + k, src + ci * kTriRows * kLane + (k - ci * kClusterFloats));
  }
  cp_async_wait();
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int64_t start = blk[1];
  const int count = blk[2];
  for (int j = threadIdx.x / kWarp; j < count; j += kThreads / kWarp) {
    const int64_t key = bin_key<Watertight>(stri, kClusterFloats, bin,
                                            load_ray(rays, pair_ray[start + j]), t0,
                                            lane);
    if (lane == 0) keys[start + j] = key;
  }
}

}  // namespace

extern "C" {

// bin_box: (n_words * 32, 128) f32, lanes 0..5 = bmin|bmax; rays: (n, 8)
// f32 [o | d | t1 | pad], 16-byte aligned. Writes ids (n, w_slots) i32, the
// first w_slots crossing bins of each ray ascending, kSentinel past the
// last; ovf (n,) bool, more bins cross; and, if words is not null, words
// (n, n_words) i32, the crossing bits left after the peel.
int pr_binned_prepass(const void* bin_box, int n_words, const void* rays,
                      float t0, int64_t n, int w_slots, void* ids, void* ovf,
                      void* words, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  binned_prepass_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)bin_box, n_words, (const float*)rays, t0, n, w_slots,
      (int32_t*)ids, (bool*)ovf, (int32_t*)words);
  return (int)cudaGetLastError();
}

// words_in: (n, n_words) i32 crossing bits; writes the next w_slots bins of
// each ray to ids (n, w_slots), ovf (n,) and the bits left to words_out.
int pr_binned_peel(const void* words_in, int n_words, int64_t n, int w_slots,
                   void* ids, void* ovf, void* words_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  binned_peel_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words_in, n_words, n, w_slots, (int32_t*)ids,
      (bool*)ovf, (int32_t*)words_out);
  return (int)cudaGetLastError();
}

// tri: (K*16, 128) f32; sortd: (p,) i32 bin of each pair (kSentinel: none);
// pair_ray: (p,) i64 its ray's row in rays (n, 8). Writes keys (p,) i64.
int pr_binned_leaf(const void* tri, const void* sortd, const void* pair_ray,
                   int64_t p, const void* rays, float t0, int watertight,
                   void* keys, void* stream) {
  if (p <= 0) return (int)cudaSuccess;
  auto kernel = watertight ? binned_leaf_kernel<true> : binned_leaf_kernel<false>;
  kernel<<<warp_blocks(p), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const int32_t*)sortd, (const int64_t*)pair_ray, p,
      (const float*)rays, t0, (int64_t*)keys);
  return (int)cudaGetLastError();
}

// blocks: (n_blocks, 3) i32 rows (bin, start, count) over the sorted pairs;
// pair_ray and rays as in pr_binned_leaf. Writes keys[start .. start+count).
int pr_binned_leaf_streamed(const void* tri, const void* blocks,
                            int64_t n_blocks_, const void* pair_ray,
                            const void* rays, float t0, int watertight,
                            void* keys, void* stream) {
  if (n_blocks_ <= 0) return (int)cudaSuccess;
  auto kernel = watertight ? binned_leaf_streamed_kernel<true>
                           : binned_leaf_streamed_kernel<false>;
  kernel<<<(unsigned int)n_blocks_, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const int32_t*)blocks, (const int64_t*)pair_ray,
      (const float*)rays, t0, (int64_t*)keys);
  return (int)cudaGetLastError();
}

}  // extern "C"
