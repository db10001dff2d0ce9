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
// lane reduction. Here each thread owns one ray (prepass, peel) or one pair
// (leaf), bits are peeled with __ffs as soon as a 32-bin word is formed, and
// the leaf's result is the exact float32 t with its slot, written as one
// int64 key (float bits << 32 | slot) that the per-ray reduce takes the
// minimum of: t > t0 > 0, so the float bits order like the floats.
//
// What bounds each kernel on this card:
// - prepass: per ray, (bins padded to 32) slab tests of ~20 flops against
//   boxes staged in shared memory (224 boxes, 5.25 KiB at terrain100k);
//   compute, and one pass over the ray rows.
// - peel: per ray, n_words words read and written; memory, tiny.
// - leaf: per pair, kBin x 128 triangle tests of ~30 (MT) or ~100
//   (watertight) flops and 36 bytes of table per triangle. The resident
//   leaf reads them straight from the (K*16, 128) table: the pairs arrive
//   sorted by bin, so the threads of a warp mostly read the same triangle
//   (one broadcast transaction) and the bin stays in L1/L2. The streamed
//   leaf gives each CUDA block one bin's run of up to 128 pairs and stages
//   the bin's 4 x 9 x 128 floats (18,432 bytes) in shared memory first,
//   which is what the TPU's scalar-prefetched index-map DMA did.
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

__device__ __forceinline__ int64_t pack_key(float t, int32_t slot) {
  return (int64_t)(((uint64_t)__float_as_uint(t) << 32) | (uint32_t)slot);
}

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

// The closest hit of one ray over the kBin x 128 triangles of `bin`, whose
// cluster ci has its rows at tri + ci * stride (row stride kLane): ascending
// slot with a strict <, so the minimum t wins and a tie the lowest slot. A
// miss gives pack_key(kMissT, -1).
template <bool Watertight>
__device__ __forceinline__ int64_t bin_key(const float* __restrict__ tri,
                                           int stride, int bin, const Ray& r,
                                           float t0) {
  const Shear s = Watertight ? make_shear(r) : Shear{};
  float best_t = kMissT;
  int32_t best = -1;
  for (int ci = 0; ci < kBin; ++ci) {
    const float* cl = tri + ci * stride;
    for (int lane = 0; lane < kLane; ++lane) {
      float t;
      if (tri_test<Watertight>(cl + lane, r, s, t0, r.t1, &t) && t < best_t) {
        best_t = t;
        best = (bin * kBin + ci) * kLane + lane;
      }
    }
  }
  return pack_key(best_t, best);
}

template <bool Watertight>
__global__ void __launch_bounds__(kThreads)
binned_leaf_kernel(const float* __restrict__ tri,
                   const int32_t* __restrict__ sortd,
                   const int64_t* __restrict__ pair_ray, int64_t p,
                   const float* __restrict__ rays, float t0,
                   int64_t* __restrict__ keys) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p) return;
  const int32_t bin = sortd[q];
  if (bin == kSentinel) {
    keys[q] = pack_key(kMissT, -1);
    return;
  }
  const Ray r = load_ray(rays, pair_ray[q]);
  keys[q] = bin_key<Watertight>(tri + (int64_t)bin * kBin * kTriRows * kLane,
                                kTriRows * kLane, bin, r, t0);
}

// One CUDA block per row of `blocks` = (bin, start, count): the sorted pairs
// start .. start + count - 1 (count <= 128), all of bin `bin`; bin -1 marks
// an unused row.
template <bool Watertight>
__global__ void __launch_bounds__(kThreads)
binned_leaf_streamed_kernel(const float* __restrict__ tri,
                            const int32_t* __restrict__ blocks,
                            const int64_t* __restrict__ pair_ray,
                            const float* __restrict__ rays, float t0,
                            int64_t* __restrict__ keys) {
  __shared__ float stri[kBinFloats];
  const int32_t* blk = blocks + 3 * (int64_t)blockIdx.x;
  const int32_t bin = blk[0];
  if (bin < 0) return;  // the same for the whole block: before the barrier
  const float* src = tri + (int64_t)bin * kBin * kTriRows * kLane;
  for (int k = threadIdx.x; k < kBinFloats; k += blockDim.x) {
    const int ci = k / (9 * kLane);
    stri[k] = src[ci * kTriRows * kLane + (k - ci * 9 * kLane)];
  }
  __syncthreads();
  if ((int)threadIdx.x >= blk[2]) return;
  const int64_t q = (int64_t)blk[1] + threadIdx.x;
  const Ray r = load_ray(rays, pair_ray[q]);
  keys[q] = bin_key<Watertight>(stri, 9 * kLane, bin, r, t0);
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
  kernel<<<n_blocks(p), kThreads, 0, (cudaStream_t)stream>>>(
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
