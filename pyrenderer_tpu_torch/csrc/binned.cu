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
// A bin is Bin adjacent clusters (accel/clusters.py BIN: 4 by default, 512
// triangles; the leaves are instantiated for 1, 2 and 4).
// The prepass slab-tests each ray against every bin box and keeps the first
// W crossing bins in ascending order; kernels/binned.py sorts the (bin, ray)
// pairs by bin, and the leaf tests each pair's ray against the bin's 512
// triangles. On the TPU the prepass worked on 128-ray tiles with rays in
// lanes, formed each 32-bin word as a sum of shifted masks, extracted set
// bits with a vectorised ctz, and the leaf packed (t | index in bin) into
// one int32 key so that min and argmin were one lane reduction. Here a warp
// serves one live ray (prepass) or one ray with bits left (peel), lanes over
// bins, and each pair (leaf); the leaf's result is the exact float32 t with
// its slot, written as one int64 key (float bits << 32 | slot) that the
// per-ray reduce takes the minimum of: t > t0 > 0, so the float bits order
// like the floats.
//
// What bounds each kernel on this card:
// - prepass: per live ray, (bins padded to 32) slab tests of ~26 flops
//   against boxes staged in shared memory (224 boxes at terrain100k);
//   operations, and one pass over the ray rows.
// - peel: per ray, n_words words read and written; memory, tiny.
// - leaf: per pair, Bin x 128 triangle tests of ~60 (MT) or ~75
//   (watertight) fp32 operations; the table is read from L1/L2 (the pairs
//   arrive sorted by bin), so the operations bound it.
//
// The prepass and the peel (the first port ran one thread per ray through
// every bin, dead rays included, then peeled bits one by one with __ffs and
// wrote each row at a 24- to 40-byte stride):
//   - A block serves a span of rays (kernels/binned.py PREPASS_SPAN = 32,
//     PEEL_SPAN = 64) in chunks of 8 consecutive ones, the chunks dealt out
//     to the blocks in turn (chunk_first): a wavefront's live rays come in
//     runs, and a block of consecutive rays would hold either many of them
//     (its warps then take them one after another while other SMs idle)
//     or none. It first writes the empty result of its chunks with
//     coalesced stores (ids SENTINEL, ovf false, words 0: fill_chunk), then
//     packs the rays that have work to its front (a ballot and a prefix
//     sum, pack_block), so warps take only those rays and write only what
//     differs from the empty result.
//   - Dead rays do nothing more. A ray with !(t1 >= t0) (t1 = 0 for
//     finished paths, NaN included) crosses no box: the slab test accepts
//     t_near <= min(t_far, t1) and t_near is at least t0 or NaN. A ray with
//     t1 == t0 can cross (its origin inside a box), so the rule is not the
//     whole-table kernels' !(t1 > t0).
//   - One warp per live ray, lanes over bins: lane l slab-tests bin
//     32 w + l of word w, and __ballot_sync gives the word, four words in
//     flight. The boxes are staged from the compact copy
//     ClusterScene.bin_box8 (32 bytes a box) as six planes of one
//     coordinate each, so the 32 lanes read 32 banks; tables of more than
//     kStageBoxes boxes go in passes, the rays' fill counts carried in
//     shared memory. min/max are the hardware's NaN-propagating min.NaN /
//     max.NaN: they give the same values as leaf.cuh's nmin / nmax up to
//     the sign of a zero, and the slab test only compares them, so every
//     crossing bit is the same (one instruction each where nmin / nmax
//     take three).
//   - The peel of a word is one step of the warp (warp_peel): a set bit's
//     rank among the word's set bits is a popcount, so each lane writes its
//     own id to slot filled + rank while that is below W; a second ballot
//     gives the bits left. ids are bin numbers, so bit 31 needs no care
//     here (the TPU took a bit's index from a float's exponent and had to
//     special-case INT32_MIN).
//   - The peel kernel reads its chunks' words into shared memory (eight
//     coalesced loads in flight a thread) and gives a warp to each ray with
//     a bit left: lane w holds word w, and the warp peels the non-zero
//     words in order with the same warp_peel (peel_lane_words).
// Measured alone on the terrain100k bounce-1 wavefront (CUDA-graph replay,
// one H100 80GB HBM3 at 700 W, PERF.md; the thread-per-ray kernels in
// brackets): prepass 0.0154 ms (0.0464), 0.0031 with every ray dead;
// peel at W = 6 0.0066 (0.0078), at W = 10 on the streamed path's round-2
// words 0.0053 (0.0121). Tried and dropped: testing each 32-bin word's
// union box first (exact, 0.0179 ms); a thread per ray for the peel.

// The leaves (the first port ran one thread per pair, 512 dependent tests
// in a serial loop: the 71,755 pairs of the terrain100k bounce-1 wavefront
// gave ~17 warps an SM, too few to hide each test's latency, and divergent
// rays made the watertight test select every sheared vertex (pick) and
// divide for every triangle): one warp per pair, lanes over the bin's
// triangles. Lane l tests triangles l, l + 32, l + 64 and l + 96 of each of
// the bin's 4 clusters, so each table row is one coalesced 128-byte read per
// warp and the ray one broadcast; each lane keeps its best key and the warp
// takes the minimum with __shfl_xor_sync (warp_min), as the cluster sweep's
// leaf does (cluster.cu). Triangles are accepted against the ray's t1, never
// a running best, so the key minimum keeps the lowest slot among equal t
// whatever the lanes' order: the keys are those of the thread-per-pair
// kernel bit for bit. In a warp the ray, and so the watertight shear's axis
// kz, is uniform: the test is instantiated once per kz (lane_key_wt) without
// selects, runs the plain arithmetic of two triangles before any branch,
// and divides only where the edges agree and det != 0. The resident leaf
// reads the (K*16, 128) table; the streamed leaf gives each CUDA block one
// bin's run of at most 16 sorted pairs (kernels/binned.py blocks_for,
// RUN_PAIRS), copies the bin's 4 x 9 x 128 floats (18,432 bytes) into shared
// memory with cp.async (what the TPU's scalar-prefetched index-map DMA did),
// and its 4 warps take the run's pairs in turn.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "leaf.cuh"

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;  // an empty candidate slot (kernels/binned.py SENTINEL)
constexpr int kStageBoxes = 512;           // bin boxes staged in shared memory per pass
constexpr int kBoxPlanes = 6;              // bmin.xyz | bmax.xyz
constexpr int kBoxRow = 8;                 // floats per row of bin_box8
// one bin's triangle rows v0|e1|e2, Bin clusters
template <int Bin>
constexpr int kBinFloats = Bin * 9 * kLane;

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// A live ray as the prepass keeps it in shared memory: o.xyz, ix | iy, iz,
// t1 (load_ray's reciprocals).
struct SlabRay {
  float4 a, b;
};

// leaf.cuh's slab test of box `b` of the staged planes (plane j at
// sbox + j * stride) under bound r.t1, in the same order of operations.
__device__ __forceinline__ bool slab_staged(const float* __restrict__ sbox,
                                            int stride, int b, const SlabRay& r,
                                            float t0) {
  const float lox = (sbox[b] - r.a.x) * r.a.w;
  const float loy = (sbox[stride + b] - r.a.y) * r.b.x;
  const float loz = (sbox[2 * stride + b] - r.a.z) * r.b.y;
  const float hix = (sbox[3 * stride + b] - r.a.x) * r.a.w;
  const float hiy = (sbox[4 * stride + b] - r.a.y) * r.b.x;
  const float hiz = (sbox[5 * stride + b] - r.a.z) * r.b.y;
  const float t_near = max_nan(max_nan(min_nan(lox, hix), min_nan(loy, hiy)),
                               max_nan(min_nan(loz, hiz), t0));
  const float t_far =
      min_nan(min_nan(max_nan(lox, hix), max_nan(loy, hiy)), max_nan(loz, hiz)) *
      kSlabWiden;
  return t_near <= min_nan(t_far, r.b.z);
}

// Copies boxes [0, nb) of bin_box8 rows (bmin.xyz | bmax.xyz | 0 | 0, 16-byte
// aligned) into six planes of `stride` floats.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ box8, int nb,
                                            float* __restrict__ sbox, int stride) {
  for (int k = threadIdx.x; k < 2 * nb; k += blockDim.x) {
    const int b = k >> 1;
    const float4 v = reinterpret_cast<const float4*>(box8)[k];
    if (k & 1) {
      sbox[4 * stride + b] = v.x;
      sbox[5 * stride + b] = v.y;
    } else {
      sbox[b] = v.x;
      sbox[stride + b] = v.y;
      sbox[2 * stride + b] = v.z;
      sbox[3 * stride + b] = v.w;
    }
  }
}

// Rays a block takes together: thread t of block b (of n_blocks) serves
// ray (t / kChunk * n_blocks + b) * kChunk + t % kChunk. Consecutive chunks
// go to different blocks, so a run of live (or dead) rays, as a wavefront
// has them, spreads over many blocks instead of filling a few.
constexpr int kChunk = 8;

__device__ __forceinline__ int64_t chunk_first(int t, int64_t n_blocks) {
  return ((int64_t)(t / kChunk) * n_blocks + blockIdx.x) * kChunk;
}

// The rays of the chunk from row `first` that are below n.
__device__ __forceinline__ int chunk_count(int64_t first, int64_t n) {
  return n - first <= 0 ? 0 : (n - first < kChunk ? (int)(n - first) : kChunk);
}

// The empty result of the chunk of rays from row `first` (those below n),
// written by its kChunk threads (q = the thread's place in the chunk) with
// coalesced stores: ids SENTINEL, ovf false and (words_out not null) words 0.
__device__ __forceinline__ void fill_chunk(int64_t first, int q, int64_t n, int w_slots,
                                           int n_words, int32_t* __restrict__ ids_out,
                                           bool* __restrict__ ovf_out,
                                           int32_t* __restrict__ words_out) {
  const int count = chunk_count(first, n);
  for (int k = q; k < count * w_slots; k += kChunk) ids_out[first * w_slots + k] = kSentinel;
  if (q < count) ovf_out[first + q] = false;
  if (words_out == nullptr) return;
  for (int k = q; k < count * n_words; k += kChunk) words_out[first * n_words + k] = 0;
}

// Packs the block's threads with `keep` set: *slot gets this thread's place
// among them, in thread order; returns how many there are. Every thread of
// the block must call it; the caller writes what it keeps at *slot and
// synchronises before anyone reads it.
__device__ __forceinline__ int pack_block(bool keep, int* warp_count, int* slot) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned ballot = __ballot_sync(kAll, keep);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / kWarp; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  *slot = before + __popc(ballot & ((1u << lane) - 1u));
  return total;
}

// One 32-bin word of a ray's crossing bits, peeled by the warp (all 32
// lanes, `word` and *filled the same in each): lane l owns bit l, bin
// first_bin + l. The set bits of rank below w_slots - *filled go to
// ids[*filled + rank], so the ids stay ascending; *filled advances, capped
// at w_slots. Returns the bits left.
__device__ __forceinline__ uint32_t warp_peel(uint32_t word, int lane, int first_bin,
                                              int32_t* __restrict__ ids, int w_slots,
                                              int* filled) {
  const int slot = *filled + __popc(word & ((1u << lane) - 1u));
  const bool take = ((word >> lane) & 1u) && slot < w_slots;
  if (take) ids[slot] = first_bin + lane;
  *filled = min(*filled + __popc(word), w_slots);
  return word & ~__ballot_sync(kAll, take);
}

// The words held by the warp's lanes (lane j: word c + j of a ray, bins
// 32 (c + j) .. 32 (c + j) + 31), peeled in ascending order by warp_peel:
// returns lane j's bits left; *filled and *left carry from call to call.
__device__ __forceinline__ uint32_t peel_lane_words(uint32_t mine, int c, int lane,
                                                    int32_t* __restrict__ ids,
                                                    int w_slots, int* filled,
                                                    bool* left) {
  uint32_t rest_w = 0u;
  for (uint32_t nz = __ballot_sync(kAll, mine != 0u); nz != 0u; nz &= nz - 1u) {
    const int j = __ffs(nz) - 1;
    const uint32_t rest = warp_peel(__shfl_sync(kAll, mine, j), lane, (c + j) * 32, ids,
                                    w_slots, filled);
    if (lane == j) rest_w = rest;
    *left |= rest != 0u;
  }
  return rest_w;
}

// One block per `span` rays (a multiple of kChunk, at most kThreads; the
// chunks of chunk_first); the live rays (t1 >= t0) packed to the front,
// one warp each in turn; the boxes in passes of at most kStageBoxes
// (dynamic shared memory: six planes of min(n_boxes, kStageBoxes) floats).
// A pass first forms all its words, a ballot each with no branch between
// them, then peels the non-zero ones.
__global__ void __launch_bounds__(kThreads)
binned_prepass_kernel(const float* __restrict__ bin_box8, int n_words,
                      const float* __restrict__ rays, float t0, int64_t n,
                      int span, int w_slots, int32_t* __restrict__ ids_out,
                      bool* __restrict__ ovf_out,
                      int32_t* __restrict__ words_out) {
  extern __shared__ float sbox[];
  __shared__ SlabRay sray[kThreads];
  __shared__ int64_t srow[kThreads];
  __shared__ int sfilled[kThreads];
  __shared__ int warp_count[kThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t n_blocks = gridDim.x;
  bool live = false;
  Ray r{};
  int64_t i = 0;
  if ((int)threadIdx.x < span) {
    const int64_t first = chunk_first(threadIdx.x, n_blocks);
    fill_chunk(first, threadIdx.x % kChunk, n, w_slots, n_words, ids_out, ovf_out, words_out);
    i = first + threadIdx.x % kChunk;
    if (i < n && rays[8 * i + 6] >= t0) {
      r = load_ray(rays, i);
      live = true;
    }
  }
  int slot;
  const int n_live = pack_block(live, warp_count, &slot);
  if (live) {
    sray[slot] = SlabRay{make_float4(r.ox, r.oy, r.oz, r.ix),
                         make_float4(r.iy, r.iz, r.t1, 0.0f)};
    srow[slot] = i;
    sfilled[slot] = 0;
  }
  __syncthreads();  // also orders fill_chunk's stores before the warps' own
  if (n_live == 0) return;
  const int n_boxes = n_words * 32;
  const int stride = min(n_boxes, kStageBoxes);
  for (int base = 0; base < n_boxes; base += stride) {
    const int nb = min(stride, n_boxes - base);
    if (base > 0) __syncthreads();  // the last pass's tests are done
    stage_boxes(bin_box8 + (int64_t)base * kBoxRow, nb, sbox, stride);
    __syncthreads();
    for (int p = warp; p < n_live; p += kThreads / kWarp) {
      const SlabRay ray = sray[p];
      uint32_t mine = 0u;  // lane j: word j of the pass
#pragma unroll 4
      for (int wl = 0; wl < nb / 32; ++wl) {
        const uint32_t word =
            __ballot_sync(kAll, slab_staged(sbox, stride, wl * 32 + lane, ray, t0));
        if (lane == wl) mine = word;
      }
      const int64_t row = srow[p];
      int filled = sfilled[p];
      bool left = false;
      const uint32_t rest_w = peel_lane_words(mine, base / 32, lane, ids_out + row * w_slots,
                                              w_slots, &filled, &left);
      if (words_out != nullptr && rest_w != 0u)
        words_out[row * n_words + base / 32 + lane] = (int32_t)rest_w;
      if (left && lane == 0) ovf_out[row] = true;
      if (lane == 0) sfilled[p] = filled;
    }
  }
}

// One block per `span` rays (a multiple of kChunk, at most kThreads; the
// chunks of chunk_first); the rays with a bit left packed to the front, one
// warp each in turn, 32 words at a time. The chunks' words go through shared
// memory (dynamic: span rows of n_words), read with kLoads coalesced loads
// in flight per thread.
constexpr int kLoads = 8;

__global__ void __launch_bounds__(kThreads)
binned_peel_kernel(const int32_t* __restrict__ words_in, int n_words,
                   int64_t n, int span, int w_slots, int32_t* __restrict__ ids_out,
                   bool* __restrict__ ovf_out,
                   int32_t* __restrict__ words_out) {
  extern __shared__ uint32_t swords[];
  __shared__ int busy[kThreads];
  __shared__ int slocal[kThreads];
  __shared__ int warp_count[kThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int q = threadIdx.x % kChunk;
  const int head = threadIdx.x - q;
  busy[threadIdx.x] = 0;
  if ((int)threadIdx.x < span) {
    const int64_t first = chunk_first(threadIdx.x, gridDim.x);
    fill_chunk(first, q, n, w_slots, n_words, ids_out, ovf_out, words_out);
    const int total = chunk_count(first, n) * n_words;
    const int32_t* src = words_in + first * n_words;
    uint32_t* dst = swords + head * n_words;
    for (int k0 = q; k0 < total; k0 += kChunk * kLoads) {
      uint32_t v[kLoads];
#pragma unroll
      for (int b = 0; b < kLoads; ++b) {
        const int k = k0 + b * kChunk;
        v[b] = k < total ? (uint32_t)src[k] : 0u;
      }
#pragma unroll
      for (int b = 0; b < kLoads; ++b) {
        const int k = k0 + b * kChunk;
        if (k < total) dst[k] = v[b];
      }
#pragma unroll
      for (int b = 0; b < kLoads; ++b) {
        if (v[b] != 0u) busy[head + (k0 + b * kChunk) / n_words] = 1;  // the word's ray
      }
    }
  }
  __syncthreads();
  int slot;
  const bool keep = busy[threadIdx.x] != 0;
  const int n_busy = pack_block(keep, warp_count, &slot);
  if (keep) slocal[slot] = threadIdx.x;
  __syncthreads();
  for (int p = warp; p < n_busy; p += kThreads / kWarp) {
    const int t = slocal[p];
    const int64_t row = chunk_first(t, gridDim.x) + t % kChunk;
    int filled = 0;
    bool left = false;
    for (int c = 0; c < n_words; c += kWarp) {
      const int w = c + lane;
      const uint32_t mine = w < n_words ? swords[t * n_words + w] : 0u;
      const uint32_t rest_w = peel_lane_words(mine, c, lane, ids_out + row * w_slots,
                                              w_slots, &filled, &left);
      if (rest_w != 0u) words_out[row * n_words + w] = (int32_t)rest_w;
    }
    if (left && lane == 0) ovf_out[row] = true;
  }
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
// lane + 96 of each of a bin's Bin clusters (cluster ci's rows at tri +
// ci * stride, row stride kLane; `first` the bin's first slot), watertight.
// Each of a cluster's rows is one coalesced 128-byte read (or a
// conflict-free shared-memory read) per warp. The lane runs the plain edge
// values of kBatch triangles straight through, then per triangle the rare
// branches: edge_fn's compensated values (vertices re-read) where an edge
// cancels, and the quotient t_scaled / det only where the edges agree and
// det != 0 (a ray crosses about one of a bin's triangles).
template <int Bin, int KZ>
__device__ __forceinline__ int64_t lane_key_wt(const float* __restrict__ tri,
                                               int stride, int first, int lane,
                                               const Ray& r, const Shear& s,
                                               float t0) {
  int64_t key = pack_key(kMissT, -1);
  for (int ci = 0; ci < Bin; ++ci) {
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
template <int Bin>
__device__ __forceinline__ int64_t lane_key_mt(const float* __restrict__ tri,
                                               int stride, int first, int lane,
                                               const Ray& r, float t0) {
  int64_t key = pack_key(kMissT, -1);
  for (int ci = 0; ci < Bin; ++ci) {
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

// The closest hit of one ray over the Bin x 128 triangles of `bin`, by the
// whole warp (every lane calls it with the same ray): the minimum key, in
// every lane. Triangles are accepted against the ray's t1, so the key
// minimum is the minimum t with a tie to the lowest slot, in whatever order
// the lanes test them; a miss, and a dead ray (t1 <= t0, or NaN), give
// pack_key(kMissT, -1).
template <int Bin, bool Watertight>
__device__ __forceinline__ int64_t bin_key(const float* __restrict__ tri,
                                           int stride, int bin, const Ray& r,
                                           float t0, int lane) {
  if (!(r.t1 > t0)) return pack_key(kMissT, -1);
  const int first = bin * Bin * kLane;
  if (!Watertight) return warp_min(lane_key_mt<Bin>(tri, stride, first, lane, r, t0));
  const Shear s = make_shear(r);   // warp-uniform: one branch per pair
  int64_t key;
  if (s.kz == 0) {
    key = lane_key_wt<Bin, 0>(tri, stride, first, lane, r, s, t0);
  } else if (s.kz == 1) {
    key = lane_key_wt<Bin, 1>(tri, stride, first, lane, r, s, t0);
  } else {
    key = lane_key_wt<Bin, 2>(tri, stride, first, lane, r, s, t0);
  }
  return warp_min(key);
}

// One warp per sorted pair q; lane 0 writes keys[q].
template <int Bin, bool Watertight>
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
    key = bin_key<Bin, Watertight>(tri + (int64_t)bin * Bin * kTriRows * kLane,
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
// The block copies the bin's Bin x 9 rows into shared memory, then its warps
// take the run's pairs in turn, one warp per pair as in binned_leaf_kernel.
template <int Bin, bool Watertight>
__global__ void __launch_bounds__(kThreads)
binned_leaf_streamed_kernel(const float* __restrict__ tri,
                            const int32_t* __restrict__ blocks,
                            const int64_t* __restrict__ pair_ray,
                            const float* __restrict__ rays, float t0,
                            int64_t* __restrict__ keys) {
  __shared__ __align__(16) float stri[kBinFloats<Bin>];
  const int32_t* blk = blocks + 3 * (int64_t)blockIdx.x;
  const int32_t bin = blk[0];
  if (bin < 0) return;  // the same for the whole block: before the barrier
  const float* src = tri + (int64_t)bin * Bin * kTriRows * kLane;
  constexpr int kClusterFloats = 9 * kLane;
  for (int k = 4 * threadIdx.x; k < kBinFloats<Bin>; k += 4 * blockDim.x) {
    const int ci = k / kClusterFloats;
    cp_async16(stri + k, src + ci * kTriRows * kLane + (k - ci * kClusterFloats));
  }
  cp_async_wait();
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int64_t start = blk[1];
  const int count = blk[2];
  for (int j = threadIdx.x / kWarp; j < count; j += kThreads / kWarp) {
    const int64_t key = bin_key<Bin, Watertight>(stri, kClusterFloats, bin,
                                                 load_ray(rays, pair_ray[start + j]), t0,
                                                 lane);
    if (lane == 0) keys[start + j] = key;
  }
}

using LeafKernel = void (*)(const float*, const int32_t*, const int64_t*, int64_t,
                           const float*, float, int64_t*);
using LeafStreamedKernel = void (*)(const float*, const int32_t*, const int64_t*,
                                    const float*, float, int64_t*);

// The leaf kernel of `bin` clusters a bin (1, 2 or 4), MT or watertight;
// null for another bin.
LeafKernel leaf_kernel_for(int bin, int watertight) {
  switch (bin) {
    case 1: return watertight ? binned_leaf_kernel<1, true> : binned_leaf_kernel<1, false>;
    case 2: return watertight ? binned_leaf_kernel<2, true> : binned_leaf_kernel<2, false>;
    case 4: return watertight ? binned_leaf_kernel<4, true> : binned_leaf_kernel<4, false>;
    default: return nullptr;
  }
}

LeafStreamedKernel leaf_streamed_kernel_for(int bin, int watertight) {
  switch (bin) {
    case 1: return watertight ? binned_leaf_streamed_kernel<1, true>
                              : binned_leaf_streamed_kernel<1, false>;
    case 2: return watertight ? binned_leaf_streamed_kernel<2, true>
                              : binned_leaf_streamed_kernel<2, false>;
    case 4: return watertight ? binned_leaf_streamed_kernel<4, true>
                              : binned_leaf_streamed_kernel<4, false>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// bin_box8: (n_words * 32, 8) f32 rows bmin|bmax|0|0, 16-byte aligned;
// rays: (n, 8) f32 [o | d | t1 | pad], 16-byte aligned; span: rays per
// block, a multiple of 8 up to 128. Writes ids (n, w_slots) i32, the first w_slots crossing
// bins of each ray ascending, kSentinel past the last; ovf (n,) bool, more
// bins cross; and, if words is not null, words (n, n_words) i32, the
// crossing bits left after the peel.
int pr_binned_prepass(const void* bin_box8, int n_words, const void* rays,
                      float t0, int64_t n, int span, int w_slots, void* ids,
                      void* ovf, void* words, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (span < kChunk || span > kThreads || span % kChunk || n_words < 1)
    return (int)cudaErrorInvalidValue;
  const int stride = n_words * 32 < kStageBoxes ? n_words * 32 : kStageBoxes;
  const size_t smem = sizeof(float) * kBoxPlanes * stride;
  binned_prepass_kernel<<<(unsigned int)((n + span - 1) / span), kThreads, smem,
                          (cudaStream_t)stream>>>(
      (const float*)bin_box8, n_words, (const float*)rays, t0, n, span, w_slots,
      (int32_t*)ids, (bool*)ovf, (int32_t*)words);
  return (int)cudaGetLastError();
}

// words_in: (n, n_words) i32 crossing bits; span: rays per block, a
// multiple of 8 up to 128. Writes the next w_slots bins of each ray to ids
// (n, w_slots), ovf (n,) and the bits left to words_out.
int pr_binned_peel(const void* words_in, int n_words, int64_t n, int span, int w_slots,
                   void* ids, void* ovf, void* words_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (span < kChunk || span > kThreads || span % kChunk || n_words < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * span * n_words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        binned_peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  binned_peel_kernel<<<(unsigned int)((n + span - 1) / span), kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const int32_t*)words_in, n_words, n, span, w_slots, (int32_t*)ids, (bool*)ovf,
      (int32_t*)words_out);
  return (int)cudaGetLastError();
}

// tri: (K*16, 128) f32; sortd: (p,) i32 bin of each pair (kSentinel: none);
// pair_ray: (p,) i64 its ray's row in rays (n, 8); bin: clusters a bin
// (accel/clusters.py BIN: 1, 2 or 4). Writes keys (p,) i64.
int pr_binned_leaf(const void* tri, const void* sortd, const void* pair_ray,
                   int64_t p, const void* rays, float t0, int watertight, int bin,
                   void* keys, void* stream) {
  if (p <= 0) return (int)cudaSuccess;
  auto kernel = leaf_kernel_for(bin, watertight);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<warp_blocks(p), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const int32_t*)sortd, (const int64_t*)pair_ray, p,
      (const float*)rays, t0, (int64_t*)keys);
  return (int)cudaGetLastError();
}

// blocks: (n_blocks, 3) i32 rows (bin, start, count) over the sorted pairs;
// pair_ray, rays and bin as in pr_binned_leaf. Writes keys[start ..
// start+count).
int pr_binned_leaf_streamed(const void* tri, const void* blocks,
                            int64_t n_blocks_, const void* pair_ray,
                            const void* rays, float t0, int watertight, int bin,
                            void* keys, void* stream) {
  if (n_blocks_ <= 0) return (int)cudaSuccess;
  auto kernel = leaf_streamed_kernel_for(bin, watertight);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned int)n_blocks_, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const int32_t*)blocks, (const int64_t*)pair_ray,
      (const float*)rays, t0, (int64_t*)keys);
  return (int)cudaGetLastError();
}

}  // extern "C"
