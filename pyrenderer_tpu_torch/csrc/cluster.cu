// Cluster-sweep ray traversal for Hopper (sm_90a): closest hit and any hit
// over the two-level ClusterScene of accel/clusters.py, one warp per ray,
// with Moeller-Trumbore or watertight leaves (a template parameter).
//
// Replaces the two TPU kernels of pyrenderer_tpu/kernels/pallas_cluster.py:
//   pr_cluster_closest -> _closest_kernel (:449, via _sweep), resume=False
//   pr_cluster_closest_resume -> the same kernel with resume=True (via
//     _sweep's pallas_call at :734; suspend/resume rounds, closest_hit
//     :913-934)
//   pr_cluster_occluded -> _anyhit_kernel (:577, via _sweep_any)
//
// The TPU kernels sweep 128-ray tiles in lockstep, pack per-box decisions
// into bitmasks iterated with ctz loops, and pack (t | lane) into one int32
// key: all of that avoids the TPU's vector->scalar syncs, which a GPU does
// not have. None of it is carried over.
//
// What bounds the walk on this card: too little parallel work per query.
// At terrain100k a bounce-1 wavefront of 65,536 rays has 15,596 live rays;
// each needs ~124 slab tests and ~3.55 leaves of 128 triangle tests on its
// front-to-back walk (perf/clusterbench.py walk), a long chain of
// dependent table loads. One thread per ray gave the card ~122 busy
// blocks, every warp a serial loop over the union of its 32 rays' leaves,
// 128 tests at a time: 1.93 ms for the closest hit, 1.31 ms for the any hit
// on that wavefront and its shadow rays, ~220x the operation bound of the
// walk (NVIDIA H100 80GB HBM3, 700.00 W power limit).
//
// The design: one warp per ray, so the walk of each ray is spread over 32
// lanes and the card holds 32x the threads in flight. Lane l of the warp
// - slab-tests supercluster ranks l, l + 32, ... (in the wavefront's
//   front-to-back rank, kernels/cluster.py _sc_order) against the running
//   bound; __ballot_sync gives one word per 32 ranks, whose set bits the
//   warp visits in ascending order (__ffs). Before each visit the warp
//   re-checks the box against the current bound with its t_near, shuffled
//   from its lane: the visits and the culling are those of a serial walk;
// - lanes 0..15 do the same for the 16 child boxes of a visited
//   supercluster;
// - in a leaf, tests triangles l, l + 32, l + 64 and l + 96 of the cluster,
//   so each row of the SoA (K*16, 128) table is one coalesced 128-byte read
//   per warp. The warp reduces its best hit as one int64 key (leaf.cuh
//   pack_key) with __shfl_xor_sync; the result is in every lane, so the
//   best t and the bound stay warp-uniform.
// The boxes come from compact copies, 8 floats a box (ClusterScene
// child_box8, super_cols8): the 16 children of a supercluster are one
// 512-byte read, and the whole child table (25.6 KB at terrain100k) fits in
// L1. A triangle is accepted against the ray's t1, not against the running
// best: the key minimum then keeps the lowest slot among equal t whatever
// the visit order. The closest hit is the exact float32 t of the leaf test,
// ties to the lowest slot, as the plain twin gives it. The any hit stops
// after the first 32-triangle step in which some lane hit (__any_sync). A
// warp whose ray is dead (t1 <= t0, or NaN) writes a miss and returns.
//
// On the same card and wavefront this takes 0.082 ms (closest hit) and
// 0.045 ms (any hit), 48 registers, no spill: ~9x and ~7x the walk's
// operation bound, of which 0.0115 ms is the launch of 65,536 warps itself
// (every ray dead). What remains is latency: each ray's walk is a chain of
// dependent loads and warp reductions, and the longest walks (8 leaves at
// the 99th percentile, 19 and 370 slab tests for the longest ray) finish
// last. The compact boxes took 20-26% off the 128-float rows; capping the
// registers at 32 (16 blocks an SM) made it 36% slower.
//
// The resume mode (template flag Resume of cluster_closest_kernel) is that
// walk with carried state and a visit budget, for suspend/resume rounds
// (kernels/cluster.py closest_hit with rounds > 1):
// - a ray starts from the best key pack_key(t_in, slot_in) of an earlier
//   pass, so its cull bound is min(t_in, t1) from the start; triangles are
//   still accepted against t1, so the key minimum keeps the lowest slot
//   among equal t after a resume too;
// - budget > 0 caps the superclusters the warp visits (a visit is one that
//   passes the re-check against the current bound): after the budget-th
//   visit the warp stops and writes done = 0 if some later rank still
//   crosses under its current bound, done = 1 otherwise. A ray that runs
//   out of crossing ranks first, and a dead ray (which writes its carried
//   t_in, slot_in), write done = 1. budget = 0 means no budget (done = 1).
// The TPU counts the budget per 128-ray tile and ends a tile's sweep in the
// middle of a bit word; a warp is one ray, so the budget counts per ray.
// The final result after the last round is the one-pass result bit for bit
// (accel/clusters.py closest_hit_resume_ref is the twin of one launch).
// The fresh mode compiles to the same code as before: the resume mode costs
// it nothing, as on the TPU (_sweep :713-719).
//
// Arithmetic, constants, the slab and triangle tests, the key and its warp
// minimum are leaf.cuh's.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "leaf.cuh"

namespace {

constexpr int kBoxRow = 8;   // floats per box row: bmin.xyz | bmax.xyz | 0 | 0
constexpr int kLeafSteps = kLane / kWarp;   // triangles per lane in a leaf

// The walk of one ray by its warp. Visit(j) runs the leaf of cluster j
// (every lane calls it, with the same j) and returns true to stop; bound()
// is the ray's current cull distance, the same in every lane and never
// NaN. s_pad is a multiple of 32.
template <typename Bound, typename Visit>
__device__ __forceinline__ void sweep(const float* __restrict__ child_box,
                                      const float* __restrict__ super_sorted,
                                      const int32_t* __restrict__ order,
                                      int s_pad, const Ray& r, float t0,
                                      int lane, Bound bound, Visit visit) {
  for (int base = 0; base < s_pad; base += kWarp) {
    float s_near;
    const bool s_cross = slab_near(super_sorted + (int64_t)(base + lane) * kBoxRow,
                                   r, t0, bound(), &s_near);
    const int s_id = order[base + lane];
    for (uint32_t sm = __ballot_sync(kAll, s_cross); sm != 0u; sm &= sm - 1u) {
      const int b = __ffs(sm) - 1;
      // culled by a hit found since the ballot
      if (!(__shfl_sync(kAll, s_near, b) <= bound())) continue;
      const int first = __shfl_sync(kAll, s_id, b) * kGroup;
      float c_near = 0.0f;
      const bool c_cross =
          lane < kGroup && slab_near(child_box + (int64_t)(first + lane) * kBoxRow,
                                     r, t0, bound(), &c_near);
      for (uint32_t cm = __ballot_sync(kAll, c_cross); cm != 0u; cm &= cm - 1u) {
        const int c = __ffs(cm) - 1;
        if (!(__shfl_sync(kAll, c_near, c) <= bound())) continue;
        if (visit(first + c)) return;
      }
    }
  }
}

// sweep() with a visit budget (budget > 0; 0: none), for the resume mode:
// counts the superclusters the warp visits and stops after the budget-th.
// Returns true when it stopped while a later rank still crosses under the
// current bound (the ray is suspended), false when it ran out of crossing
// ranks.
template <typename Bound, typename Visit>
__device__ __forceinline__ bool sweep_budget(const float* __restrict__ child_box,
                                             const float* __restrict__ super_sorted,
                                             const int32_t* __restrict__ order,
                                             int s_pad, const Ray& r, float t0,
                                             int lane, int budget, Bound bound,
                                             Visit visit) {
  int visits = 0;
  for (int base = 0; base < s_pad; base += kWarp) {
    float s_near;
    const bool s_cross = slab_near(super_sorted + (int64_t)(base + lane) * kBoxRow,
                                   r, t0, bound(), &s_near);
    const int s_id = order[base + lane];
    for (uint32_t sm = __ballot_sync(kAll, s_cross); sm != 0u; sm &= sm - 1u) {
      const int b = __ffs(sm) - 1;
      if (!(__shfl_sync(kAll, s_near, b) <= bound())) continue;
      if (visits == budget) return true;   // budget spent, this rank crosses
      const int first = __shfl_sync(kAll, s_id, b) * kGroup;
      float c_near = 0.0f;
      const bool c_cross =
          lane < kGroup && slab_near(child_box + (int64_t)(first + lane) * kBoxRow,
                                     r, t0, bound(), &c_near);
      for (uint32_t cm = __ballot_sync(kAll, c_cross); cm != 0u; cm &= cm - 1u) {
        const int c = __ffs(cm) - 1;
        if (!(__shfl_sync(kAll, c_near, c) <= bound())) continue;
        visit(first + c);
      }
      ++visits;
    }
  }
  return false;
}

template <bool Watertight, bool Resume>
__global__ void __launch_bounds__(kThreads)
cluster_closest_kernel(const float* __restrict__ tri,
                       const float* __restrict__ child_box,
                       const float* __restrict__ super_sorted,
                       const int32_t* __restrict__ order, int s_pad,
                       const float* __restrict__ rays, float t0, int64_t n,
                       const float* __restrict__ t_in,
                       const int32_t* __restrict__ slot_in, int budget,
                       float* __restrict__ t_out,
                       int32_t* __restrict__ slot_out,
                       int32_t* __restrict__ done_out) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (i >= n) return;
  const Ray r = load_ray(rays, i);
  int64_t best = Resume ? pack_key(t_in[i], slot_in[i]) : pack_key(kMissT, -1);
  bool suspended = false;
  if (r.t1 > t0) {
    const Shear s = Watertight ? make_shear(r) : Shear{};
    float best_t = Resume ? t_in[i] : kMissT;
    const auto bound = [&] { return fminf(best_t, r.t1); };
    const auto leaf = [&](int j) {
      const float* cl = tri + (int64_t)j * kTriRows * kLane + lane;
      int64_t key = pack_key(kMissT, -1);
#pragma unroll
      for (int k = 0; k < kLeafSteps; ++k) {
        float t;
        if (tri_test<Watertight>(cl + k * kWarp, r, s, t0, r.t1, &t)) {
          const int64_t hit = pack_key(t, j * kLane + k * kWarp + lane);
          key = hit < key ? hit : key;
        }
      }
      key = warp_min(key);
      if (key < best) {
        best = key;
        best_t = __uint_as_float((uint32_t)(key >> 32));
      }
    };
    // two calls of sweep_budget / sweep under `if constexpr`: folding them
    // into one runtime branch made ptxas cap the MT resume variant at 48
    // registers with a 20-byte spill (56, no spill, as it is)
    if constexpr (Resume) {
      suspended = budget > 0 &&
                  sweep_budget(child_box, super_sorted, order, s_pad, r, t0, lane,
                               budget, bound, leaf);
      if (budget <= 0)
        sweep(child_box, super_sorted, order, s_pad, r, t0, lane, bound,
              [&](int j) { leaf(j); return false; });
    } else {
      sweep(child_box, super_sorted, order, s_pad, r, t0, lane, bound,
            [&](int j) { leaf(j); return false; });
    }
  }
  if (lane == 0) {
    t_out[i] = __uint_as_float((uint32_t)(best >> 32));
    slot_out[i] = (int32_t)(uint32_t)best;
    if constexpr (Resume) done_out[i] = suspended ? 0 : 1;
  }
}

template <bool Watertight>
__global__ void __launch_bounds__(kThreads)
cluster_anyhit_kernel(const float* __restrict__ tri,
                      const float* __restrict__ child_box,
                      const float* __restrict__ super_sorted,
                      const int32_t* __restrict__ order, int s_pad,
                      const float* __restrict__ rays, float t0, int64_t n,
                      bool* __restrict__ occ_out) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (i >= n) return;
  const Ray r = load_ray(rays, i);
  bool occ = false;
  if (r.t1 > t0) {
    const Shear s = Watertight ? make_shear(r) : Shear{};
    sweep(child_box, super_sorted, order, s_pad, r, t0, lane,
          [&] { return r.t1; },
          [&](int j) {
            const float* cl = tri + (int64_t)j * kTriRows * kLane + lane;
#pragma unroll
            for (int k = 0; k < kLeafSteps; ++k) {
              float t;
              const bool hit =
                  tri_test<Watertight>(cl + k * kWarp, r, s, t0, r.t1, &t);
              // the ray retires at its first occluding step
              if (__any_sync(kAll, hit)) {
                occ = true;
                return true;
              }
            }
            return false;
          });
  }
  if (lane == 0) occ_out[i] = occ;
}

}  // namespace

extern "C" {

// tri: (K*16, 128) f32; child_box: (K, 8) f32, one box per row (bmin |
// bmax | pad); super_sorted: (s_pad, 8) f32, the supercluster boxes in visit
// order, and order: (s_pad,) i32, rank -> supercluster id, s_pad a multiple
// of 32; rays: (n, 8) f32
// [o | d | t1 | pad], 16-byte aligned; t0 > 0.
// Writes t (n,) f32 (3e38 on a miss) and slot (n,) i32 (-1 on a miss).
int pr_cluster_closest(const void* tri, const void* child_box,
                       const void* super_sorted, const void* order, int s_pad,
                       const void* rays, float t0, int64_t n, int watertight,
                       void* t_out, void* slot_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = watertight ? cluster_closest_kernel<true, false>
                           : cluster_closest_kernel<false, false>;
  kernel<<<warp_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)child_box, (const float*)super_sorted,
      (const int32_t*)order, s_pad, (const float*)rays, t0, n, nullptr, nullptr,
      0, (float*)t_out, (int32_t*)slot_out, nullptr);
  return (int)cudaGetLastError();
}

// The resume mode: the operands of pr_cluster_closest, and t_in (n,) f32 and
// slot_in (n,) i32, each ray's carried best hit (3e38 and -1: none); budget,
// the superclusters a ray may visit (0: no budget). Writes t and slot as
// pr_cluster_closest does (a dead ray writes its t_in, slot_in) and done
// (n,) i32: 0 where the budget suspended the ray, 1 where it is resolved.
int pr_cluster_closest_resume(const void* tri, const void* child_box,
                              const void* super_sorted, const void* order,
                              int s_pad, const void* rays, float t0, int64_t n,
                              int watertight, const void* t_in,
                              const void* slot_in, int budget, void* t_out,
                              void* slot_out, void* done_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = watertight ? cluster_closest_kernel<true, true>
                           : cluster_closest_kernel<false, true>;
  kernel<<<warp_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)child_box, (const float*)super_sorted,
      (const int32_t*)order, s_pad, (const float*)rays, t0, n,
      (const float*)t_in, (const int32_t*)slot_in, budget, (float*)t_out,
      (int32_t*)slot_out, (int32_t*)done_out);
  return (int)cudaGetLastError();
}

// Same scene and ray operands as pr_cluster_closest; writes occluded (n,)
// bool: some triangle lies in (t0, t1).
int pr_cluster_occluded(const void* tri, const void* child_box,
                        const void* super_sorted, const void* order, int s_pad,
                        const void* rays, float t0, int64_t n, int watertight,
                        void* occ_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = watertight ? cluster_anyhit_kernel<true>
                           : cluster_anyhit_kernel<false>;
  kernel<<<warp_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)child_box, (const float*)super_sorted,
      (const int32_t*)order, s_pad, (const float*)rays, t0, n,
      (bool*)occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
