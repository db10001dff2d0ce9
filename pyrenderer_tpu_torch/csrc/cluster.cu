// Cluster-sweep ray traversal for Hopper (sm_90a): closest hit and any hit
// over the two-level ClusterScene of accel/clusters.py, one thread per ray,
// with Moeller-Trumbore or watertight leaves (a template parameter).
//
// Replaces the two TPU kernels of pyrenderer_tpu/kernels/pallas_cluster.py:
//   pr_cluster_closest -> _closest_kernel (:449, via _sweep)
//   pr_cluster_occluded -> _anyhit_kernel (:577, via _sweep_any)
//
// The TPU kernels sweep 128-ray tiles in lockstep, pack per-box decisions
// into bitmasks and iterate them with ctz loops, and pack (t | lane) into
// one int32 key: all of that avoids the TPU's vector->scalar syncs, which a
// GPU does not have. Here each thread owns one ray and walks the
// superclusters in the wavefront's front-to-back rank (kernels/cluster.py
// _sc_order): slab test of the supercluster box against min(t_best, t1),
// then of its 16 child boxes against the same running bound, then the
// 128-triangle leaf of every child it crosses, read straight from the SoA
// (K*16, 128) table at tri[(j*16 + row)*128 + lane]. The closest-hit t is
// the exact float32 t of the leaf test; no key packing.
//
// What bounds it on this card: per ray, ~(visited leaves x 128) triangle
// tests of ~30 flops (MT) or ~100 (watertight) each, and the table reads
// behind them (36 bytes per triangle from a 6.25 MiB table at terrain100k,
// which stays in the 50 MB L2). The rays arrive coherence-sorted when the
// caller sorts, so the threads of a warp mostly visit the same clusters and
// read the same triangles (one broadcast transaction per warp). Shared-
// memory staging and warp-cooperative traversal are later work.
//
// Arithmetic, constants and the slab and triangle tests are leaf.cuh's.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "leaf.cuh"

namespace {

// The sweep shared by both kernels. Visit(j) runs the leaf of cluster j and
// returns true to stop; bound() is the ray's current cull distance.
template <typename Bound, typename Visit>
__device__ __forceinline__ void sweep(const float* __restrict__ child_box,
                                      const float* __restrict__ super_sorted,
                                      const int32_t* __restrict__ order,
                                      int s_pad, const Ray& r, float t0,
                                      Bound bound, Visit visit) {
  for (int rank = 0; rank < s_pad; ++rank) {
    if (!slab(super_sorted + (int64_t)rank * kLane, r, t0, bound())) continue;
    const int base = order[rank] * kGroup;
    for (int c = 0; c < kGroup; ++c) {
      const int j = base + c;
      if (!slab(child_box + (int64_t)j * kLane, r, t0, bound())) continue;
      if (visit(j)) return;
    }
  }
}

template <bool Watertight>
__global__ void __launch_bounds__(kThreads)
cluster_closest_kernel(const float* __restrict__ tri,
                       const float* __restrict__ child_box,
                       const float* __restrict__ super_sorted,
                       const int32_t* __restrict__ order, int s_pad,
                       const float* __restrict__ rays, float t0, int64_t n,
                       float* __restrict__ t_out,
                       int32_t* __restrict__ slot_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, i);
  const Shear s = Watertight ? make_shear(r) : Shear{};
  float best_t = kMissT;
  int32_t best = -1;
  sweep(child_box, super_sorted, order, s_pad, r, t0,
        [&] { return fminf(best_t, r.t1); },
        [&](int j) {
          const float* cl = tri + (int64_t)j * kTriRows * kLane;
          for (int lane = 0; lane < kLane; ++lane) {
            float t;
            if (!tri_test<Watertight>(cl + lane, r, s, t0, r.t1, &t)) continue;
            const int32_t slot = j * kLane + lane;
            // the exact minimum t; a tie goes to the lowest slot, as the
            // twin's ascending scan with a strict < gives it
            if (t < best_t || (t == best_t && slot < best)) {
              best_t = t;
              best = slot;
            }
          }
          return false;
        });
  t_out[i] = best_t;
  slot_out[i] = best;
}

template <bool Watertight>
__global__ void __launch_bounds__(kThreads)
cluster_anyhit_kernel(const float* __restrict__ tri,
                      const float* __restrict__ child_box,
                      const float* __restrict__ super_sorted,
                      const int32_t* __restrict__ order, int s_pad,
                      const float* __restrict__ rays, float t0, int64_t n,
                      bool* __restrict__ occ_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, i);
  const Shear s = Watertight ? make_shear(r) : Shear{};
  bool occ = false;
  sweep(child_box, super_sorted, order, s_pad, r, t0, [&] { return r.t1; },
        [&](int j) {
          const float* cl = tri + (int64_t)j * kTriRows * kLane;
          for (int lane = 0; lane < kLane; ++lane) {
            float t;
            // a ray retires at its first occluder
            if (tri_test<Watertight>(cl + lane, r, s, t0, r.t1, &t)) {
              occ = true;
              return true;
            }
          }
          return false;
        });
  occ_out[i] = occ;
}

}  // namespace

extern "C" {

// tri: (K*16, 128) f32; child_box: (K, 128) f32; super_sorted: (s_pad, 128)
// f32, the supercluster rows in visit order, and order: (s_pad,) i32, rank
// -> supercluster id; rays: (n, 8) f32 [o | d | t1 | pad], 16-byte aligned.
// Writes t (n,) f32 (3e38 on a miss) and slot (n,) i32 (-1 on a miss).
int pr_cluster_closest(const void* tri, const void* child_box,
                       const void* super_sorted, const void* order, int s_pad,
                       const void* rays, float t0, int64_t n, int watertight,
                       void* t_out, void* slot_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = watertight ? cluster_closest_kernel<true>
                           : cluster_closest_kernel<false>;
  kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)child_box, (const float*)super_sorted,
      (const int32_t*)order, s_pad, (const float*)rays, t0, n,
      (float*)t_out, (int32_t*)slot_out);
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
  kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)child_box, (const float*)super_sorted,
      (const int32_t*)order, s_pad, (const float*)rays, t0, n,
      (bool*)occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
