// Native SAH BVH builder for pyrenderer_tpu_torch (a copy of pyrenderer_tpu/native/bvh_builder.cpp).
//
// Host-side C++ counterpart of the reference's CPU SAH builder
// (reference accelerators/bvh.py:46-215: recursive top-down, 12-bucket
// surface-area heuristic with split-cost early-out and primitive
// reordering) — re-designed to emit the flat pre-order escape-pointer
// layout that accel/bvh.py's stackless traversal consumes (the layout of
// reference accelerators/bvh_taichi.py:126-160).
//
// Exposed as a C ABI for ctypes; see pyrenderer_tpu_torch/native/__init__.py.
// Build: g++ -O3 -shared -fPIC -o libbvh_builder.so bvh_builder.cpp

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBuckets = 12;
constexpr float kTraversalCost = 0.125f;

struct BBox {
  float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};

  void grow(const float* lo, const float* hi) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], lo[a]);
      mx[a] = std::max(mx[a], hi[a]);
    }
  }
  void grow_point(const float* p) { grow(p, p); }
  float surface_area() const {
    float d[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
    if (d[0] < 0 || d[1] < 0 || d[2] < 0) return 0.0f;
    return 2.0f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
  }
};

struct Builder {
  const float* tri_min;   // (T, 3)
  const float* tri_max;   // (T, 3)
  std::vector<float> centroid;  // (T, 3)
  int leaf_size;
  int max_nodes;

  std::vector<int32_t> order;
  float* out_bmin;
  float* out_bmax;
  int32_t* out_first;
  int32_t* out_count;
  int32_t* out_escape;
  int n_nodes = 0;

  int alloc() { return n_nodes++; }

  // Builds [lo, hi) of `order`; returns node count of the subtree.
  // `escape` is the pre-order successor on miss.
  int build(int lo, int hi, int escape) {
    int idx = alloc();
    if (idx >= max_nodes) return -1;  // caller checks n_nodes vs max_nodes

    BBox bounds, centroid_bounds;
    for (int i = lo; i < hi; ++i) {
      int t = order[i];
      bounds.grow(&tri_min[3 * t], &tri_max[3 * t]);
      centroid_bounds.grow_point(&centroid[3 * t]);
    }
    std::memcpy(&out_bmin[3 * idx], bounds.mn, 3 * sizeof(float));
    std::memcpy(&out_bmax[3 * idx], bounds.mx, 3 * sizeof(float));
    out_escape[idx] = escape;

    int n = hi - lo;
    if (n <= leaf_size) {
      out_first[idx] = lo;
      out_count[idx] = n;
      return 1;
    }

    // SAH over kBuckets buckets on the widest centroid axis (reference
    // bvh.py:70-106 tries up to 3 axes; the widest axis captures nearly all
    // of the benefit at a third of the cost).
    int axis = 0;
    float extent = -1.0f;
    for (int a = 0; a < 3; ++a) {
      float e = centroid_bounds.mx[a] - centroid_bounds.mn[a];
      if (e > extent) { extent = e; axis = a; }
    }

    int mid;
    if (extent <= 1e-12f) {
      mid = lo + n / 2;  // all centroids coincide: median split
    } else {
      BBox bucket_box[kBuckets];
      int bucket_n[kBuckets] = {0};
      float inv = kBuckets / extent;
      auto bucket_of = [&](int t) {
        int b = static_cast<int>((centroid[3 * t + axis] -
                                  centroid_bounds.mn[axis]) * inv);
        return std::min(b, kBuckets - 1);
      };
      for (int i = lo; i < hi; ++i) {
        int t = order[i];
        int b = bucket_of(t);
        bucket_box[b].grow(&tri_min[3 * t], &tri_max[3 * t]);
        bucket_n[b]++;
      }
      // cost of splitting after bucket b
      float best_cost = FLT_MAX;
      int best_split = -1;
      for (int b = 0; b < kBuckets - 1; ++b) {
        BBox left, right;
        int nl = 0, nr = 0;
        for (int j = 0; j <= b; ++j) {
          if (bucket_n[j]) { left.grow(bucket_box[j].mn, bucket_box[j].mx); nl += bucket_n[j]; }
        }
        for (int j = b + 1; j < kBuckets; ++j) {
          if (bucket_n[j]) { right.grow(bucket_box[j].mn, bucket_box[j].mx); nr += bucket_n[j]; }
        }
        if (nl == 0 || nr == 0) continue;
        float cost = kTraversalCost +
                     (left.surface_area() * nl + right.surface_area() * nr) /
                         std::max(bounds.surface_area(), 1e-20f);
        if (cost < best_cost) { best_cost = cost; best_split = b; }
      }
      if (best_split < 0) {
        mid = lo + n / 2;
      } else {
        float threshold = centroid_bounds.mn[axis] +
                          (best_split + 1) * extent / kBuckets;
        auto it = std::partition(
            order.begin() + lo, order.begin() + hi,
            [&](int t) { return centroid[3 * t + axis] < threshold; });
        mid = static_cast<int>(it - order.begin());
        if (mid == lo || mid == hi) mid = lo + n / 2;  // degenerate partition
      }
    }

    out_first[idx] = -1;
    out_count[idx] = 0;
    // pre-order: left child at idx+1; its escape is the right child's index.
    int left_size = 0;
    {
      // we need the right child's index before building left: compute the
      // left subtree size by a dry run of the same deterministic recursion?
      // Instead: build left with a placeholder, then patch. The escape of
      // every node in the left subtree that points "past the subtree" is
      // exactly the placeholder; patch them after the size is known.
      left_size = build(lo, mid, INT32_MIN);
      if (left_size < 0) return -1;
      int right_idx = idx + 1 + left_size;
      for (int i = idx + 1; i < idx + 1 + left_size; ++i) {
        if (out_escape[i] == INT32_MIN) out_escape[i] = right_idx;
      }
    }
    int right_size = build(lo + (mid - lo), hi, escape);
    // NOTE: the right range is [mid, hi)
    if (right_size < 0) return -1;
    return 1 + left_size + right_size;
  }
};

}  // namespace

extern "C" {

// Returns node count, or -1 if max_nodes was too small.
int32_t build_sah_bvh(const float* tri_min, const float* tri_max,
                      int32_t n_tris, int32_t leaf_size, int32_t max_nodes,
                      int32_t* out_order, float* out_bmin, float* out_bmax,
                      int32_t* out_first, int32_t* out_count,
                      int32_t* out_escape) {
  Builder b;
  b.tri_min = tri_min;
  b.tri_max = tri_max;
  b.leaf_size = std::max(1, static_cast<int>(leaf_size));
  b.max_nodes = max_nodes;
  b.centroid.resize(3 * n_tris);
  for (int t = 0; t < n_tris; ++t) {
    for (int a = 0; a < 3; ++a) {
      b.centroid[3 * t + a] = 0.5f * (tri_min[3 * t + a] + tri_max[3 * t + a]);
    }
  }
  b.order.resize(n_tris);
  for (int t = 0; t < n_tris; ++t) b.order[t] = t;
  b.out_bmin = out_bmin;
  b.out_bmax = out_bmax;
  b.out_first = out_first;
  b.out_count = out_count;
  b.out_escape = out_escape;

  int total = b.build(0, n_tris, -1);
  if (total < 0 || b.n_nodes > max_nodes) return -1;
  std::memcpy(out_order, b.order.data(), n_tris * sizeof(int32_t));
  return b.n_nodes;
}

}  // extern "C"
