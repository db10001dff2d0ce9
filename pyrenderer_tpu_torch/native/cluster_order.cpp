// Native median-split cluster ordering for pyrenderer_tpu_torch (a copy of pyrenderer_tpu/native/cluster_order.cpp).
//
// Host-side C++ twin of accel/clusters._median_split_order: recursive
// largest-axis median split over triangle centroids, split point rounded
// to a leaf_size multiple so every block except the last is exactly full.
// The recursion order doubles as the supercluster grouping (adjacent
// leaves share a subtree => compact parent boxes) — see
// accel/clusters.py's module docstring for why this layout, and the
// reference's own median-split build it echoes
// (reference accelerators/bvh_taichi.py:69-104).
//
// Bit-for-bit identical output to the Python implementation (stable sort
// along the first-widest axis; round-half-to-even on the split point, as
// Python's round()), so native and fallback builds are interchangeable —
// tests/test_torch_native.py asserts equality.
//
// Exposed as a C ABI for ctypes; see pyrenderer_tpu_torch/native/__init__.py.
// Build: g++ -O3 -shared -fPIC -o libcluster_order.so cluster_order.cpp

#include <algorithm>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Split the order[lo, hi) subrange recursively (explicit stack: meshes of
// hundreds of thousands of triangles would otherwise nest ~log2(T/leaf)
// deep — fine, but the iterative form also keeps the hot path allocation
// free).
void split_range(const double* cent, int64_t* order, int64_t lo, int64_t hi,
                 int64_t leaf) {
  struct Range {
    int64_t lo, hi;
  };
  std::vector<Range> stack;
  stack.push_back({lo, hi});
  while (!stack.empty()) {
    Range r = stack.back();
    stack.pop_back();
    const int64_t n = r.hi - r.lo;
    if (n <= leaf) continue;

    // widest centroid axis over the subrange (first max wins, matching
    // np.argmax)
    double mn[3] = {HUGE_VAL, HUGE_VAL, HUGE_VAL};
    double mx[3] = {-HUGE_VAL, -HUGE_VAL, -HUGE_VAL};
    for (int64_t i = r.lo; i < r.hi; ++i) {
      const double* c = cent + 3 * order[i];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], c[a]);
        mx[a] = std::max(mx[a], c[a]);
      }
    }
    int ax = 0;
    double best = mx[0] - mn[0];
    for (int a = 1; a < 3; ++a) {
      const double ext = mx[a] - mn[a];
      if (ext > best) {
        best = ext;
        ax = a;
      }
    }

    std::stable_sort(order + r.lo, order + r.hi,
                     [cent, ax](int64_t i, int64_t j) {
                       return cent[3 * i + ax] < cent[3 * j + ax];
                     });

    // round-half-to-even on the leaf-multiple split point, as Python's
    // round() (nearbyint under the default FE_TONEAREST mode)
    int64_t half = n / 2;
    half = static_cast<int64_t>(
        std::nearbyint(static_cast<double>(half) / leaf)) * leaf;
    if (half < leaf) half = leaf;
    // push right first so the left half is processed (and emitted) first,
    // preserving the Python recursion's depth-first left-to-right order
    stack.push_back({r.lo + half, r.hi});
    stack.push_back({r.lo, r.lo + half});
  }
}

}  // namespace

extern "C" {

// cent: (t, 3) float64 row-major centroids. order: out, t int64 slots.
// Returns 0 on success.
int32_t cluster_median_order(const double* cent, int64_t t, int64_t leaf,
                             int64_t* order) {
  if (t <= 0 || leaf <= 0) return -1;
  for (int64_t i = 0; i < t; ++i) order[i] = i;
  split_range(cent, order, 0, t, leaf);
  return 0;
}

}  // extern "C"
