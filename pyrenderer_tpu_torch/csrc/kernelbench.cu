// Microbenchmark probes for Hopper (sm_90a): the four kernels of
// perf/kernelbench.py, each measuring one cost that shaped the traversal
// kernels (the leaf's speed of light, a block-wide reduction, a uniform
// branch, a bit loop).
//
// Replaces the TPU kernels of perf/kernelbench.py:
//   pr_kb_leaf    -> _leaf_kernel    (perf/kernelbench.py:70; also bench.py
//                    calibrate(), bench.py:82)
//   pr_kb_extract -> _extract_kernel (perf/kernelbench.py:129)
//   pr_kb_cond    -> _cond_kernel    (perf/kernelbench.py:162)
//   pr_kb_ctz     -> _ctz_kernel     (perf/kernelbench.py:206)
//
// Layout common to all four: one block of 128 threads per 128-ray tile, one
// thread per ray (the grid is N / 128 blocks: 256 at the harness's shape,
// under two blocks per SM of the card's 132). Each thread reads its ray's
// row of the (N, 8) float32 `rcol` once. leaf, cond and ctz stage the rows
// they read of the (128, 128) triangle table -- 8 row blocks x 9 rows x 128
// floats = 36,864 bytes -- in static shared memory; every thread of a block
// then reads the same triangle in the same cycle (a broadcast).
//
// Nothing here may be folded away by the compiler, or the probe measures
// nothing: the loop counts (n_leaves, n_ext, n_conds), the branch's
// threshold and the bit word are kernel arguments, and every output depends
// on every iteration (a running min, a running sum fed back into the next
// reduction).
//
// Arithmetic follows perf/kernelbench.py operation for operation (its
// Moeller-Trumbore order, not csrc/leaf.cuh's); with -fmad=false the
// outputs equal the plain PyTorch twins (perf/kernelbench.py of this
// package) bit for bit: min and max are exact, and no product is fused.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // rays per tile = threads per block
constexpr int kBlocks = 8;        // row blocks of the table (j % 8)
constexpr int kRows = 9;          // rows read per block: v0 | e1 | e2
constexpr int kBlockStride = 16;  // table rows per block
constexpr float kMiss = 3.0e38f;

// Stage rows (b * 16 + r), b < 8, r < 9, of the (128, 128) table.
__device__ __forceinline__ void stage_table(const float* __restrict__ tri,
                                            float (*s)[kRows][kThreads]) {
  for (int b = 0; b < kBlocks; ++b)
    for (int r = 0; r < kRows; ++r)
      s[b][r][threadIdx.x] = tri[(b * kBlockStride + r) * kThreads + threadIdx.x];
}

// One conditional leaf of _cond_kernel / _ctz_kernel: the min over the
// block's 128 lanes of (v0x - ox)(v0y - oy)(v0z - oz).
__device__ __forceinline__ float cond_leaf(const float (*b)[kThreads],
                                           float ox, float oy, float oz) {
  float m = kMiss;
  for (int k = 0; k < kThreads; ++k)
    m = fminf(m, (b[0][k] - ox) * (b[1][k] - oy) * (b[2][k] - oz));
  return m;
}

// leaf: n_leaves unconditional Moeller-Trumbore leaves of 128 triangles.
// Bound on this card: arithmetic, ~60 fp32 operations per ray-triangle
// test with one IEEE division (N * n_leaves * 128 tests); the bytes are
// 36 per ray. The table sits in shared memory and the running minimum in
// a register, so device memory sees only the rays and the result.
__global__ void __launch_bounds__(kThreads)
kb_leaf_kernel(const float* __restrict__ rcol, const float* __restrict__ tri,
               int n_leaves, float* __restrict__ out) {
  __shared__ float s[kBlocks][kRows][kThreads];
  stage_table(tri, s);
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float* row = rcol + 8 * i;
  const float ox = row[0], oy = row[1], oz = row[2];
  const float dx = row[3], dy = row[4], dz = row[5];
  float t_best = kMiss;
  for (int j = 0; j < n_leaves; ++j) {
    const float (*b)[kThreads] = s[j % kBlocks];
    float t_min = kMiss;
    for (int k = 0; k < kThreads; ++k) {
      const float v0x = b[0][k], v0y = b[1][k], v0z = b[2][k];
      const float e1x = b[3][k], e1y = b[4][k], e1z = b[5][k];
      const float e2x = b[6][k], e2y = b[7][k], e2z = b[8][k];
      const float cx = e1y * dz - e1z * dy;
      const float cy = e1z * dx - e1x * dz;
      const float cz = e1x * dy - e1y * dx;
      const float det = cx * e2x + cy * e2y + cz * e2z;
      const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
      const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
      const float qx = sy * e2z - sz * e2y;
      const float qy = sz * e2x - sx * e2z;
      const float qz = sx * e2y - sy * e2x;
      const float t = -inv * (qx * e1x + qy * e1y + qz * e1z);
      const float u = -inv * (qx * dx + qy * dy + qz * dz);
      const float v = inv * (cx * sx + cy * sy + cz * sz);
      // t < t_best against the minimum as the leaf began, as the TPU
      // kernel compares (the result is the same minimum either way)
      const bool ok = fabsf(det) > 0.0f && t > 1e-4f && t < t_best &&
                      u >= 0.0f && u <= 1.0f && v >= 0.0f && 1.0f - u - v >= 0.0f;
      t_min = fminf(t_min, ok ? t : kMiss);
    }
    t_best = fminf(t_best, t_min);
  }
  out[i] = t_best;
}

// extract: n_ext dependent block-wide reductions. Round j takes the max over
// the tile's 128 x 8 values of (rcol + acc) -- each thread's 8 values, then
// warp shuffles, then one step through shared memory -- and feeds
// acc += max * 1e-20 into round j + 1, so no two rounds can be merged or
// hoisted. Bound on this card: latency, not arithmetic or bytes (2,048
// operations and 4.5 KB per tile and round): each round is a chain of
// five shuffles and a barrier; the probe measures that chain, the GPU's
// counterpart of the TPU's vector -> scalar move.
__global__ void __launch_bounds__(kThreads)
kb_extract_kernel(const float* __restrict__ rcol, int n_ext,
                  float* __restrict__ out) {
  __shared__ float part[2][kThreads / 32];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float r[8];
  for (int c = 0; c < 8; ++c) r[c] = rcol[8 * i + c];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc = 0.0f;
  for (int j = 0; j < n_ext; ++j) {
    float m = r[0] + acc;
    for (int c = 1; c < 8; ++c) m = fmaxf(m, r[c] + acc);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    // two buffers: a warp that runs ahead into round j + 1 writes the
    // other one, and cannot reach round j + 2 before every warp has passed
    // round j + 1's barrier (and so finished reading round j)
    if (lane == 0) part[j & 1][warp] = m;
    __syncthreads();
    float s = part[j & 1][0];
    for (int w = 1; w < kThreads / 32; ++w) s = fmaxf(s, part[j & 1][w]);
    acc = acc + s * 1e-20f;
  }
  out[i] = 0.0f + acc;
}

// cond: n_conds uniform branches, each over one conditional leaf. The
// branch is taken when j >= lo, lo = 0 (taken) or n_conds (never taken),
// both runtime values, so the compiler keeps the branch and the loop. The
// branch is uniform across the block (every thread has the same j), so it
// costs no divergence. Bound on this card when taken: arithmetic, 6
// operations per ray and lane (N * n_conds * 128); not taken: the loop's
// compare and jump.
__global__ void __launch_bounds__(kThreads)
kb_cond_kernel(const float* __restrict__ rcol, const float* __restrict__ tri,
               int n_conds, int taken, float* __restrict__ out) {
  __shared__ float s[kBlocks][kRows][kThreads];
  stage_table(tri, s);
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float ox = rcol[8 * i], oy = rcol[8 * i + 1], oz = rcol[8 * i + 2];
  const int lo = taken ? 0 : n_conds;
  float t_best = kMiss;
  for (int j = 0; j < n_conds; ++j) {
    if (j >= lo) t_best = fminf(t_best, cond_leaf(s[j % kBlocks], ox, oy, oz));
  }
  out[i] = t_best;
}

// ctz: one conditional leaf per set bit of the runtime 32-bit `word`, at
// row block (bit index % 8), lowest bit first: c = __ffs(bits) - 1, then
// bits &= bits - 1 (the TPU's 31 - clz(bits & -bits)). Bound on this card:
// arithmetic, 6 operations per ray, lane and set bit; the probe measures
// what the bit loop adds to it.
__global__ void __launch_bounds__(kThreads)
kb_ctz_kernel(const float* __restrict__ rcol, const float* __restrict__ tri,
              uint32_t word, float* __restrict__ out) {
  __shared__ float s[kBlocks][kRows][kThreads];
  stage_table(tri, s);
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float ox = rcol[8 * i], oy = rcol[8 * i + 1], oz = rcol[8 * i + 2];
  float t_best = kMiss;
  for (uint32_t bits = word; bits != 0u; bits &= bits - 1u) {
    const int c = __ffs((int)bits) - 1;
    t_best = fminf(t_best, cond_leaf(s[c % kBlocks], ox, oy, oz));
  }
  out[i] = t_best;
}

inline unsigned int n_tiles(int64_t n) { return (unsigned int)(n / kThreads); }

}  // namespace

extern "C" {

// Every entry: rcol (n, 8) f32, n a positive multiple of 128; tri (128, 128)
// f32; out (n, 1) f32.

int pr_kb_leaf(const void* rcol, const void* tri, int64_t n, int n_leaves,
               void* out, void* stream) {
  kb_leaf_kernel<<<n_tiles(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rcol, (const float*)tri, n_leaves, (float*)out);
  return (int)cudaGetLastError();
}

int pr_kb_extract(const void* rcol, int64_t n, int n_ext, void* out,
                  void* stream) {
  kb_extract_kernel<<<n_tiles(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rcol, n_ext, (float*)out);
  return (int)cudaGetLastError();
}

int pr_kb_cond(const void* rcol, const void* tri, int64_t n, int n_conds,
               int taken, void* out, void* stream) {
  kb_cond_kernel<<<n_tiles(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rcol, (const float*)tri, n_conds, taken, (float*)out);
  return (int)cudaGetLastError();
}

int pr_kb_ctz(const void* rcol, const void* tri, int64_t n, uint32_t word,
              void* out, void* stream) {
  kb_ctz_kernel<<<n_tiles(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rcol, (const float*)tri, word, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
