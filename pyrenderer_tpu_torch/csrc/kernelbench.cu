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
// extract and ctz run one block of 128 threads per 128-ray tile, one thread
// per ray (N / 128 blocks: 256 at the harness's shape, under two blocks per
// SM of the card's 132); ctz stages the rows it reads of the (128, 128)
// triangle table -- 8 row blocks x 9 rows x 128 floats = 36,864 bytes -- in
// static shared memory, and every thread of a block then reads the same
// triangle in the same cycle (a broadcast). leaf and cond have designs of
// their own, described beside each.
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

#include "rcp.cuh"

namespace {

constexpr int kThreads = 128;     // rays per tile = threads per block
constexpr int kBlocks = 8;        // row blocks of the table (j % 8)
constexpr int kRows = 9;          // rows read per block: v0 | e1 | e2
constexpr int kBlockStride = 16;  // table rows per block
constexpr float kMiss = 3.0e38f;

// Stage rows (b * 16 + r), b < 8, r < 9, of the (128, 128) table (ctz).
__device__ __forceinline__ void stage_table(const float* __restrict__ tri,
                                            float (*s)[kRows][kThreads]) {
  for (int b = 0; b < kBlocks; ++b)
    for (int r = 0; r < kRows; ++r)
      s[b][r][threadIdx.x] = tri[(b * kBlockStride + r) * kThreads + threadIdx.x];
}

// One conditional leaf of _ctz_kernel: the min over the block's 128 lanes
// of (v0x - ox)(v0y - oy)(v0z - oz). (The cond kernel, which asked the same
// question of a branch, has its own below.)
__device__ __forceinline__ float cond_leaf(const float (*b)[kThreads],
                                           float ox, float oy, float oz) {
  float m = kMiss;
  for (int k = 0; k < kThreads; ++k)
    m = fminf(m, (b[0][k] - ox) * (b[1][k] - oy) * (b[2][k] - oz));
  return m;
}

// ---------------------------------------------------------------------------
// leaf (B9): n_leaves unconditional Moeller-Trumbore leaves of 128 triangles.
//
// Bound on this card: issued instructions. A test is ~60 fp32 operations
// (N * n_leaves * 128 tests; the bytes are 36 per ray), and with
// -fmad=false and the IEEE reciprocal every operation issues alone: 67.6
// SASS instructions a test on the fast path with the shared loads, the
// reciprocal's refinement and the selects. At 132 SMs x 128 lanes x 1,980
// MHz that floor is 0.5426 ms at the harness's 256 tiles x 128 rays x 64
// leaves, 2.26x the 67 TFLOP/s bound.
//
// Measured alone (CUDA-graph replay, one H100 80GB HBM3 at 700 W, PERF.md;
// the kernel this design replaced in brackets): L = 64 0.6044-0.6083 ms
// (1.1012-1.1033), 1.11x the floor; L = 16 0.1541-0.1548 (0.2771-0.2782);
// L = 4 0.0415-0.0418 (0.0709-0.0712). At L = 64 G = 1, 2, 4 took 0.6905,
// 0.6290, 0.6114 ms, G = 8 0.6046. ptxas (sm_90a, -O3 -fmad=false): 39
// registers, 36,864 bytes of shared memory, no spill (replaced: 80).
//
// The design (the kernel it replaced ran one thread per ray, 128 a block:
// 1,024 warps on 132 SMs, two per scheduler, each through 8,192 tests in a
// row, with nine scalar shared loads a test):
//   - G = kLeafLanes lanes share a ray: lane g tests triangles g, g + G,
//     ... of every leaf, so N rays make N * G / 32 warps.
//   - The table is staged once per block as two float4 and one float per
//     triangle (v0.xyz e1.x | e1.yz e2.xy | e2.z): three shared loads a
//     test; with G > 1 neighbouring lanes read neighbouring triangles.
//   - Two triangles' arithmetic is computed before either is selected, with
//     one branch of the reciprocal's fast path for both (rcp.cuh inv_pair).
//
// Why the lane split gives the serial loop's minimum, bit for bit: the
// serial result is the least t over every test that passes (det != 0, t >
// 1e-4, u, v in the triangle) with t below the minimum held when the test
// ran, or 3e38 if none passes. "t < held minimum" only drops a t that is not
// below a value already held, and the held value never rises, so dropping
// it cannot change the final minimum: the result is the least passing t
// below 3e38, for any split of the tests over lanes and any order. Each
// lane keeps its own running minimum over its tests and the G lanes take
// the minimum of theirs once, after the last leaf (min is exact; t > 1e-4
// excludes NaN and zeros of either sign). Every leaf still runs every test:
// leaves j and j + 8 read the same row block, and none is skipped.
constexpr int kLeafThreads = 256;                     // threads per block
constexpr int kLeafLanes = 8;                         // lanes per ray (G)
constexpr int kLeafRays = kLeafThreads / kLeafLanes;  // rays per block
constexpr int kTris = 128;                            // triangles per row block

struct LeafTable {
  float4 a[kBlocks][kTris];  // v0x v0y v0z e1x
  float4 b[kBlocks][kTris];  // e1y e1z e2x e2y
  float c[kBlocks][kTris];   // e2z
};

// Stage the 8 row blocks' 128 triangles: one triangle a thread, each row
// read coalesced.
__device__ __forceinline__ void stage_leaf_table(const float* __restrict__ tri,
                                                 LeafTable& s) {
  for (int e = threadIdx.x; e < kBlocks * kTris; e += kLeafThreads) {
    const int b = e / kTris, k = e % kTris;
    const float* p = tri + b * kBlockStride * kTris + k;
    float r[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) r[q] = p[q * kTris];
    s.a[b][k] = make_float4(r[0], r[1], r[2], r[3]);
    s.b[b][k] = make_float4(r[4], r[5], r[6], r[7]);
    s.c[b][k] = r[8];
  }
}

struct LeafRay {
  float ox, oy, oz, dx, dy, dz;
};

// The part of a test before 1/det, in perf/kernelbench.py:76-97's order:
// det and the three dot products that inv scales.
struct LeafTerms {
  float det, qe, qd, cs;
};

__device__ __forceinline__ LeafTerms leaf_terms(const LeafTable& s, int b, int k,
                                                const LeafRay& r) {
  const float4 a = s.a[b][k];
  const float4 bb = s.b[b][k];
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = bb.x, e1z = bb.y;
  const float e2x = bb.z, e2y = bb.w, e2z = s.c[b][k];
  const float cx = e1y * r.dz - e1z * r.dy;
  const float cy = e1z * r.dx - e1x * r.dz;
  const float cz = e1x * r.dy - e1y * r.dx;
  const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  const float qx = sy * e2z - sz * e2y;
  const float qy = sz * e2x - sx * e2z;
  const float qz = sx * e2y - sy * e2x;
  LeafTerms m;
  m.det = cx * e2x + cy * e2y + cz * e2z;
  m.qe = qx * e1x + qy * e1y + qz * e1z;
  m.qd = qx * r.dx + qy * r.dy + qz * r.dz;
  m.cs = cx * sx + cy * sy + cz * sz;
  return m;
}

// The rest of the test, against the lane's running minimum t_best: writes
// the candidate t and returns whether it passes and lies below t_best.
__device__ __forceinline__ bool leaf_accept(const LeafTerms& m, float inv,
                                            float t_best, float* t_out) {
  const float t = -inv * m.qe;
  const float u = -inv * m.qd;
  const float v = inv * m.cs;
  *t_out = t;
  return (fabsf(m.det) > 0.0f) & (t > 1e-4f) & (t < t_best) & (u >= 0.0f) &
         (u <= 1.0f) & (v >= 0.0f) & (1.0f - u - v >= 0.0f);
}

// n is a multiple of 128, so every block's kLeafRays rays are in range.
__global__ void __launch_bounds__(kLeafThreads)
kb_leaf_kernel(const float* __restrict__ rcol, const float* __restrict__ tri,
               int n_leaves, float* __restrict__ out) {
  constexpr int G = kLeafLanes;
  __shared__ LeafTable s;
  stage_leaf_table(tri, s);
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kLeafRays + threadIdx.x / G;
  const int g = threadIdx.x % G;
  const float* row = rcol + 8 * i;
  const LeafRay r{row[0], row[1], row[2], row[3], row[4], row[5]};
  float t_best = kMiss;
  for (int j = 0; j < n_leaves; ++j) {
    const int b = j % kBlocks;
    // lane g's two tests of a step: triangles k + g and k + g + G
#pragma unroll 4
    for (int k = 0; k < kTris; k += 2 * G) {
      const LeafTerms ma = leaf_terms(s, b, k + g, r);
      const LeafTerms mb = leaf_terms(s, b, k + g + G, r);
      float ia, ib, ta, tb;
      inv_pair(ma.det, mb.det, &ia, &ib);
      const bool oka = leaf_accept(ma, ia, t_best, &ta);
      t_best = oka ? ta : t_best;
      const bool okb = leaf_accept(mb, ib, t_best, &tb);
      t_best = okb ? tb : t_best;
    }
  }
  // the least of the G lanes' minima
#pragma unroll
  for (int d = G / 2; d > 0; d /= 2)
    t_best = fminf(t_best, __shfl_xor_sync(0xffffffffu, t_best, d));
  if (g == 0) out[i] = t_best;
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

// ---------------------------------------------------------------------------
// cond (B11): n_conds uniform branches, each over one conditional leaf: the
// min over the row block's 128 triangles of (v0x - ox)(v0y - oy)(v0z - oz).
// The branch is taken when j >= lo, lo = 0 (taken) or n_conds (never
// taken), both runtime values, so the compiler keeps the branch and the
// loop; every thread of a block has the same j, so it costs no divergence.
// Not taken, the kernel does no leaf work.
//
// Bound on this card when taken: issued instructions, not arithmetic. A
// test is 6 fp32 operations (N * n_conds * 128 tests). The kernel this
// replaced ran one thread per ray (1,024 warps at the harness's shape, two
// per scheduler) and read the vertex coordinates with broadcast shared
// loads: 7.25 SASS instructions a test.
//
// The design: lanes over triangles, R = kCondRays rays a warp, 128 rays a
// block. Rows 0-2 of each row block are staged
// as they lie (12,288 bytes); for the leaf at hand lane l loads triangles
// 4 l .. 4 l + 3 with three float4 loads and tests them against each of
// the warp's R rays, whose origins it holds in registers: 3 loads per 4 R
// tests, 6.2 SASS instructions a test at R = 16, and R independent chains.
// Each ray's 32 lane minima meet in 5 __shfl_xor_sync + fminf after the
// last leaf; when no branch was taken every minimum is still 3e38 and the
// warp skips that step. The j loop is unrolled by 4, so the not-taken
// path, which runs once per warp (twice the replaced kernel's warps at R =
// 16), spends one count, compare and jump on four j.
//
// The result is the serial loop's: the minimum of the finite products is
// the same in any order and grouping (fminf is exact; it differs from the
// twin's torch.minimum only on NaN, which finite inputs never produce).
// Where a +0 and a -0 product tie for the minimum, which zero wins could
// depend on the order; on every operand set checked on the card (PERF.md)
// the outputs have the twin's bits.
//
// Measured alone (CUDA-graph replay, one H100 80GB HBM3 at 700 W, PERF.md;
// the replaced kernel in brackets): N = 64 taken 0.0605-0.0606 ms
// (0.0886), 1.21x its issue floor; N = 16 taken 0.0173 (0.0238); not
// taken, N = 64 0.0032 (0.0045) and N = 16 0.0026-0.0028 (0.0028-0.0031).
// Designs timed beside it and dropped: one thread per ray with float4
// broadcast loads (N = 64 taken 0.0771); the same with G lanes a ray, the
// lanes of a ray reading different float4s (0.0747 at G = 2, 0.1048 at G =
// 4 and 8: four shared-memory wavefronts a load); R = 8 and 32 (0.0634
// and 0.0714); lanes over triangles without the unrolled j loop (not taken
// 0.0049-0.0054 at N = 64). ptxas: 99 registers, 12,288 bytes of shared
// memory, no spill (replaced: 80 registers, 36,864 bytes).
constexpr int kCondRays = 16;                                // rays per warp (R)
constexpr int kCondSpan = 128;                               // rays per block
constexpr int kCondThreads = kCondSpan / kCondRays * 32;     // threads per block

__global__ void __launch_bounds__(kCondThreads)
kb_cond_kernel(const float* __restrict__ rcol, const float* __restrict__ tri,
               int n_conds, int taken, float* __restrict__ out) {
  constexpr int R = kCondRays;
  constexpr int kBlockThreads = kCondThreads;
  __shared__ __align__(16) float s[kBlocks][3][kThreads];
  // the 24 staged rows (row block b, coordinate c at row 3 b + c), a fixed
  // trip count: every load of a thread issued before its first store
#pragma unroll
  for (int q = 0; q < kBlocks * 3 * kThreads / kBlockThreads; ++q) {
    const int row = q * (kBlockThreads / kThreads) + threadIdx.x / kThreads;
    const int k = threadIdx.x % kThreads;
    s[row / 3][row % 3][k] = tri[(row / 3 * kBlockStride + row % 3) * kThreads + k];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int64_t first = (int64_t)blockIdx.x * kCondSpan + threadIdx.x / 32 * R;
  float ox[R], oy[R], oz[R], m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // scalar loads: the wrapper accepts any contiguous rcol, 16-byte
    // aligned or not, and these run once per ray
    const float* row = rcol + 8 * (first + r);
    ox[r] = row[0];
    oy[r] = row[1];
    oz[r] = row[2];
    m[r] = kMiss;
  }
  const int lo = taken ? 0 : n_conds;
  bool took = false;
  // four iterations a trip: the loop's count, compare and jump once for
  // four j, each j keeping its own branch
#pragma unroll 4
  for (int j = 0; j < n_conds; ++j) {
    if (j >= lo) {
      took = true;
      const float4 x = reinterpret_cast<const float4*>(s[j % kBlocks][0])[lane];
      const float4 y = reinterpret_cast<const float4*>(s[j % kBlocks][1])[lane];
      const float4 z = reinterpret_cast<const float4*>(s[j % kBlocks][2])[lane];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = fminf(m[r], (x.x - ox[r]) * (y.x - oy[r]) * (z.x - oz[r]));
        m[r] = fminf(m[r], (x.y - ox[r]) * (y.y - oy[r]) * (z.y - oz[r]));
        m[r] = fminf(m[r], (x.z - ox[r]) * (y.z - oy[r]) * (z.z - oz[r]));
        m[r] = fminf(m[r], (x.w - ox[r]) * (y.w - oy[r]) * (z.w - oz[r]));
      }
    }
  }
  float mine = kMiss;
  if (took) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int d = 16; d > 0; d /= 2)
        m[r] = fminf(m[r], __shfl_xor_sync(0xffffffffu, m[r], d));
      mine = lane == r ? m[r] : mine;
    }
  }
  if (lane < R) out[first + lane] = mine;
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
  kb_leaf_kernel<<<(unsigned int)(n / kLeafRays), kLeafThreads, 0, (cudaStream_t)stream>>>(
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
  kb_cond_kernel<<<(unsigned int)(n / kCondSpan), kCondThreads, 0, (cudaStream_t)stream>>>(
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
