// Threefry-2x32 (Random123's schedule) of the counter RNG of rng.py, as
// device functions: the round function shared by the Threefry kernel
// (rng.cu) and the bounce kernels (bounce.cuh: pbrt.cu, reference.cu),
// which draw their own uniforms.
//
// The counter is (c0, c1) = (pixel, (sample << 12) | (bounce << 4) | use)
// under the key (k0, rng._KEY_TAG). All arithmetic is modulo 2^32, as the
// twin's int64 masking and the NumPy oracle's uint32 give it, so every
// output bit equals theirs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kKeyTag = 0x70617468u;

// rng._ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24)), for round r
__device__ __forceinline__ int rotation(int r) {
  switch (((r >> 2) & 1) * 4 + (r & 3)) {
    case 0: return 13;
    case 1: return 15;
    case 2: return 26;
    case 3: return 6;
    case 4: return 17;
    case 5: return 29;
    case 6: return 16;
    default: return 24;
  }
}

// ks[i % 3] without an indexed array (which would live in local memory
// where the index is not a constant)
__device__ __forceinline__ uint32_t subkey(int i, uint32_t k0, uint32_t k1, uint32_t k2) {
  const int m = i % 3;
  return m == 0 ? k0 : (m == 1 ? k1 : k2);
}

// The low 32 bits of operand p's lane i: int64 where wide, else int32.
__device__ __forceinline__ uint32_t word(const void* p, int64_t stride, bool wide, int64_t i) {
  return wide ? (uint32_t)((const int64_t*)p)[i * stride]
              : (uint32_t)((const int32_t*)p)[i * stride];
}

// Both output words of Threefry-2x32 for the counter (c0, c1) under the
// key (k0, kKeyTag), `rounds` rounds; subkeys are injected only after
// complete 4-round groups.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t c0, uint32_t c1, int rounds,
                                             uint32_t* w0, uint32_t* w1) {
  const uint32_t k1 = kKeyTag, k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  for (int r = 0; r < rounds; ++r) {
    x0 += x1;
    x1 = __funnelshift_l(x1, x1, rotation(r)) ^ x0;
    if ((r & 3) == 3) {
      const int g = r >> 2;
      x0 += subkey(g + 1, k0, k1, k2);
      x1 += subkey(g + 2, k0, k1, k2) + (uint32_t)(g + 1);
    }
  }
  *w0 = x0;
  *w1 = x1;
}

// rng._to_unit in float32: (x >> 8) * 2^-24, a 24-bit integer times a power
// of two, exact.
__device__ __forceinline__ float to_unit(uint32_t x) {
  return (float)(x >> 8) * 0x1p-24f;
}

}  // namespace
