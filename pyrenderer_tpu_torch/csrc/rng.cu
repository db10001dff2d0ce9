// Threefry-2x32 (Random123's schedule) for the counter RNG of rng.py
// (wrapper: kernels/threefry.py): one thread a lane, the 32-bit words in
// registers. The round function is threefry.cuh's, which the pbrt bounce
// (pbrt.cu) shares.
//
// Replaces no TPU kernel: the JAX package's RNG (pyrenderer_tpu/rng.py) is
// jnp elementwise ops that XLA fuses into its consumers. Eager PyTorch has
// no such fusion, so the plain twin (rng.threefry2x32, int64 words masked
// after every add and shift) makes ~170 elementwise launches an
// evaluation, and its host dispatch, not the device, bounds it. This kernel
// is one launch an evaluation.
//
// What bounds it on this card: the launch. An evaluation at 20 rounds is
// ~100 integer instructions a lane and reads at most 8 bytes of each
// per-lane counter operand and writes 4 or 8 bytes a word; at 2^16 lanes
// that is well under a microsecond of instructions or of HBM traffic,
// below the ~2-3 us a launch takes to start and drain.
//
// The counter is (c0, c1) = (pixel, (sample << 12) | (bounce << 4) | use),
// each operand either a per-lane int32 or int64 array with a stride (0 for
// one broadcast value) or folded by the wrapper into the constant c1_const
// (Python ints and CPU scalars). All arithmetic is modulo 2^32, as the
// twin's int64 masking and the NumPy oracle's uint32 give it, so every
// output bit equals theirs. The uniform mode writes the twin's _to_unit in
// float32, (x >> 8) * 2^-24: a 24-bit integer times a power of two, exact.
//
// Each C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// wide: bit 0 pixel, 1 sample, 2 bounce, 3 use are int64 (else int32); a
// null sample, bounce or use pointer means the operand is in c1_const.
// unit = 0: out0 (and out1 if not null) get word 0 (and 1) as int64 in
// [0, 2^32); unit != 0: the float32 uniforms of the same words.
__global__ void __launch_bounds__(kThreads) threefry_kernel(
    const void* pixel, int64_t pixel_stride, const void* sample, int64_t sample_stride,
    const void* bounce, int64_t bounce_stride, const void* use, int64_t use_stride,
    int wide, uint32_t c1_const, uint32_t k0, int rounds, int64_t n, int unit,
    void* out0, void* out1) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t c1 = c1_const;
  if (sample) c1 |= word(sample, sample_stride, wide & 2, i) << 12;
  if (bounce) c1 |= word(bounce, bounce_stride, wide & 4, i) << 4;
  if (use) c1 |= word(use, use_stride, wide & 8, i);
  uint32_t x0, x1;
  threefry2x32(k0, word(pixel, pixel_stride, wide & 1, i), c1, rounds, &x0, &x1);
  if (unit) {
    ((float*)out0)[i] = to_unit(x0);
    if (out1) ((float*)out1)[i] = to_unit(x1);
  } else {
    ((int64_t*)out0)[i] = (int64_t)x0;
    if (out1) ((int64_t*)out1)[i] = (int64_t)x1;
  }
}

}  // namespace

extern "C" {

// Threefry-2x32 under the key (k0, rng._KEY_TAG) for n lanes, `rounds`
// rounds; operands and outputs as threefry_kernel says.
int pr_threefry(const void* pixel, int64_t pixel_stride, const void* sample,
                int64_t sample_stride, const void* bounce, int64_t bounce_stride,
                const void* use, int64_t use_stride, int wide, uint32_t c1_const,
                uint32_t k0, int rounds, int64_t n, int unit, void* out0, void* out1,
                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  threefry_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pixel, pixel_stride, sample, sample_stride, bounce, bounce_stride, use, use_stride,
      wide, c1_const, k0, rounds, n, unit, out0, out1);
  return (int)cudaGetLastError();
}

}  // extern "C"
