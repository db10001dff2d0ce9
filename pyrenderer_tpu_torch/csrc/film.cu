// A uniform pass's results in film order (wrapper: kernels/film.py):
//   film_kernel, after each chunk of render/driver.py's pass: the chunk's
//     per-lane sums and sums of squares at each lane's pixel's row-major
//     film address, rows flipped (the film's row 0 is the image's top,
//     pixel y 0 its bottom), in a (2, H, W, 3) staging tensor: sums, then
//     squares.
//
// Replaces no TPU kernel: the JAX driver unpermutes a pass's Morton-order
// results on the host (fancy indexing, then a reversed-row view). Here the
// pass reaches the host already in film order, through one copy.
//
// What bounds it on this card: the launch. A float32 lane reads 24 bytes
// of sums and squares and 16 of pixel and writes 24; at 2^16 lanes that is
// ~4.2 MB, about a microsecond at 3.35 TB/s.
//
// The design: one thread a lane, three channels each, in float or double.
// It stores 0 + s and 0 + q, so a -0 turns +0 as a sum started from 0.0
// does (the driver's sums start from the first sample's values; with
// IEEE rounding 0 + (r0 + r1 ...) has the bits of (0 + r0) + r1 ...). The
// lanes of one launch are distinct pixels inside the film; a lane outside
// it stops the kernel (__trap), so that the launch fails and the next call
// that waits for the device raises, as the twin raises for such a pixel.
//
// The C entry point launches on the caller's stream, returns the
// cudaError_t of the launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// In: the chunk's sums and sqs (n, 3), its lanes' pixels px, py (x from the
// left, y from the bottom). Out: out (2, h, w, 3), sums then squares.
template <typename T>
__global__ void __launch_bounds__(kThreads) film_kernel(
    int64_t n, const T* __restrict__ sums, const T* __restrict__ sqs,
    const int64_t* __restrict__ px, const int64_t* __restrict__ py, int64_t w, int64_t h,
    T* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t x = px[i], y = py[i];
  if (x < 0 || x >= w || y < 0 || y >= h) __trap();
  T* sum = out + ((h - 1 - y) * w + x) * 3;
  T* sq = sum + h * w * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sum[c] = T(0) + sums[i * 3 + c];
    sq[c] = T(0) + sqs[i * 3 + c];
  }
}

template <typename T>
int launch(int64_t n, const void* sums, const void* sqs, const int64_t* px, const int64_t* py,
           int64_t w, int64_t h, void* out, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  film_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      n, (const T*)sums, (const T*)sqs, px, py, w, h, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One chunk into the staging tensor, in double if f64 (else float);
// operands as film_kernel says.
int pr_film(int64_t n, const void* sums, const void* sqs, const int64_t* px, const int64_t* py,
            int64_t w, int64_t h, int f64, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return f64 ? launch<double>(n, sums, sqs, px, py, w, h, out, (cudaStream_t)stream)
             : launch<float>(n, sums, sqs, px, py, w, h, out, (cudaStream_t)stream);
}

}  // extern "C"
