// Latencies of the instructions on a reduction's dependent chain, measured
// on the card: one warp runs a chain of kChain dependent instructions of one
// kind between two reads of the SM's cycle counter. perf/clusterbench.py
// builds this file on its own (it is no kernel of the renderer or of the
// probes) and turns the cycles into each SASS opcode's latency
// (chain_latencies), from which round_cycles reads the floor of the extract
// probe's rounds (csrc/kernelbench.cu kb_extract_kernel).
//
// Kinds (kind argument of pr_latency):
//   0 fadd      add.f32 x, x, y
//   1 fmul      mul.f32 x, x, y
//   2 fadd+fmax add.f32 x, x, y; max.f32 x, x, z (fmax = this - fadd)
//   3 shfl      shfl.sync.bfly.b32 u, u, 1
//   4 redux     redux.sync.max.u32 u, u (and the move back to a vector
//               register, an integer instruction)
//   5 key       u = the ordered-key map of u (shr.s32, or, xor: integer
//               instructions, as the extract probe's map runs them)
//   6 lds       ld.volatile.shared.u32 a, [a] (a pointer chase)
//   7 sts+lds   st.volatile.shared.u32 [p], u; ld.volatile.shared.u32 u, [p]
//   8 bar       bar.sync 0 in a block of one warp
//
// Each chain runs twice (the first pass warms the instruction cache); the
// second pass's cycles are written. The operands come from memory, so no
// chain can be folded; the chain's result is stored, so none is dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChain = 256;

__device__ __forceinline__ long long cycles() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

template <int Kind>
__global__ void __launch_bounds__(32)
lat_kernel(const float* __restrict__ in, long long* __restrict__ out,
           float* __restrict__ sink) {
  __shared__ unsigned s[32];
  const int lane = threadIdx.x;
  float x = in[lane], y = in[32 + lane], z = in[64 + lane];
  unsigned u = __float_as_uint(x);
  unsigned a = (unsigned)__cvta_generic_to_shared(&s[lane]);
  s[lane] = a;
  __syncwarp();
  long long t0 = 0, t1 = 0;
#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    __syncwarp();
    t0 = cycles();
#pragma unroll
    for (int i = 0; i < kChain; ++i) {
      if (Kind == 0) asm volatile("add.f32 %0, %0, %1;" : "+f"(x) : "f"(y));
      if (Kind == 1) asm volatile("mul.f32 %0, %0, %1;" : "+f"(x) : "f"(y));
      if (Kind == 2)
        asm volatile("add.f32 %0, %0, %1;\n\tmax.f32 %0, %0, %2;" : "+f"(x) : "f"(y), "f"(z));
      if (Kind == 3)
        asm volatile("shfl.sync.bfly.b32 %0, %0, 1, 0x1f, 0xffffffff;" : "+r"(u));
      if (Kind == 4) asm volatile("redux.sync.max.u32 %0, %0, 0xffffffff;" : "+r"(u));
      if (Kind == 5)
        asm volatile(
            "{\n\t.reg .u32 t;\n\tshr.s32 t, %0, 31;\n\tor.b32 t, t, 0x80000000;\n\t"
            "xor.b32 %0, %0, t;\n\t}"
            : "+r"(u));
      if (Kind == 6) asm volatile("ld.volatile.shared.u32 %0, [%0];" : "+r"(a)::"memory");
      if (Kind == 7)
        asm volatile("st.volatile.shared.u32 [%1], %0;\n\tld.volatile.shared.u32 %0, [%1];"
                     : "+r"(u)
                     : "r"(a)
                     : "memory");
      if (Kind == 8) asm volatile("bar.sync 0;" ::: "memory");
    }
    t1 = cycles();
  }
  if (lane == 0) out[0] = t1 - t0;
  sink[lane] = x + __uint_as_float(u) + __uint_as_float(a);
}

template <int Kind>
int launch(const void* in, void* out, void* sink, cudaStream_t stream) {
  lat_kernel<Kind><<<1, 32, 0, stream>>>((const float*)in, (long long*)out, (float*)sink);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: 96 floats (x, y, z for each lane); out: one int64 (cycles of the
// second pass); sink: 32 floats. Returns the launch's cudaError_t, or -1
// for an unknown kind.
int pr_latency(int kind, const void* in, void* out, void* sink, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0: return launch<0>(in, out, sink, st);
    case 1: return launch<1>(in, out, sink, st);
    case 2: return launch<2>(in, out, sink, st);
    case 3: return launch<3>(in, out, sink, st);
    case 4: return launch<4>(in, out, sink, st);
    case 5: return launch<5>(in, out, sink, st);
    case 6: return launch<6>(in, out, sink, st);
    case 7: return launch<7>(in, out, sink, st);
    case 8: return launch<8>(in, out, sink, st);
    default: return -1;
  }
}

}  // extern "C"
