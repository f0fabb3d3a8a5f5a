// f32 chain probes for NVIDIA Hopper (sm_90a): the card's own speed of
// light for scalar f32 code, which is what the path-trace kernels are.
//
// Replaces two TPU kernels:
//   * pathtrace_tpu/utils/roofline.py::_chain_kernel (K6, the peak probe):
//     every thread runs CHAINS = 8 independent register chains of kInner
//     ops a trip, FMA or multiply only, on per-element run-time
//     coefficients. Enough independent work to keep the f32 pipes full:
//     elements x trips x kInner x CHAINS ops over the time is the rate.
//   * the kernel of scripts/fma_probe.py::pallas_latency_probe (K7, the
//     latency probe): ONE dependent chain a thread (CHAINS = 1, no
//     instruction-level parallelism, few warps), six modes: the time over
//     trips x kInner is the latency of one chain step. Blocks run side by
//     side here (the TPU grid ran them one after the other), so the step
//     count of one thread, not of the grid, divides the time.
//
// What bounds it: operations, by design. Each thread reads two floats and
// writes one.
//
// What the design does about the ways such a probe goes wrong (all three
// seen on the TPU, roofline.py:388-395): a body of one op a trip measures
// the loop, so a trip is kInner = 32 unrolled steps of every chain;
// compile-time coefficients let the compiler compose the chain into one
// op, so a and x are loaded per element at run time; a single dependent
// chain measures latency, not throughput, so the peak mode runs 8 of them
// a thread, in registers. The sum of the chains is stored, so none is dead
// code. The path-trace sources are built with -fmad=false and this one
// shares their flags, so contraction is decided here, not by flag:
// __fmaf_rn where one fused op is meant, __fmul_rn then __fadd_rn where two
// are.

#include <cuda_runtime.h>

namespace {

constexpr int kInner = 32;  // chain steps a trip, unrolled
constexpr int kThreads = 256;

enum Mode { kMul = 0, kAdd = 1, kFma = 2, kMulThenAdd = 3, kAddAdd = 4, kFmaFma = 5 };

template <int MODE>
__device__ __forceinline__ float step(float x, float a, float b, float c) {
  switch (MODE) {
    case kMul: return __fmul_rn(x, a);
    case kAdd: return __fadd_rn(x, b);
    case kFma: return __fmaf_rn(x, a, b);
    case kMulThenAdd: return __fadd_rn(__fmul_rn(x, a), b);
    case kAddAdd: return __fadd_rn(__fadd_rn(x, b), c);
    default: return __fmaf_rn(__fmaf_rn(x, a, b), a, c);
  }
}

template <int MODE, int CHAINS>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x_in, const float* __restrict__ a_in,
             float* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = x_in[i], a = a_in[i];
  const float b = x * 1e-7f, c = x * 1e-9f;
  float xc[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) xc[j] = x * (1.0f + 0.001f * (float)j);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kInner; ++k) {
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) xc[j] = step<MODE>(xc[j], a, b, c);
    }
  }
  float acc = xc[0];
#pragma unroll
  for (int j = 1; j < CHAINS; ++j) acc = acc + xc[j];
  out[i] = acc;
}

template <int MODE>
cudaError_t launch(int chains, const float* x, const float* a, float* out, int n,
                   int iters, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  if (chains == 1) {
    chain_kernel<MODE, 1><<<grid, kThreads, 0, stream>>>(x, a, out, n, iters);
  } else {
    chain_kernel<MODE, 8><<<grid, kThreads, 0, stream>>>(x, a, out, n, iters);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. x, a and out are device buffers of n
// floats. mode 0 mul, 1 add, 2 fma, 3 mul_then_add, 4 add_add, 5 fma_fma;
// chains 1 (the latency probe) or 8 (the peak probe); every chain takes
// iters x 32 steps. Returns a cudaError_t: the launch's, or
// cudaErrorInvalidValue for bad arguments.
extern "C" int pt_probe_launch(const float* x, const float* a, float* out, int n,
                               int iters, int mode, int chains, void* stream) {
  if (x == nullptr || a == nullptr || out == nullptr || n < 1 || iters < 0 ||
      mode < kMul || mode > kFmaFma || (chains != 1 && chains != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMul: return (int)launch<kMul>(chains, x, a, out, n, iters, s);
    case kAdd: return (int)launch<kAdd>(chains, x, a, out, n, iters, s);
    case kFma: return (int)launch<kFma>(chains, x, a, out, n, iters, s);
    case kMulThenAdd: return (int)launch<kMulThenAdd>(chains, x, a, out, n, iters, s);
    case kAddAdd: return (int)launch<kAddAdd>(chains, x, a, out, n, iters, s);
    default: return (int)launch<kFmaFma>(chains, x, a, out, n, iters, s);
  }
}
