// Hand-derived all-parameter backward of the path tracer for NVIDIA Hopper
// (sm_90a), for any configuration.
//
// Replaces pathtrace_tpu/ops/pallas_ad.py::_ad_grad_kernel (K4). For a slab
// of rows and a range of samples, the gradient, with respect to every
// sphere's radius, position, emission and albedo, the eye and the four
// corner rays of the camera, of
//     sum over pixels and samples of
//         ct[0:3] . colour + ct[3:6] . normal0 + ct[6:9] . albedo0 + ct[9] depth0
// for a 10-channel per-pixel cotangent ct (1/spp folded in by the caller);
// normal0, albedo0 and depth0 are a sample's bounce-0 AOVs, zero where its
// primary ray escapes. The TPU kernel is jax.vjp of the forward trajectory
// inside the kernel body. CUDA has no in-kernel AD: this is that vjp derived
// by hand, sweep.cuh's reverse sweep, instantiated for the four
// configurations <diffuse or glossy, with or without NEE>, always with the
// AOV cotangents. The estimator is the AD's: hit selection, near or far
// root, normal flip, shadow visibility and every random draw are detached.
//
// Without NEE and with a colour-only cotangent the colour does not depend
// on geometry, every geometric cotangent of the sweep is an exact zero, and
// so are the geometry and camera sums.
//
// The cotangent is read as [10, local_h, W] (channel planes, the TPU
// kernel's own layout): a thread reads one float of each plane, once, and
// a warp's reads of a plane are consecutive addresses, so every sector
// fetched is used; the callers' pack_cotangents builds it without a
// transpose. The colour planes are the first three, so a colour-only
// caller pads zeros behind them.
//
// What bounds it: compute (scalar f32 chains per thread), and occupancy
// through shared memory: with N = 9 a thread holds 156 accumulator floats
// (39 KB at 64 threads: five blocks an SM), as in nee_grad_kernel.cu.
//
// What the design does about it: one thread a pixel, the sample and bounce
// loops in the thread, a 32-byte tape entry a hit bounce in local memory,
// accumulators [slot][thread] in dynamic shared memory with Kahan
// compensation on the geometry slots, block sums in double in a fixed
// order, reduce_partials<double> over the blocks: no atomics, two launches
// give the same bits. On NEE diffuse with a colour-only cotangent it runs
// the same instructions as nee_grad_kernel.cu's REPLAY mode plus additions
// of zero, and gives the same sums.
//
// Built with the forward kernel's flags (-fmad=false, no fast math).

#include "sweep.cuh"

using namespace pt;

namespace {

constexpr int kNumCt = 10;
// The TPU kernel's gradient block has 16 rows for N + 5 of them.
constexpr int kMaxAdSpheres = 11;

// ct: [10, local_h, W]. partial: [blocks, 10N + 16] block sums.
template <bool GLOSSY, bool NEE>
__global__ void __launch_bounds__(kMaxBlock * kMaxBlock, 1)
ad_grad_kernel(const TraceParams p, const float* __restrict__ ct,
               double* __restrict__ partial) {
  extern __shared__ float smem[];
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = p.num_spheres;
  const int n_geom = 4 * n + 15;
  const int n_slots = acc_slots(n);
  const Acc acc = {smem + tid, threads, 6 * n, n_geom};
  for (int k = 0; k < n_slots; ++k) acc.base[k * threads] = 0.0f;

  if (row < p.local_h && col < p.width) {
    const size_t plane = (size_t)p.local_h * p.width;
    const size_t px = (size_t)row * p.width + col;
    float g[3], aov[7];
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k] = ct[k * plane + px];
#pragma unroll
    for (int k = 0; k < 7; ++k) aov[k] = ct[(3 + k) * plane + px];
    float rows, cols;
    Rng rng = pixel_rng<GLOSSY>(p, row, col, rows, cols);
    Sample out;
    BounceTape tape[kMaxBounces];
    int n_hit;
    for (int s = 0; s < p.spp; ++s) {
      rng.sample = p.sample_offset + (uint32_t)s;
      forward<GLOSSY, NEE, true>(p, rng, rows, cols, out, tape, n_hit);
      reverse_sweep<GLOSSY, NEE, true>(p, rng, rows, cols, tape, n_hit, g, aov, acc);
    }
  }
  // The compensation terms are spent: the first of their slots is the loss
  // slot of the shared output layout, 0 here.
  acc.base[(6 * n + n_geom) * threads] = 0.0f;

  block_sums(smem, tid, threads, n, partial);
}

template <bool GLOSSY, bool NEE>
cudaError_t launch(const TraceParams& p, int block, const float* ct, double* partial,
                   float* out, cudaStream_t stream) {
  const dim3 threads(block, block);
  const dim3 grid((p.width + block - 1) / block, (p.local_h + block - 1) / block);
  const int n_out = 10 * p.num_spheres + 16;
  const int smem = acc_slots(p.num_spheres) * block * block * (int)sizeof(float);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ad_grad_kernel<GLOSSY, NEE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ad_grad_kernel<GLOSSY, NEE><<<grid, threads, smem, stream>>>(p, ct, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<double><<<n_out, kReduceThreads, 0, stream>>>(
      partial, (int)(grid.x * grid.y), n_out, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. scene [num_spheres, 10], cam [5, 3] and
// seed [5] are HOST arrays, as for pt_trace_launch. light_index < 0: no NEE.
// ct is a device buffer [10, local_h, W] of floats (colour rgb, normal xyz,
// albedo rgb, depth); partial a device buffer of ceil(W / block) *
// ceil(local_h / block) * (10N + 16) DOUBLES; out holds 10N + 16 floats:
// sphere i at 10 i (radius, position xyz, emission rgb, albedo rgb), the
// eye at 10N, the corner rays 00, 10, 01, 11 at 10N + 3, and 0 at
// 10N + 15. Returns a cudaError_t: the launches', or cudaErrorInvalidValue
// for bad arguments (more than 11 spheres or 16 bounces, a block whose
// accumulators exceed 227 KB of shared memory among them).
extern "C" int pt_ad_grad_launch(const float* scene, int num_spheres,
                                 const float* cam, const uint32_t* seed,
                                 int local_h, int width, float inv_width,
                                 float inv_height, int spp, float inv_spp,
                                 int max_bounces, int jitter, float push,
                                 int light_index, int glossy, int block,
                                 const float* ct, double* partial, float* out,
                                 void* stream) {
  if (num_spheres < 1 || num_spheres > kMaxAdSpheres || local_h < 1 || width < 1 ||
      spp < 1 || max_bounces < 0 || max_bounces > kMaxBounces || block < 1 ||
      block > kMaxBlock || light_index >= num_spheres || ct == nullptr ||
      partial == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  TraceParams p;
  fill_params(p, scene, num_spheres, cam, seed);
  p.spp = spp;
  p.max_bounces = max_bounces;
  p.jitter = jitter;
  p.local_h = local_h;
  p.width = width;
  p.light_index = light_index;
  p.inv_width = inv_width;
  p.inv_height = inv_height;
  p.inv_spp = inv_spp;
  p.push = push;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool nee = light_index >= 0;
  if (glossy) {
    return (int)(nee ? launch<true, true>(p, block, ct, partial, out, s)
                     : launch<true, false>(p, block, ct, partial, out, s));
  }
  return (int)(nee ? launch<false, true>(p, block, ct, partial, out, s)
                   : launch<false, false>(p, block, ct, partial, out, s));
}
