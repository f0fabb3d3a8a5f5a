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
// by hand, sweep.cuh's reverse sweep, instantiated for <diffuse or glossy,
// with or without NEE, with or without the AOV cotangents>. The estimator is
// the AD's: hit selection, near or far root, normal flip, shadow visibility
// and every random draw are detached.
//
// Without NEE the colour does not depend on geometry. A caller that passes a
// colour cotangent only (3 planes) then gets the shading-only instance: the
// shading chain alone, four tape words a bounce, no geometry slots, exact
// zeros in the geometry and camera outputs, and the shading sums of the full
// instance bit for bit. That is the instance of the glossy albedo recovery,
// two launches a step. With the 10 planes of the AOV cotangents, or under
// NEE, the geometry chain runs.
//
// The cotangent is read as [3 or 10, local_h, W] (channel planes, the TPU
// kernel's own layout): a thread reads one float of each plane, once, and
// a warp's reads of a plane are consecutive addresses, so every sector
// fetched is used; the callers' pack_cotangents builds it without a
// transpose.
//
// What bounds it: the instruction throughput of scalar f32 chains (607 to
// 1,331 counted operations a segment by instance: utils/roofline.py) and
// the warps an SM keeps resident to hide their latency. There is no matrix
// product in a scalar path tracer and no bulk tile to copy (a thread reads 3
// or 10 floats and writes none), so wgmma and TMA have nothing to do here;
// what the card offers this kernel is shared memory, registers, resident
// warps, its FP64 units and warp-level synchronisation.
//
// What the design does about it: one thread a pixel, the sample and bounce
// loops in the thread; sums shared by lane pairs, added in one pass, the
// geometry sums as doubles and the sphere table in dynamic shared memory
// (sweep.cuh: 20,584 bytes a 64-thread block with the geometry chain at
// N = 9, 7,528 without), so that registers limit the resident blocks (8 an
// SM with the geometry chain, 18 without, where one set of sums a thread
// allowed 5); the tape a local array where the kernel traces; kernels
// bounded for the block they are launched with; block sums in double in a
// fixed order,
// reduce_partials<double> over the blocks: no atomics, two launches give the
// same bits. On NEE diffuse with a colour-only cotangent it is
// nee_grad_kernel.cu's REPLAY instance, and with zeros in the AOV planes it
// runs additions of zero beside it: the same sums either way.
//
// REPLAY_TAPED (NEE glossy with a colour cotangent: the glossy inverse
// step's two replays) gives the retracing instance's sums, bit for bit,
// from the path tape that K1's taped NEE glossy colour pass
// (trace_kernel.cu) wrote for the same slab: it runs the sweep alone, where
// the retrace was 962.0 of the instance's 1,329.2 counted operations a
// segment, and reads the tape's 68 bytes a segment (17 words: the ray and t,
// the throughput, the cosine sample and the glossy jitter) a bounce ahead of
// the sweep, the first 14 through sweep.cuh's cp.async ring in shared memory
// and the jitter into registers: 27,752 bytes a 64-thread block, 110
// registers, 8 blocks an SM (with the jitter in the ring, 29,288 bytes left
// 7 and took a fifth longer: PERF.md).
//
// The scene, camera and seed blocks are device arrays, as the TPU kernel's
// SMEM operands (pallas_ad.py:254-256: scene [N, 10], cam [5, 3], seed [5]);
// the C entry point queues their copy into constant memory before the
// launch (common.cuh::stage_blocks), so a launch never waits for the card.
//
// Built with the forward kernel's flags (-fmad=false, no fast math).

#include "sweep.cuh"

using namespace pt;

namespace {

constexpr int kNumCt = 10;
// The TPU kernel's gradient block has 16 rows for N + 5 of them.
constexpr int kMaxAdSpheres = 11;

// ct: [AOV ? 10 : 3, local_h, W]. partial: [blocks, 10N + 16] block sums.
// path_tape: TAPED's path tape (sweep.cuh::PathTapeLayout, edge
// blockDim.x), which K1's taped colour pass wrote for these blocks. SMALL:
// at most kSmallThreads threads a block.
template <bool GLOSSY, bool NEE, bool AOV, bool SMALL, bool TAPED = false>
__global__ void __launch_bounds__(SMALL ? kSmallThreads : kMaxBlock * kMaxBlock,
                                  SMALL ? kSmallMinBlocks : 1)
ad_grad_kernel(const TraceParams p, const float* __restrict__ ct,
               double* __restrict__ partial, const float* __restrict__ path_tape) {
  static_assert(!TAPED || (GLOSSY && NEE && !AOV), "a K4 path tape is NEE glossy colour's");
  constexpr bool GEOM = NEE || AOV;
  extern __shared__ double smem[];
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = row < p.local_h && col < p.width;
  const SweepBlock blk(GEOM, p, smem, tid, threads, TAPED);

  float g[3] = {0.0f, 0.0f, 0.0f};
  float aov[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (inside) {
    const size_t plane = (size_t)p.local_h * p.width;
    const size_t px = (size_t)row * p.width + col;
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k] = ct[k * plane + px];
    if (AOV) {
#pragma unroll
      for (int k = 0; k < 7; ++k) aov[k] = ct[(3 + k) * plane + px];
    }
  }
  float rows = 0.0f, cols = 0.0f;
  Rng rng = pixel_rng<GLOSSY>(p, row, col, rows, cols);
  // Every thread of a warp sweeps, so that every lane trades with its
  // partner; one without a pixel has no path and trades zeros.
  if constexpr (TAPED) {
    // The paths K1 traced: every thread copies its words, inside or not
    // (the tape covers whole blocks), and sweeps them.
    constexpr int kWords = path_tape_words(GLOSSY);
    const PathTapeLayout<kWords> lay(p, blockDim.x);
    TapeRing<kWords> ring(p, lay, path_tape, blockIdx.y * gridDim.x + blockIdx.x, tid,
                          blk.ring(), inside);
    for (int s = 0; s < p.spp; ++s) {
      rng.sample = c_blocks.sample_offset + (uint32_t)s;
      reverse_sweep<GLOSSY, NEE, AOV>(p, blk.sph, rng, rows, cols, ring, 0, inside, g, aov,
                                      blk.acc);
    }
  } else {
    Tape tape = blk.tape();
    Sample out;
    for (int s = 0; s < p.spp; ++s) {
      rng.sample = c_blocks.sample_offset + (uint32_t)s;
      int n_hit = 0;
      if (inside) forward<GLOSSY, NEE, true, GEOM>(p, rng, rows, cols, out, tape, n_hit);
      reverse_sweep<GLOSSY, NEE, AOV>(p, blk.sph, rng, rows, cols, tape, n_hit, inside, g,
                                      aov, blk.acc);
    }
  }
  *blk.loss = 0.0f;  // the loss slot of the shared output layout
  blk.sums(tid, partial);
}

template <bool GLOSSY, bool NEE, bool AOV, bool TAPED = false>
const void* kernel_of(bool small) {
  return small ? (const void*)ad_grad_kernel<GLOSSY, NEE, AOV, true, TAPED>
               : (const void*)ad_grad_kernel<GLOSSY, NEE, AOV, false, TAPED>;
}

// The kernel of a configuration: 8 instances and the taped NEE glossy
// colour one, each bounded for small and for large blocks; nullptr for a
// taped configuration that has none.
const void* kernel_of(bool glossy, bool nee, bool aov, bool small, bool taped) {
  if (taped) return glossy && nee && !aov ? kernel_of<true, true, false, true>(small) : nullptr;
  if (glossy) {
    if (nee) return aov ? kernel_of<true, true, true>(small) : kernel_of<true, true, false>(small);
    return aov ? kernel_of<true, false, true>(small) : kernel_of<true, false, false>(small);
  }
  if (nee) return aov ? kernel_of<false, true, true>(small) : kernel_of<false, true, false>(small);
  return aov ? kernel_of<false, false, true>(small) : kernel_of<false, false, false>(small);
}

int shared_bytes(bool nee, bool aov, bool taped, int num_spheres, int threads) {
  return SweepLayout(nee || aov, num_spheres, threads, taped).bytes();
}

}  // namespace

// A measurement hook, as nee_grad_kernel.cu's: out[0] resident blocks an SM,
// out[1] registers, out[2] dynamic shared bytes a block, out[3] local bytes a
// thread of the instance <glossy, nee, aov>, taped or not, launched with
// block x block threads.
extern "C" int pt_ad_grad_occupancy(int glossy, int nee, int aov, int taped, int block,
                                    int num_spheres, int* out) {
  const int threads = block * block;
  const void* fn = kernel_of(glossy != 0, nee != 0, aov != 0, threads <= kSmallThreads,
                             taped != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)kernel_occupancy(fn, threads, shared_bytes(nee, aov, taped, num_spheres, threads),
                              out);
}

// C entry point, bound with ctypes. scene [num_spheres, 10], cam [5, 3] and
// seed [5] are DEVICE arrays, as for pt_trace_launch. light_index < 0: no NEE.
// ct is a device buffer [num_ct, local_h, W] of floats, num_ct 3 (colour
// rgb) or 10 (colour rgb, normal xyz, albedo rgb, depth); partial a device
// buffer of ceil(W / block) * ceil(local_h / block) * (10N + 16) DOUBLES;
// out holds 10N + 16 floats: sphere i at 10 i (radius, position xyz,
// emission rgb, albedo rgb), the eye at 10N, the corner rays 00, 10, 01, 11
// at 10N + 3, and 0 at 10N + 15. path_tape: nullptr, or under NEE glossy
// with a colour cotangent (num_ct 3) the path tape that pt_trace_launch's
// taped colour pass wrote for this slab with tape_edge = block, whose paths
// the launch sweeps instead of tracing them again (REPLAY_TAPED: the same
// sums). Returns a cudaError_t: the launches', or cudaErrorInvalidValue for
// bad arguments (more than 11 spheres or 16 bounces, a block whose shared
// memory exceeds 227 KB, a tape for another configuration among them).
extern "C" int pt_ad_grad_launch(const float* scene, int num_spheres,
                                 const float* cam, const uint32_t* seed,
                                 int local_h, int width, float inv_width,
                                 float inv_height, int spp, float inv_spp,
                                 int max_bounces, int jitter, float push,
                                 int light_index, int glossy, int num_ct, int block,
                                 const float* ct, double* partial, float* out,
                                 void* stream, const float* path_tape) {
  TraceParams p;
  p.num_spheres = num_spheres;
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
  if (!valid_launch(scene, cam, seed, p) || num_spheres > kMaxAdSpheres ||
      max_bounces > kMaxBounces || block < 1 || block > kMaxBlock ||
      light_index >= num_spheres || ct == nullptr || (num_ct != 3 && num_ct != kNumCt) ||
      partial == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }

  const bool nee = light_index >= 0, aov = num_ct == kNumCt, taped = path_tape != nullptr;
  const int n_threads = block * block;
  const void* fn = kernel_of(glossy != 0, nee, aov, n_threads <= kSmallThreads, taped);
  const int smem = shared_bytes(nee, aov, taped, num_spheres, n_threads);
  if (fn == nullptr || smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> hold(launch_lock());
  err = stage_blocks(scene, num_spheres, cam, seed, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 threads(block, block);
  const dim3 grid((width + block - 1) / block, (local_h + block - 1) / block);
  const int n_out = 10 * num_spheres + 16;
  void* args[] = {(void*)&p, (void*)&ct, (void*)&partial, (void*)&path_tape};
  err = cudaLaunchKernel(fn, grid, threads, args, (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  reduce_partials<double><<<n_out, kReduceThreads, 0, s>>>(
      partial, (int)(grid.x * grid.y), n_out, out);
  return (int)cudaGetLastError();
}
