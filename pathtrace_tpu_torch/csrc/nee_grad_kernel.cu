// Hand-derived NEE diffuse gradient kernel for NVIDIA Hopper (sm_90a).
//
// Replaces pathtrace_tpu/ops/pallas_nee_grad.py::_nee_grad_kernel (K3): the
// gradient of a per-pixel colour loss with respect to ALL parameters of the
// NEE diffuse estimator: every sphere's radius, position, emission and
// albedo, the eye, and the four corner rays of the camera. Three modes:
//   FUSED:  loss + gradients of sum((mean - target)^2) and the mean colour
//           in one launch, in two loops over the samples of the thread's
//           own pixel: colour first, then the REPLAY sweep against
//           2 (mean - target) / spp. A thread owns its pixel, so it can do
//           this where a TPU tile, which carries the geometry cotangents as
//           coefficients of the unknown pixel cotangent through one
//           trajectory pass, could not;
//   REPLAY: gradients of sum(cotangent * colour sum) for a given per-pixel
//           cotangent, each sample traced again with the taped forward and
//           swept;
//   REPLAY_TAPED: REPLAY's sums, bit for bit, from the path tape that K1's
//           taped colour pass (trace_kernel.cu) wrote for the same frame:
//           the sweep alone (the inverse step's two replays).
//
// The estimator, the tape, the reverse sweep, the sums in shared memory and
// the fixed-order double-precision block sums are sweep.cuh's, shared with
// ad_grad_kernel.cu; this kernel is its <diffuse, NEE, colour cotangent
// only> instance with the three modes above. Like the TPU kernel's SMEM
// operands (pallas_nee_grad.py:787: scene [N, 10], cam [5, 3], seed [5]),
// the three blocks are device arrays; the C entry point queues their copy
// into constant memory before the launch (common.cuh::stage_blocks).
//
// What bounds it: the instruction throughput of scalar f32 chains (1,211.6
// counted operations a segment in REPLAY, three quarters of them the
// retrace; fused runs 2,102.4 with its colour pass and is held to the
// 1,973.6 that one pass over the samples needs: utils/roofline.py) and the
// warps an SM keeps resident to hide their latency. REPLAY_TAPED runs the
// sweep's quarter and reads 56 bytes a segment (293.6 MB at 256x256x16, 5
// bounces: at least 0.088 ms of the card's 3.35 TB/s), which a ring of two
// bounces a thread in shared memory, filled by cp.async one bounce ahead,
// keeps behind the sweep: 0.18 ms against REPLAY's 0.51 there (PERF.md).
// What the design does about it is sweep.cuh's: with N = 9 spheres a
// 64-thread block holds 20,584 bytes of shared memory (sums shared by lane
// pairs, the geometry sums as doubles, the sphere table; 27,752 with
// REPLAY_TAPED's ring), so that registers (102-112 a thread, at most 128:
// 8 blocks an SM where one set of sums a thread allowed 5), not shared
// memory, limit the resident blocks; the kernel is bounded for the block
// it is launched with. No matrix product and no bulk tile: wgmma has
// nothing to do here, and a bulk copy would move a block's words where
// each thread's own cp.async needs no barrier.
//
// Built with the forward kernel's flags (-fmad=false, no fast math): the
// paths are the forward's.

#include "sweep.cuh"

using namespace pt;

namespace {

enum Mode { kFused = 0, kReplay = 1, kReplayTaped = 2 };

// in_px: FUSED the target, REPLAY the cotangent (1/spp folded in), both
// [local_h, W, 3]. color: [local_h, W, 3] mean colour (FUSED only).
// partial: [blocks, 10N + 16] block sums. path_tape: REPLAY_TAPED's path
// tape (sweep.cuh::PathTapeLayout, edge blockDim.x), which K1's taped
// colour pass wrote for these blocks. SMALL: at most kSmallThreads threads
// a block.
template <int MODE, bool SMALL>
__global__ void __launch_bounds__(SMALL ? kSmallThreads : kMaxBlock * kMaxBlock,
                                  SMALL ? kSmallMinBlocks : 1)
nee_grad_kernel(const TraceParams p, const float* __restrict__ in_px,
                float* __restrict__ color, double* __restrict__ partial,
                const float* __restrict__ path_tape) {
  extern __shared__ double smem[];
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = row < p.local_h && col < p.width;
  const SweepBlock blk(true, p, smem, tid, threads, MODE == kReplayTaped);
  Tape tape = blk.tape();

  const size_t px = (size_t)row * p.width + col;
  float g[3] = {0.0f, 0.0f, 0.0f};
  float loss = 0.0f;
  const float no_aov[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float rows = 0.0f, cols = 0.0f;
  Rng rng = pixel_rng<false>(p, row, col, rows, cols);
  Sample out;
  int n_hit = 0;
  if (inside) {
    if (MODE != kFused) {
      g[0] = in_px[px * 3 + 0];
      g[1] = in_px[px * 3 + 1];
      g[2] = in_px[px * 3 + 2];
    }
    if (MODE == kFused) {
      // Pixel cotangent of sum((mean - target)^2); 1/denom is the caller's,
      // the spp average rides in g.
      float sum[3] = {0.0f, 0.0f, 0.0f};
      for (int s = 0; s < p.spp; ++s) {
        rng.sample = c_blocks.sample_offset + (uint32_t)s;
        forward<false, true, false, true>(p, rng, rows, cols, out, tape, n_hit);
        sum[0] += out.cr;
        sum[1] += out.cg;
        sum[2] += out.cb;
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float mean = sum[ch] * p.inv_spp;
        color[px * 3 + ch] = mean;
        const float res = mean - in_px[px * 3 + ch];
        loss += res * res;
        g[ch] = 2.0f * res * p.inv_spp;
      }
    }
  }
  // Every thread of a warp sweeps, so that every lane trades with its
  // partner; one without a pixel has no path and trades zeros.
  if constexpr (MODE == kReplayTaped) {
    // The paths K1 traced: every thread copies its words, inside or not
    // (the tape covers whole blocks), and sweeps them.
    constexpr int kWords = path_tape_words(false);
    const PathTapeLayout<kWords> lay(p, blockDim.x);
    TapeRing<kWords> ring(p, lay, path_tape, blockIdx.y * gridDim.x + blockIdx.x, tid,
                          blk.ring(), inside);
    for (int s = 0; s < p.spp; ++s) {
      rng.sample = c_blocks.sample_offset + (uint32_t)s;
      reverse_sweep<false, true, false>(p, blk.sph, rng, rows, cols, ring, 0, inside, g,
                                        no_aov, blk.acc);
    }
  } else {
    for (int s = 0; s < p.spp; ++s) {
      rng.sample = c_blocks.sample_offset + (uint32_t)s;
      n_hit = 0;
      if (inside) forward<false, true, true, true>(p, rng, rows, cols, out, tape, n_hit);
      reverse_sweep<false, true, false>(p, blk.sph, rng, rows, cols, tape, n_hit, inside, g,
                                        no_aov, blk.acc);
    }
  }
  *blk.loss = loss;
  blk.sums(tid, partial);
}

// pad_shared: dynamic shared bytes asked for beyond what the block uses.
template <int MODE, bool SMALL>
cudaError_t launch_bounded(const TraceParams& p, int block, int pad_shared,
                           const float* in_px, float* color, double* partial, float* out,
                           const float* path_tape, cudaStream_t stream) {
  const dim3 threads(block, block);
  const dim3 grid((p.width + block - 1) / block, (p.local_h + block - 1) / block);
  const int n_out = 10 * p.num_spheres + 16;
  const int smem =
      SweepLayout(true, p.num_spheres, block * block, MODE == kReplayTaped).bytes() +
      pad_shared;
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nee_grad_kernel<MODE, SMALL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  nee_grad_kernel<MODE, SMALL><<<grid, threads, smem, stream>>>(p, in_px, color, partial,
                                                                path_tape);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<double><<<n_out, kReduceThreads, 0, stream>>>(
      partial, (int)(grid.x * grid.y), n_out, out);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const TraceParams& p, int block, int pad_shared, const float* in_px,
                   float* color, double* partial, float* out, const float* path_tape,
                   cudaStream_t stream) {
  return block * block <= kSmallThreads
             ? launch_bounded<MODE, true>(p, block, pad_shared, in_px, color, partial, out,
                                          path_tape, stream)
             : launch_bounded<MODE, false>(p, block, pad_shared, in_px, color, partial, out,
                                           path_tape, stream);
}

template <int MODE>
const void* kernel_of(bool small) {
  return small ? (const void*)nee_grad_kernel<MODE, true>
               : (const void*)nee_grad_kernel<MODE, false>;
}

const void* kernel_of(int mode, bool small) {
  if (mode == kFused) return kernel_of<kFused>(small);
  return mode == kReplay ? kernel_of<kReplay>(small) : kernel_of<kReplayTaped>(small);
}

}  // namespace

// A measurement hook: out[0] resident blocks an SM of a block x block launch
// of `mode` with num_spheres spheres that asks for pad_shared dynamic shared
// bytes beyond its own, out[1] registers a thread, out[2] dynamic shared
// bytes a block, out[3] local (stack) bytes a thread.
extern "C" int pt_nee_grad_occupancy(int mode, int block, int num_spheres, int pad_shared,
                                     int* out) {
  if (mode < kFused || mode > kReplayTaped) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(mode, block * block <= kSmallThreads);
  const int smem =
      SweepLayout(true, num_spheres, block * block, mode == kReplayTaped).bytes() + pad_shared;
  return (int)kernel_occupancy(fn, block * block, smem, out);
}

// C entry point, bound with ctypes. scene [num_spheres, 10], cam [5, 3] and
// seed [5] are DEVICE arrays, as for pt_trace_launch. mode 0 FUSED (in_px the
// target; writes color, partial and out), 1 REPLAY (in_px the cotangent;
// writes partial and out), 2 REPLAY_TAPED (REPLAY's sums from path_tape, the
// path tape that pt_trace_launch's taped colour pass wrote for this frame
// with tape_edge = block, instead of tracing the paths again; the other
// modes take no tape). partial is a device buffer
// of ceil(W / block) * ceil(local_h / block) * (10N + 16) DOUBLES; out holds
// 10N + 16 floats: sphere i at 10 i (radius, position xyz, emission rgb,
// albedo rgb), the eye at 10N, the corner rays 00, 10, 01, 11 at 10N + 3,
// the loss (0 for REPLAY) at 10N + 15. Returns a cudaError_t: the launches', or
// cudaErrorInvalidValue for bad arguments (a block whose sums and sphere
// table exceed 227 KB of shared memory among them).
//
// pt_nee_grad_launch_padded is the same launch asking for pad_shared dynamic
// shared bytes it does not use, so that fewer blocks fit an SM: the
// measurement behind the occupancy curve, and nothing else calls it.
extern "C" int pt_nee_grad_launch_padded(const float* scene, int num_spheres,
                                         const float* cam, const uint32_t* seed,
                                         int local_h, int width, float inv_width,
                                         float inv_height, int spp, float inv_spp,
                                         int max_bounces, int jitter, float push,
                                         int light_index, int mode, int block,
                                         const float* in_px, float* color,
                                         double* partial, float* out, void* stream,
                                         int pad_shared, const float* path_tape) {
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
  if (!valid_launch(scene, cam, seed, p) || pad_shared < 0 || max_bounces > kMaxBounces ||
      block < 1 || block > kMaxBlock || mode < kFused || mode > kReplayTaped ||
      light_index < 0 || light_index >= num_spheres || in_px == nullptr ||
      (mode == kFused && color == nullptr) || partial == nullptr || out == nullptr ||
      (mode == kReplayTaped) != (path_tape != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> hold(launch_lock());
  const cudaError_t err = stage_blocks(scene, num_spheres, cam, seed, s);
  if (err != cudaSuccess) return (int)err;
  if (mode == kFused)
    return (int)launch<kFused>(p, block, pad_shared, in_px, color, partial, out, nullptr, s);
  if (mode == kReplay)
    return (int)launch<kReplay>(p, block, pad_shared, in_px, color, partial, out, nullptr, s);
  return (int)launch<kReplayTaped>(p, block, pad_shared, in_px, color, partial, out, path_tape,
                                   s);
}

extern "C" int pt_nee_grad_launch(const float* scene, int num_spheres,
                                  const float* cam, const uint32_t* seed,
                                  int local_h, int width, float inv_width,
                                  float inv_height, int spp, float inv_spp,
                                  int max_bounces, int jitter, float push,
                                  int light_index, int mode, int block,
                                  const float* in_px, float* color,
                                  double* partial, float* out, void* stream,
                                  const float* path_tape) {
  return pt_nee_grad_launch_padded(scene, num_spheres, cam, seed, local_h, width, inv_width,
                                   inv_height, spp, inv_spp, max_bounces, jitter, push,
                                   light_index, mode, block, in_px, color, partial, out,
                                   stream, 0, path_tape);
}
