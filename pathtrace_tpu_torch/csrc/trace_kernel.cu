// Forward path-trace kernel for NVIDIA Hopper (sm_90a).
//
// Replaces pathtrace_tpu/ops/pallas_trace.py::_pathtrace_kernel (per-sample
// body trace_tile_sample): the forward megakernel that turns a sphere scene
// and a camera into the 14-channel AOV buffer (colour, normal, albedo,
// depth means and four luminance variances), or into the 22 channels of
// mergeable partials (10 raw sums + Welford n/mean/M2 of four features), or
// into 3 channels of raw colour sums.
//
// What bounds it: compute. Each path segment costs about 500 f32 operations
// plus sin/cos/sqrt (9 sphere tests, the normal, the cosine bounce; NEE
// adds a shadow ray against 8 more spheres), and a pixel writes only 56
// bytes (14 channels) once, after all its samples. Nothing is read from
// device memory but the parameters and the scene, camera and seed blocks in
// constant memory.
//
// What the design does about it:
//   * A pixel's samples are spread over L sample lanes: neighbouring threads
//     of one warp, lane j tracing samples j, j + L, j + 2L, ... of the
//     pixel. At one thread a pixel a 256x256 frame is 2,048 warps, 15.5 an
//     SM, and the whole grid is resident at once: too few warps to hide the
//     latency of the scalar chains, and one long path holds a warp's tail.
//     The wrapper derives L (trace_kernel.sample_lanes): 1 where one thread
//     a pixel already gives every SM 1,024 threads (a 512x512 frame: lanes
//     would only add shuffles) and at 1 spp; else the largest power of two
//     up to 4 and up to spp with the block's pixels x L within 256 threads
//     (4 at 256x256 and 4+ spp in an 8x8 block). At L = 1 the wrapper
//     launches an instance compiled for one lane, which holds the registers
//     and the time of one thread a pixel; the run-time lane count cost
//     2-3% at 512x512 (PERF.md, PR 6). Blocks are 1-D: thread t is lane
//     t % L of pixel t / L, pixel q of the block at (q % block, q / block).
//   * The sums keep the thread-a-pixel order bit for bit: after each round
//     every lane of the pixel takes the round's samples from the lanes that
//     traced them (__shfl_sync within the L-wide group), in sample order,
//     and applies the same 10 adds and 4 Welford updates as the plain
//     version (trace_plain) does; an idle lane of the last round adds
//     nothing. Every lane holds the same sums (no divergent owner branches),
//     and lane j stores the channels c with c % L == j.
//   * The scene, camera and seed blocks are device arrays, as the TPU
//     kernel's scalar-prefetch operands are SMEM arrays (pallas_trace.py:
//     662-664: scene [N, 10], cam [5, 3], seed [5]). The C entry point queues
//     their copy into this library's constant memory on the launch's stream
//     (common.cuh::c_blocks, stage_blocks), so the launch never waits for
//     the card and a captured launch reads new block contents when it is
//     replayed. The kernel reads the rows from the constant bank: the sphere
//     tests load each row once for the warp. A copy in each block's shared memory, read there
//     by every test, held each value in a register of every thread: up to 29
//     more registers a thread, and 8-12% longer at 512x512 (PERF.md); a
//     shared copy of the winner's row alone was a tie or slower. The
//     gradient kernel keeps one, where its sweep reads those rows again.
//   * Every running sum stays in registers; the only stores are the final
//     channel vector, channels-last [h, W, C]. The ragged edge is
//     bounds-checked, nothing is padded.
//   * A path stops at its first escape: from there on the Pallas kernel
//     only carried masked no-ops, so every sum is unchanged.
//   * Output mode, BRDF, NEE and one lane or several are template
//     parameters, so each of the 12 variants (24 instances) compiles without
//     the code it does not run.
//   * The taped instances (NEE colour sums, diffuse or glossy, one lane or
//     several) are the inverse step's colour passes. Each traces a sample
//     with the reverse sweep's own taped forward (sweep.cuh), whose segment
//     is the one the other instances run, so its sums are theirs bit for
//     bit, and stores the words of each bounce (14 diffuse, 17 glossy) and
//     the hit count into the path tape that the taped replay of K3
//     (diffuse) or K4 (glossy) sweeps instead of tracing every path a
//     second time. What it adds is stores: 293.6 MB at 256x256x16 and 5
//     bounces diffuse, 1.43 GB a 256-row slab of 512x512x32 glossy, 4
//     sectors of 32 bytes a warp-wide store (8 pixels x 4 lanes), none of
//     them read back here.
//   * The first bounce (unnormalized primary ray, emission clamp, AOVs) is
//     peeled at compile time; the later bounces are one loop, because the
//     depth is a run-time flag.
//
// Random numbers: the counter-based lattice of pathtrace_tpu/rng.py, in
// uint32 arithmetic, so the kernel draws exactly the reference's uniforms.
// The arithmetic follows trace_tile_sample term for term (NDC as
// 2*c*(1/W)-1, rsqrt only for the primary ray, T_BIG = 1e6, the +1e-20
// guards) so that its results differ from the plain version only by
// rounding.
//
// The parameter block, the lattice and the path segment live in common.cuh,
// which the gradient kernels (grad_kernel.cu) share.
//
// Build (pathtrace_tpu_torch/ops/build.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libtrace_kernel.so trace_kernel.cu
// No --use_fast_math: sqrtf and division stay IEEE-rounded and sinf/cosf
// stay full-range. -fmad=false: with nvcc's default FMA contraction, 1.1%
// of the pixels of a 4-spp NEE frame flipped a hit decision against the
// plain PyTorch version on an H100 (0.2% diffuse, 0.04% glossy); without
// contraction the kernel matched it bit for bit in all nine
// configuration x mode cases.
//
// Registers: the variants take up to 87 registers a thread, so a block
// of more than 256 threads could not be bounded without spills. The kernel
// is compiled with __launch_bounds__(kMaxThreads = 256, 1): every block
// edge up to kMaxBlock = 16 launches (with fewer lanes where pixels x L
// would pass 256), and the entry point refuses larger ones
// (config.MAX_BLOCK on the Python side). The minimum of one block an SM
// matters: without it ptxas held four variants to 64 registers and spilled
// 16-24 bytes; with it, no spills: 44-80 registers at one lane, 48-87 with
// lanes (the shuffled values and the round loop). The taped NEE glossy
// instance is bounded for 3 blocks of 256 threads an SM instead: 80
// registers where it took 86-88 and kept 2, and 7-9% faster on a 256-row
// slab of 512x512x32, with no more stack (PERF.md).

#include "sweep.cuh"

using namespace pt;

namespace {

constexpr float kLumaR = 0.2126f, kLumaG = 0.7152f, kLumaB = 0.0722f;

template <bool GLOSSY, bool NEE>
__device__ __forceinline__ Sample trace_sample(const TraceParams& p, const Rng& rng,
                                               float rows, float cols) {
  Sample out = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, false};
  float dx, dy, dz;
  primary_ray(p, rng, rows, cols, dx, dy, dz);
  float ox = c_blocks.eye[0], oy = c_blocks.eye[1], oz = c_blocks.eye[2];
  float mr = 1.0f, mg = 1.0f, mb = 1.0f;
  int sel;

  if (p.max_bounces >= 1) {
    // An escaped path only carried masked no-ops in the Pallas kernel:
    // stopping here leaves every sum unchanged.
    if (!segment<true, GLOSSY, NEE>(p, c_blocks.sph, rng, 0, ox, oy, oz, dx, dy, dz, mr, mg, mb,
                                    out, sel))
      return out;
    for (int bounce = 1; bounce < p.max_bounces; ++bounce) {
      if (!segment<false, GLOSSY, NEE>(p, c_blocks.sph, rng, bounce, ox, oy, oz, dx, dy, dz, mr,
                                       mg, mb, out, sel))
        return out;
    }
  }
  out.active = true;  // never escaped: counts in the colour variance
  return out;
}

struct Welford {
  float n, mean, m2;
  __device__ __forceinline__ void add(float x, bool include) {
    const float inc = include ? 1.0f : 0.0f;
    const float n_new = n + inc;
    const float delta = x - mean;
    mean = mean + (n_new > 0.0f ? inc * delta / fmaxf(n_new, 1.0f) : 0.0f);
    const float delta2 = x - mean;
    m2 = m2 + inc * delta * delta2;
    n = n_new;
  }
  __device__ __forceinline__ float var() const {
    return n >= 2.0f ? m2 / fmaxf(n - 1.0f, 1.0f) : 0.0f;
  }
};

// block: the block's edge in pixels; lane_bits: log2 of the sample lanes L.
// LANED = false is the one-lane instance: L = 1 at compile time, so the
// shuffles, the round loop and the owner tests fold away. TAPED (NEE
// colour sums only): each sample is traced by the sweep's taped forward,
// the same segment with the same bits, which stores its bounces and hit
// count into path_tape (sweep.cuh::PathTapeLayout, path_tape_words(GLOSSY)
// words a bounce, for a replay in blocks of tape_edge x tape_edge) for the
// taped replay of K3 (diffuse) or K4 (glossy).
template <int NCH, bool GLOSSY, bool NEE, bool LANED, bool TAPED = false>
__global__ void __launch_bounds__(kMaxThreads, TAPED && GLOSSY ? 3 : 1)
pathtrace_kernel(const TraceParams p, int block, int lane_bits_arg, float* __restrict__ out,
                 float* __restrict__ path_tape, int tape_edge) {
  static_assert(!TAPED || (NCH == 3 && NEE), "a path tape is an NEE colour pass's");
  constexpr int kTapeWords = path_tape_words(GLOSSY);
  const int tid = threadIdx.x;
  const unsigned mask = __activemask();  // the warp's threads, all of them here
  const int lane_bits = LANED ? lane_bits_arg : 0;
  const int lanes = 1 << lane_bits;
  const int lane = tid & (lanes - 1);
  const int q = tid >> lane_bits;
  const int col = blockIdx.x * block + q % block;
  const int row = blockIdx.y * block + q / block;
  const bool inside = row < p.local_h && col < p.width;
  if (!LANED && !inside) return;  // no other lane shuffles with it

  float rows, cols;
  Rng rng = pixel_rng<GLOSSY>(p, row, col, rows, cols);
  size_t tape_at = 0;  // word 0 of this pixel's sample 0 (TAPED)
  size_t tape_sample = 0;
  int tape_stride = 0;
  if constexpr (TAPED) {
    const PathTapeLayout<kTapeWords> lay(p, tape_edge);
    if (inside) tape_at = lay.pixel(row, col);
    tape_sample = lay.sample;
    tape_stride = lay.threads;
  }

  float sum[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  Welford w_c = {0.f, 0.f, 0.f}, w_n = {0.f, 0.f, 0.f};
  Welford w_a = {0.f, 0.f, 0.f}, w_d = {0.f, 0.f, 0.f};
  for (int base = 0; base < p.spp; base += lanes) {
    Sample o = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, false};
    if (inside && base + lane < p.spp) {
      rng.sample = c_blocks.sample_offset + (uint32_t)(base + lane);
      if constexpr (TAPED) {
        TapeWriter<kTapeWords> w = {path_tape + tape_at + (base + lane) * tape_sample,
                                    tape_stride, p.max_bounces - 1};
        int n_hit;
        forward<GLOSSY, true, true, true>(p, rng, rows, cols, o, w, n_hit);
      } else {
        o = trace_sample<GLOSSY, NEE>(p, rng, rows, cols);
      }
    }
    // The round's samples in sample order, from the lanes that traced them.
    const int flags = (o.active ? 1 : 0) | (o.hit0 ? 2 : 0);
    for (int j = 0; j < lanes && base + j < p.spp; ++j) {
      const float cr = lane_value(mask, o.cr, j, lanes);
      const float cg = lane_value(mask, o.cg, j, lanes);
      const float cb = lane_value(mask, o.cb, j, lanes);
      sum[0] += cr;
      sum[1] += cg;
      sum[2] += cb;
      if (NCH == 3) continue;
      const float nx = lane_value(mask, o.nx, j, lanes);
      const float ny = lane_value(mask, o.ny, j, lanes);
      const float nz = lane_value(mask, o.nz, j, lanes);
      const float ar = lane_value(mask, o.ar, j, lanes);
      const float ag = lane_value(mask, o.ag, j, lanes);
      const float ab = lane_value(mask, o.ab, j, lanes);
      const float d = lane_value(mask, o.d, j, lanes);
      const int f = lane_value(mask, flags, j, lanes);
      const bool active = (f & 1) != 0, hit0 = (f & 2) != 0;
      sum[3] += nx;
      sum[4] += ny;
      sum[5] += nz;
      sum[6] += ar;
      sum[7] += ag;
      sum[8] += ab;
      sum[9] += d;
      w_c.add(kLumaR * cr + kLumaG * cg + kLumaB * cb, active);
      w_n.add(kLumaR * nx + kLumaG * ny + kLumaB * nz, hit0);
      w_a.add(kLumaR * ar + kLumaG * ag + kLumaB * ab, hit0);
      w_d.add(d, hit0);
    }
  }
  if (!inside) return;

  float v[NCH];
  if constexpr (NCH == 3) {
    v[0] = sum[0];
    v[1] = sum[1];
    v[2] = sum[2];
  } else if constexpr (NCH == 22) {
#pragma unroll
    for (int k = 0; k < 10; ++k) v[k] = sum[k];
    v[10] = w_c.n;
    v[11] = w_c.mean;
    v[12] = w_c.m2;
    v[13] = w_n.n;
    v[14] = w_n.mean;
    v[15] = w_n.m2;
    v[16] = w_a.n;
    v[17] = w_a.mean;
    v[18] = w_a.m2;
    v[19] = w_d.n;
    v[20] = w_d.mean;
    v[21] = w_d.m2;
  } else {
#pragma unroll
    for (int k = 0; k < 10; ++k) v[k] = sum[k] * p.inv_spp;
    v[10] = w_c.var();
    v[11] = w_n.var();
    v[12] = w_a.var();
    v[13] = w_d.var();
  }
  float* px = out + ((size_t)row * p.width + col) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if ((c & (lanes - 1)) == lane) px[c] = v[c];
  }
}

template <int NCH, bool GLOSSY, bool NEE, bool TAPED = false>
const void* instance(bool laned) {
  return laned ? (const void*)pathtrace_kernel<NCH, GLOSSY, NEE, true, TAPED>
               : (const void*)pathtrace_kernel<NCH, GLOSSY, NEE, false, TAPED>;
}

template <int NCH>
const void* instance(bool glossy, bool nee, bool laned) {
  if (glossy) return nee ? instance<NCH, true, true>(laned) : instance<NCH, true, false>(laned);
  return nee ? instance<NCH, false, true>(laned) : instance<NCH, false, false>(laned);
}

// The kernel of a launch with n_channels channels and 2^lane_bits sample
// lanes that writes a path tape or not, or nullptr for a mode that does not
// exist.
const void* kernel_of(int n_channels, bool glossy, bool nee, int lane_bits, bool taped) {
  const bool laned = lane_bits > 0;
  if (taped) {
    if (n_channels != 3 || !nee) return nullptr;
    return glossy ? instance<3, true, true, true>(laned) : instance<3, false, true, true>(laned);
  }
  switch (n_channels) {
    case 14: return instance<14>(glossy, nee, laned);
    case 22: return instance<22>(glossy, nee, laned);
    case 3: return instance<3>(glossy, nee, laned);
    default: return nullptr;
  }
}

cudaError_t launch(const void* fn, TraceParams p, int block, int lane_bits, int pad_shared,
                   float* out, float* path_tape, int tape_edge, cudaStream_t stream) {
  const dim3 grid((p.width + block - 1) / block, (p.local_h + block - 1) / block);
  if (pad_shared > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, pad_shared);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&p, &block, &lane_bits, &out, &path_tape, &tape_edge};
  return cudaLaunchKernel(fn, grid, dim3((block * block) << lane_bits), args, pad_shared,
                          stream);
}

}  // namespace

// C entry point, bound with ctypes. scene [num_spheres, 10] (radius, pos
// xyz, emission rgb, colour rgb), cam [5, 3] (eye, corner rays 00, 10, 01,
// 11) and seed [5] (seed, frame, sample/row/col offsets) are DEVICE arrays:
// the call queues their copy into constant memory and the launch on
// `stream` (common.cuh::stage_blocks) and does not wait for the card; out
// is a device buffer of local_h * width * n_channels floats. Returns a
// cudaError_t: the copies' or the launch's, or cudaErrorInvalidValue for
// bad arguments.
// block is the edge of the square block in pixels, 1..kMaxBlock; lanes the
// sample lanes a pixel, 1, 2 or 4 with block^2 x lanes <= kMaxThreads.
// path_tape: nullptr, or for NEE colour sums (n_channels 3) a device buffer
// of spp * ceil(W / tape_edge) * ceil(local_h / tape_edge) * max_bounces *
// words * tape_edge^2 floats, words 14 diffuse and 17 glossy, that the
// launch fills with the paths it traces, laid out for the taped replay of
// pt_nee_grad_launch (diffuse) or pt_ad_grad_launch (glossy) in blocks of
// tape_edge x tape_edge (sweep.cuh::PathTapeLayout); its colour sums are the
// untaped launch's, bit for bit.
//
// pt_trace_launch_padded is the same launch asking for pad_shared dynamic
// shared bytes it does not use, so that fewer blocks fit an SM: the
// measurement behind the occupancy curve, and nothing else passes a pad.
extern "C" int pt_trace_launch_padded(const float* scene, int num_spheres,
                                      const float* cam, const uint32_t* seed,
                                      int local_h, int width, float inv_width,
                                      float inv_height, int spp, float inv_spp,
                                      int max_bounces, int jitter, float push,
                                      int light_index, int glossy, int n_channels,
                                      int block, int lanes, float* out, void* stream,
                                      int pad_shared, float* path_tape, int tape_edge) {
  const bool nee = light_index >= 0;
  const bool taped = path_tape != nullptr;
  const int lane_bits = lane_bits_of(block, lanes);
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
  const void* fn = kernel_of(n_channels, glossy != 0, nee, lane_bits, taped);
  if (!valid_launch(scene, cam, seed, p) || pad_shared < 0 || pad_shared > kMaxSharedBytes ||
      block < 1 || block > kMaxBlock || lane_bits < 0 || (nee && light_index >= num_spheres) ||
      out == nullptr || fn == nullptr ||
      (taped && (tape_edge < 1 || tape_edge > kMaxBlock || max_bounces > kMaxBounces))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> hold(launch_lock());
  const cudaError_t err = stage_blocks(scene, num_spheres, cam, seed, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(fn, p, block, lane_bits, pad_shared, out, path_tape, tape_edge, s);
}

extern "C" int pt_trace_launch(const float* scene, int num_spheres, const float* cam,
                               const uint32_t* seed, int local_h, int width,
                               float inv_width, float inv_height, int spp, float inv_spp,
                               int max_bounces, int jitter, float push, int light_index,
                               int glossy, int n_channels, int block, int lanes, float* out,
                               void* stream, float* path_tape, int tape_edge) {
  return pt_trace_launch_padded(scene, num_spheres, cam, seed, local_h, width, inv_width,
                                inv_height, spp, inv_spp, max_bounces, jitter, push,
                                light_index, glossy, n_channels, block, lanes, out, stream, 0,
                                path_tape, tape_edge);
}

// A measurement hook: out[0] resident blocks an SM of a launch of the
// variant (n_channels, glossy, nee, taped) with block x block pixels and
// `lanes` sample lanes that asks for pad_shared dynamic shared bytes, out[1]
// registers a thread, out[2] dynamic shared bytes a block, out[3] local
// (stack) bytes a thread.
extern "C" int pt_trace_occupancy(int n_channels, int glossy, int nee, int taped, int block,
                                  int lanes, int pad_shared, int* out) {
  const int lane_bits = lane_bits_of(block, lanes);
  if (block < 1 || block > kMaxBlock || lane_bits < 0) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(n_channels, glossy != 0, nee != 0, lane_bits, taped != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)kernel_occupancy(fn, (block * block) << lane_bits, pad_shared, out);
}
