// The hand-derived reverse sweep that the all-parameter gradient kernels
// share: nee_grad_kernel.cu (NEE diffuse against a colour cotangent, fused
// or replay) and ad_grad_kernel.cu (any configuration against a colour
// cotangent or a 10-channel colour + bounce-0 AOV cotangent). One template,
// so that where the two kernels compute the same sums they compute them
// with the same bits.
//
// A sample's radiance is
//     C_ch = sum_n [ clamp_0?(mask_n e_n) + mask_n dl_n le_ch c_n ],
//     dl_n = 0.5 vis_n clamp(dot(ld_n, n_n), 0, 1)          (NEE only),
// and the bounce-0 AOVs are the flipped normal, the albedo and t of the
// first hit. The argmin (which sphere, near or far root), the shadow
// visibility, the normal flip and every random draw are detached decisions;
// the square-root chain of t is gated on det > 0; clamps use jnp.clip's
// subgradient (1/2 on the boundary).
//
// forward traces one sample with the forward kernel's own segment
// (common.cuh) and tapes, for each hit bounce, the decisions, the
// throughput before it and, where the geometry chain is live, the incoming
// ray, t, the cosine sample and the glossy jitter. reverse_sweep recomputes
// everything else of a bounce (hit point, normal, flip, light direction, dl,
// the cosine frame and, under GLOSSY, the reflection chain) with the
// segment's expressions, so it has the forward's bits, and runs
//   * the geometric chain (GEOM = NEE or AOV): next ray (o', d') -> [GLOSSY:
//     renormalisation -> jitter -> reflection about the normal ->
//     renormalisation ->] cosine frame -> normal; [NEE: Lambert source ->
//     normal, light direction -> hit point and the light's bottom point
//     (px, py - r, pz);] [AOV, at bounce 0: the normal's and the depth's own
//     cotangents;] normal -> hit point, centre; h = o + d t -> o, d, t; the
//     closed-form t chain (k_p, k_d, k_r) -> centre, radius, o, d; at bounce
//     0 the inv_len chain of the unnormalized primary ray; at the end o ->
//     eye, d -> corner rays;
//   * the shading chain: the product-chain recurrence of grad_kernel.cu
//     plus, under NEE, the light terms (the light's emission gradient rides
//     in the light sphere's emission slot) and, with AOV, the first hit's
//     albedo cotangent.
// Without NEE the colour does not depend on geometry; without AOV cotangents
// either, every geometric cotangent is an exact zero. That instance (GEOM
// false) keeps the shading chain alone: it tapes four words a bounce, has no
// geometry slots and writes exact zeros into the geometry and camera
// outputs. Its shading sums are the full instance's, bit for bit.
//
// What bounds the sweep on an H100: the instruction throughput of scalar f32
// chains (no matrix product and no bulk tile anywhere, so wgmma and TMA have
// nothing to do), 607-1,331 counted operations a segment by instance
// (utils/roofline.py), three quarters of them the forward retrace where the
// kernel traces its paths again, and the warps an SM keeps resident to hide
// their latency: measured, the time falls as 1 / blocks up to 4 resident
// 64-thread blocks an SM and flattens from there (PERF.md). Where K1 has
// traced the paths already (the inverse step under NEE), K3 (diffuse) and
// K4 (glossy) sweep the path tape K1 wrote (PathTapeLayout, TapeRing) and
// run the sweep's quarter alone (K3: 0.18 ms a 256x256x16 launch against
// 0.51 retracing); its 56 bytes a segment (68 under GLOSSY) come from
// device memory behind the sweep. What the design does about that:
//   * a block's dynamic shared memory holds only the sums (T threads, N
//     spheres, G = ceil(T / kLanes) groups):
//         geometry sums  [4N + 15][G] of 8 bytes  (GEOM only)
//         shading sums   [6N][G] floats
//         loss           [T] floats
//         sphere table   [N][10] floats
//     kLanes = 2 neighbouring threads (tid / kLanes) share one set of sums.
//     Each slot has one owner in the pair for the whole launch, by the
//     parity of its place within its sphere or the camera (Acc), and the
//     pair adds a bounce's terms in one pass: the lanes trade the terms the
//     partner owns (__shfl_xor_sync, 10 a bounce under NEE) and each owner
//     loads its slots, adds both lanes' terms and stores them. A slot takes
//     lane 0's terms, then lane 1's, each lane's in its program order: the
//     order of the plain version (ops/sweep.py), so the bits are its bits,
//     two launches give the same bits, and there are no atomics and no
//     __syncwarp, since no slot has two writers. Every lane of a warp trades
//     every bounce: the bounce loop runs to the warp's longest path, and an
//     escaped or outside lane trades zeros. A block's last thread is alone
//     in its group when kLanes does not divide T, owns all of it and adds
//     its terms in program order. The pass issues about as many
//     instructions as two turns, lane 0's adds and then lane 1's, would
//     (~166 a taped bounce against ~165: the trades and their selects take
//     the second turn's place), but a turn is one chain of 17
//     read-modify-writes through slots that may alias, where the pass loads
//     a slot kind's three slots at once and adds along chains of at most 7:
//     measured, the taped replays take 12-13% less time than with turns
//     (PERF.md). At N = 9 a 64-thread block holds 20,584 bytes
//     (7,528 without GEOM) where one set a thread took 39,936, so registers
//     (at most 128 a thread: 8 blocks an SM), not shared memory, limit the
//     resident blocks. 4 lanes serialised more than they gained;
//   * a geometry sum is one double (the sums cancel heavily: walls of
//     radius 1e5), where a float and its Kahan compensation term took the
//     same 8 bytes and four dependent adds: as fast, and no less accurate;
//   * the sphere rows the sweep reads by hit index are in shared memory: a
//     per-lane index into c_blocks is a constant-bank load serialised by
//     address;
//   * the scene, camera and seed blocks are device arrays, as the TPU
//     kernels' scalar-prefetch operands are SMEM arrays
//     (pallas_nee_grad.py:787, pallas_ad.py:254-256): the C entry points
//     queue their copy into the library's constant memory on the launch's
//     stream (common.cuh::c_blocks, stage_blocks), so a launch never waits
//     for the card and a captured launch reads new blocks when replayed;
//   * the tape, 14 words a bounce and 17 under GLOSSY (the decisions, the
//     ray and t; the throughput before the bounce, so that the sweep does
//     not rebuild that product bounce by bounce; the cosine sample and the
//     glossy jitter, so that it does not hash, take roots, sines and cosines
//     again), stays a thread's local array where the kernel traces: with
//     the sums halved L1 holds most of it, and a whole tape in shared memory
//     cost an SM one resident block and ran slower. The path tape's ring
//     holds the first 14 words of two bounces a thread (7,168 bytes a
//     64-thread block), which keeps K3 and K4 at 8 blocks an SM; K4's three
//     glossy jitter words go to registers, loaded a bounce ahead too (in the
//     ring, 8,704 bytes, they cost K4 a resident block and a fifth of its
//     time);
//   * the kernels are bounded for the block they are launched with
//     (kSmallThreads threads, kSmallMinBlocks blocks an SM, or 256 and 1);
//     bounding for 10 or 12 blocks costs more in registers than the warps
//     give back.
// SweepBlock::sums adds a block's groups in a fixed order in double
// precision into the block's row of a [blocks, 10N + 16] buffer, and
// reduce_partials<double> (common.cuh) sums the rows in a fixed order.
//
// Built with the forward kernel's flags (-fmad=false, no fast math): the
// paths are the forward's.

#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace pt {

constexpr int kMaxBounces = 16;
constexpr int kLanes = 2;                // threads that share one set of sums
constexpr int kSmallThreads = 64;        // the default 8 x 8 block
constexpr int kSmallMinBlocks = 8;        // resident blocks an SM it is bounded for
static_assert(kLanes == 2, "a group is a lane pair, which trades by __shfl_xor_sync(.., 1)");

// 4-byte words a taped bounce: the decisions and the throughput before the
// bounce; with GEOM between them the ray and t, and after them the cosine
// sample and the glossy jitter.
constexpr int kTapeM = 8, kTapeFrame = kTapeM + 3;
__host__ __device__ constexpr int tape_words_of(bool geom) { return geom ? kTapeFrame + 6 : 4; }
// Of an NEE bounce, the path tape's: 14 diffuse, which has no glossy jitter,
// and 17 glossy. TapeRing's ring holds the first kRingWords of a bounce.
__host__ __device__ constexpr int path_tape_words(bool glossy) {
  return glossy ? tape_words_of(true) : kTapeFrame + 3;
}
constexpr int kRingWords = path_tape_words(false);

// Where a block's arrays lie in its dynamic shared memory, in 4-byte words;
// with `ring`, TapeRing's two bounces of each thread's path tape after them.
struct SweepLayout {
  int threads, groups, n_geom, n_shade, tape_words;
  int shade_off, loss_off, sph_off, ring_off, words;
  __host__ __device__ SweepLayout(bool geom, int n, int threads_, bool ring = false)
      : threads(threads_) {
    groups = (threads + kLanes - 1) / kLanes;
    n_geom = geom ? 4 * n + 15 : 0;
    n_shade = 6 * n;
    tape_words = tape_words_of(geom);
    shade_off = 2 * n_geom * groups;
    loss_off = shade_off + n_shade * groups;
    sph_off = loss_off + threads;
    ring_off = sph_off + 10 * n;
    words = ring_off + (ring ? 2 * kRingWords * threads : 0);
  }
  __host__ __device__ int bytes() const { return 4 * words; }
};

// A thread's tape, word w of bounce b: a local array, which forward fills
// and reverse_sweep reads from the warp's longest path down.
struct Tape {
  static constexpr bool kFromTop = false;
  float local[kMaxBounces * tape_words_of(true)];
  int words;
  __device__ __forceinline__ float& at(int b, int w) { return local[words * b + w]; }
  __device__ __forceinline__ const float& at(int b, int w) const {
    return local[words * b + w];
  }
  __device__ __forceinline__ void enter(int, int&) {}
  __device__ __forceinline__ void finish(int, int) {}
};

// The path tape of an NEE slab in device memory: K1's taped colour pass
// (trace_kernel.cu) writes it as it traces, and the taped replay of K3
// (nee_grad_kernel.cu, diffuse) or K4 (ad_grad_kernel.cu, glossy) sweeps it
// instead of tracing every path again. A bounce is tape_store's WORDS =
// path_tape_words(GLOSSY) words (flags, o, d, t, the throughput before the
// bounce, the cosine sample; under GLOSSY the jitter). Word w of bounce b of
// sample s of the pixel that thread q of the replay's block k takes lies at
//     (((s * blocks + k) * bounces + b) * WORDS + w) * threads + q,
// threads = edge^2 of the replay's edge x edge blocks: a warp of either
// kernel stores or reads a word of 8 or 32 neighbouring pixels as whole
// 32-byte sectors, and a bounce of a block is one piece. Bounce bounces - 1
// is always stored: its flags word carries the sample's hit count above
// kHitShift, and is the count alone where the path ended sooner.
constexpr int kHitShift = 8;
static_assert(kMaxBounces < (1 << 5), "the hit count takes bits 8-12 of a flags word");

template <int WORDS>
struct PathTapeLayout {
  int edge, threads, grid_x;
  size_t chunk, sample;  // floats of a (sample, block): its bounces; of a sample
  __host__ __device__ PathTapeLayout(const TraceParams& p, int edge_)
      : edge(edge_), threads(edge_ * edge_), grid_x((p.width + edge_ - 1) / edge_) {
    chunk = (size_t)p.max_bounces * WORDS * threads;
    sample = chunk * grid_x * ((p.local_h + edge - 1) / edge);
  }
  // Word 0 of bounce 0 of sample 0 of local pixel (row, col).
  __device__ __forceinline__ size_t pixel(int row, int col) const {
    return (size_t)((row / edge) * grid_x + col / edge) * chunk + (row % edge) * edge +
           col % edge;
  }
};

// K1's view of one sample's words in the path tape: forward stores each hit
// bounce through it, then the hit count.
template <int WORDS>
struct TapeWriter {
  float* base;  // word 0 of bounce 0
  int stride;   // PathTapeLayout::threads: from one word to the next
  int last;     // the last bounce
  __device__ __forceinline__ float& at(int b, int w) {
    return base[(b * WORDS + w) * stride];
  }
  __device__ __forceinline__ void finish(int last_flags, int n_hit) {
    if (last >= 0) at(last, 0) = __int_as_float((n_hit > last ? last_flags : 0) |
                                                n_hit << kHitShift);
  }
};

// The taped replay's view of the path tape (K3's, K4's): a ring of two
// bounces in the block's shared memory that cp.async fills one bounce ahead
// of the sweep, so that a bounce's words are on their way while the bounce
// before them is swept. The ring takes a bounce's first kRingWords words;
// the kRest after them (K4's glossy jitter) are loaded into registers as
// the ring's copy is queued and read from there a bounce later, so that K4's
// block needs no more shared memory than K3's. Each thread copies and reads
// its own words, so no barrier: a copy group a bounce, and a wait for all
// but the newest. The sweep takes every bounce from the last down, sample
// after sample (kFromTop), so the order of the copies is fixed; the flags
// of the last bounce bring the sample's hit count before any bounce is
// swept.
template <int WORDS>
struct TapeRing {
  static constexpr bool kFromTop = true;
  static constexpr int kRest = WORDS - kRingWords;
  static_assert(kRest >= 0, "the ring takes a bounce's first kRingWords words");
  const float* src;    // word 0 of bounce 0 of sample 0 of this thread's pixel
  size_t sample;       // floats from a sample's words to the next sample's
  float* ring;         // this thread's word 0 of slot 0; words at `stride`
  const float* cur;    // word 0 of the bounce being swept
  float rest[kRest > 0 ? kRest : 1];       // its words after the ring's
  float next_rest[kRest > 0 ? kRest : 1];  // the next bounce's, on their way
  int stride, bounces, spp;
  int next_s, next_b, slot;  // the next bounce to copy; the slot being swept
  bool inside;

  __device__ __forceinline__ TapeRing(const TraceParams& p, const PathTapeLayout<WORDS>& lay,
                                      const float* tape, int block, int tid, float* ring_,
                                      bool inside_)
      : src(tape + block * lay.chunk + tid), sample(lay.sample), ring(ring_ + tid),
        cur(ring_ + tid), stride(lay.threads), bounces(p.max_bounces), spp(p.spp), next_s(0),
        next_b(p.max_bounces - 1), slot(0), inside(inside_) {
    if (bounces > 0) copy(0);
  }
  __device__ __forceinline__ void copy(int to_slot) {
    if (next_s < spp) {
      const float* from = src + next_s * sample + next_b * WORDS * stride;
      float* to = ring + to_slot * kRingWords * stride;
#pragma unroll
      for (int w = 0; w < kRingWords; ++w)
        __pipeline_memcpy_async(to + w * stride, from + w * stride, sizeof(float));
#pragma unroll
      for (int k = 0; k < kRest; ++k) next_rest[k] = __ldg(from + (kRingWords + k) * stride);
    }
    __pipeline_commit();
    if (--next_b < 0) {
      next_b = bounces - 1;
      ++next_s;
    }
  }
  // At the top of bounce b: queue the next bounce's words, wait for b's.
  __device__ __forceinline__ void enter(int b, int& n_hit) {
    cur = ring + slot * kRingWords * stride;
#pragma unroll
    for (int k = 0; k < kRest; ++k) rest[k] = next_rest[k];
    copy(slot ^ 1);
    __pipeline_wait_prior(1);
    slot ^= 1;
    if (b == bounces - 1) n_hit = inside ? __float_as_int(cur[0]) >> kHitShift : 0;
  }
  __device__ __forceinline__ const float& at(int, int w) const {
    return w < kRingWords ? cur[w * stride] : rest[w - kRingWords];
  }
};

template <bool GEOM, bool GLOSSY, class TapeT>
__device__ __forceinline__ void tape_store(TapeT& tape, int b, const BounceTape& t,
                                           float mr, float mg, float mb) {
  tape.at(b, 0) = __int_as_float(t.flags);
  if (GEOM) {
    tape.at(b, 1) = t.ox;
    tape.at(b, 2) = t.oy;
    tape.at(b, 3) = t.oz;
    tape.at(b, 4) = t.dx;
    tape.at(b, 5) = t.dy;
    tape.at(b, 6) = t.dz;
    tape.at(b, 7) = t.t;
  }
  const int w = GEOM ? kTapeM : 1;
  tape.at(b, w) = mr;
  tape.at(b, w + 1) = mg;
  tape.at(b, w + 2) = mb;
  if (GEOM) {  // of a bounce that goes on; never read otherwise
    tape.at(b, kTapeFrame) = t.cs;
    tape.at(b, kTapeFrame + 1) = t.ss;
    tape.at(b, kTapeFrame + 2) = t.zc;
    if (GLOSSY) {
      tape.at(b, kTapeFrame + 3) = t.jx;
      tape.at(b, kTapeFrame + 4) = t.jy;
      tape.at(b, kTapeFrame + 5) = t.jz;
    }
  }
}

// A slot's terms of one bounce or sample: lane 0's and lane 1's.
struct Terms {
  float t0, t1;
};

// This thread's view of its pair's sums. Each slot is owned by one lane of
// the pair for the whole launch, by the parity of its place within its
// sphere or the camera: geometry slot 4 i + q by lane q % 2, shading slot
// 6 i + k by lane k % 2, camera slot 4N + a by lane a % 2. The owner adds
// both lanes' terms, lane 0's first, so that no slot has two writers (no
// __syncwarp) and every slot takes the plain version's order (the bits).
struct Acc {
  double* geom_;    // slot j at geom_[j * groups]
  float* shade_;    // slot k at shade_[k * groups]
  int groups, lane;  // lane: 0 or 1, the parity of the slots it owns
  bool alone;        // the block's last thread without a partner: it owns all
  unsigned mask;     // the warp's threads
  __device__ __forceinline__ float& shade(int k) const { return shade_[k * groups]; }
  // Geometry slot j: sphere i, parameter q (0 radius, 1..3 position) at
  // 4 i + q; eye axis a at 4N + a; corner c axis a at 4N + 3 + 3 c + a.
  __device__ __forceinline__ double& geom(int j) const { return geom_[j * groups]; }
  // Of a term each lane holds for the slots of either parity: both lanes'
  // terms for the slot of this lane's parity. Each lane hands its partner
  // the term of the partner's parity. Every lane of the warp calls it.
  __device__ __forceinline__ Terms trade(float even, float odd) const {
    const float theirs = __shfl_xor_sync(mask, lane ? even : odd, 1);
    return lane ? Terms{theirs, odd} : Terms{even, theirs};
  }
  // The longest path among the warp's lanes: every lane sweeps that many
  // bounces, so that every lane reaches every trade.
  __device__ __forceinline__ int longest(int n_hit) const {
    return (int)__reduce_max_sync(mask, (unsigned)n_hit);
  }
};

// The owner's adds of one slot kind, each slot loaded once and stored once.
// Slots a (the light's), b (lane 0's winner's) and c (lane 1's winner's)
// may be one and the same: the chain of a shared slot then takes every term
// that reaches it, in order, and the stores end with it. Adding a zero
// term changes no bits (a sum is never -0).
//
// Lane 0's x (then z) to b, lane 1's to c.
template <bool Z, class T>
__device__ __forceinline__ void add_winners(T* b, T* c, bool bc, Terms x, Terms z) {
  const T x0 = x.t0, x1 = x.t1, z0 = z.t0, z1 = z.t1;
  T vb = *b, vc = *c;
  vb += x0;
  if (Z) vb += z0;
  if (bc) {
    vb += x1;
    if (Z) vb += z1;
  }
  vc += x1;
  if (Z) vc += z1;
  *c = vc;
  *b = vb;
}

// The geometry's order: lane 0's l to a and s to b, then lane 1's l to
// a and s to c.
template <class T>
__device__ __forceinline__ void add_light_first(T* a, T* b, T* c, bool ab, bool ac, bool bc,
                                                Terms l, Terms s) {
  const T l0 = l.t0, l1 = l.t1, s0 = s.t0, s1 = s.t1;
  T va = *a, vb = *b, vc = *c;
  va += l0;
  if (ab) va += s0;
  va += l1;
  if (ac) va += s1;
  vb += s0;
  if (bc) vb += s1;
  vc += s1;
  *c = vc;
  *b = vb;
  *a = va;
}

// The shading's order: lane 0's x (then z) to b and y to a, then lane
// 1's x (then z) to c and y to a.
template <bool Z, class T>
__device__ __forceinline__ void add_winner_first(T* a, T* b, T* c, bool ab, bool ac, bool bc,
                                                 Terms x, Terms y, Terms z) {
  const T x0 = x.t0, x1 = x.t1, y0 = y.t0, y1 = y.t1, z0 = z.t0, z1 = z.t1;
  T va = *a, vb = *b, vc = *c;
  if (ab) {
    va += x0;
    if (Z) va += z0;
  }
  va += y0;
  if (ac) {
    va += x1;
    if (Z) va += z1;
  }
  va += y1;
  vb += x0;
  if (Z) vb += z0;
  if (bc) {
    vb += x1;
    if (Z) vb += z1;
  }
  vc += x1;
  if (Z) vc += z1;
  *c = vc;
  *b = vb;
  *a = va;
}

// What one bounce adds to the pair's sums, in one pass. live, idx: this
// lane's bounce and winner; li the light. lg, sg: the light's and the
// winner's geometry; ae, ac: the winner's emission and albedo; al: the
// light's emission; with AOV at the first bounce, aov[3..5] follow ac into
// the albedo slots. A slot kind of each lane: geometry q = 2 j + lane (j < 2),
// shading k = 2 j + lane (j < 3), so lane 0 takes the emission's r and b and
// the albedo's g, lane 1 the rest.
template <bool NEE, bool AOV>
__device__ __forceinline__ void bounce_adds(const Acc& acc, bool live, int idx, int li,
                                            bool first, const float (&lg)[4],
                                            const float (&sg)[4], const float (&ae)[3],
                                            const float (&ac)[3], const float (&al)[3],
                                            const float (&aov)[7]) {
  constexpr bool GEOM = NEE || AOV;
  const int theirs = __shfl_xor_sync(acc.mask, live ? idx : -1, 1);  // -1: adds nothing
  float z[3] = {0.0f, 0.0f, 0.0f};
  if (AOV && first && live) {
    z[0] = aov[3];
    z[1] = aov[4];
    z[2] = aov[5];
  }
  Terms lt[2] = {}, st[2] = {}, xt[3], yt[2] = {}, zt[3] = {};
  if (GEOM) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (NEE) lt[j] = acc.trade(lg[2 * j], lg[2 * j + 1]);
      st[j] = acc.trade(sg[2 * j], sg[2 * j + 1]);
    }
  }
  xt[0] = acc.trade(ae[0], ae[1]);
  xt[1] = acc.trade(ae[2], ac[0]);
  xt[2] = acc.trade(ac[1], ac[2]);
  if (NEE) {
    yt[0] = acc.trade(al[0], al[1]);
    yt[1] = acc.trade(al[2], 0.0f);
  }
  if (AOV) {
    zt[1] = acc.trade(0.0f, z[0]);
    zt[2] = acc.trade(z[1], z[2]);
  }

  if (acc.alone) {  // its own terms, in program order
    if (live) {
      if (NEE) {
        acc.geom(4 * li + 1) += (double)lg[1];
        acc.geom(4 * li + 2) += (double)lg[2];
        acc.geom(4 * li + 3) += (double)lg[3];
        acc.geom(4 * li + 0) += (double)lg[0];
      }
      if (GEOM) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc.geom(4 * idx + q) += (double)sg[q];
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        acc.shade(6 * idx + ch) += ae[ch];
        acc.shade(6 * idx + 3 + ch) += ac[ch];
        if (NEE) acc.shade(6 * li + ch) += al[ch];
        if (AOV) acc.shade(6 * idx + 3 + ch) += z[ch];
      }
    }
    return;
  }
  if (!live && theirs < 0) return;
  const int other = theirs < 0 ? 0 : theirs;  // a lane that adds nothing adds zeros
  const int i0 = acc.lane ? other : idx, i1 = acc.lane ? idx : other;
  // where the slots of a kind coincide: a winner is the light, or one sphere
  const bool light0 = i0 == li, light1 = i1 == li, one = i0 == i1;
  const int own = acc.lane;
  if (GEOM) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = 2 * j + own;
      double* b = &acc.geom(4 * i0 + q);
      double* c = &acc.geom(4 * i1 + q);
      if (NEE)
        add_light_first(&acc.geom(4 * li + q), b, c, light0, light1, one, lt[j], st[j]);
      else
        add_winners<false>(b, c, one, st[j], Terms{});
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = 2 * j + own;
    float* b = &acc.shade(6 * i0 + k);
    float* c = &acc.shade(6 * i1 + k);
    // j 0: emission; j 1: lane 0's emission b, lane 1's albedo r (y zero);
    // j 2: albedo
    if (NEE && j < 2)
      add_winner_first<AOV>(&acc.shade(6 * li + k), b, c, light0, light1, one, xt[j], yt[j],
                            zt[j]);
    else
      add_winners<AOV>(b, c, one, xt[j], zt[j]);
  }
}

// The reverse sweep of one sample over its n_hit taped bounces, against the
// sample's colour cotangent g and, with AOV, the cotangents of its bounce-0
// AOVs: aov[0..2] the (flipped) normal, aov[3..5] the albedo, aov[6] the
// depth. sph: the block's sphere table in shared memory. inside: the thread
// has a pixel (else n_hit is 0 and it only trades zeros). Without
// NEE p.light_index is not read. tape: a Tape that forward filled, or the
// path tape's TapeRing, which brings n_hit with the last bounce's words.
template <bool GLOSSY, bool NEE, bool AOV, class TapeT>
__device__ __forceinline__ void reverse_sweep(const TraceParams& p, const Sphere* sph,
                                              const Rng& rng, float rows, float cols,
                                              TapeT& tape, int n_hit, bool inside,
                                              const float (&g)[3],
                                              const float (&aov)[7],
                                              const Acc& acc) {
  constexpr bool GEOM = NEE || AOV;
  const int n4 = 4 * p.num_spheres;
  const int li = NEE ? p.light_index : 0;
  const Sphere& l = c_blocks.sph[li];
  const float lb_x = l.px, lb_y = l.py - l.rad, lb_z = l.pz;
  const float le[3] = {l.er, l.eg, l.eb};

  // cotangents of the NEXT ray's origin and direction
  float oh[3] = {0.0f, 0.0f, 0.0f}, dh[3] = {0.0f, 0.0f, 0.0f};
  float hb[3] = {0.0f, 0.0f, 0.0f};  // suffix derivative by the throughput

  for (int b = TapeT::kFromTop ? p.max_bounces - 1 : acc.longest(n_hit) - 1; b >= 0; --b) {
    tape.enter(b, n_hit);
    const bool live = b < n_hit;
    const bool first = b == 0;
    int idx = 0;
    // what this bounce adds: the light's and the winner's geometry, the
    // winner's emission and albedo, the light's emission
    float lg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float ae[3] = {0.0f, 0.0f, 0.0f}, ac[3] = {0.0f, 0.0f, 0.0f};
    float al[3] = {0.0f, 0.0f, 0.0f};

    if (live) {
      const int flags = __float_as_int(tape.at(b, 0));
      idx = flags & 15;
      const Sphere& s = sph[idx];

      // The throughput before this bounce, as the forward had it.
      const int mw = GEOM ? kTapeM : 1;
      const float m[3] = {tape.at(b, mw), tape.at(b, mw + 1), tape.at(b, mw + 2)};
      const float e[3] = {s.er, s.eg, s.eb};
      const float cc[3] = {s.cr, s.cg, s.cb};
      float dl = 0.0f;

      if (GEOM) {
        const float ox = tape.at(b, 1), oy = tape.at(b, 2), oz = tape.at(b, 3);
        const float dx = tape.at(b, 4), dy = tape.at(b, 5), dz = tape.at(b, 6);
        const float t_best = tape.at(b, 7);

        // -- the bounce again, with the segment's expressions (common.cuh)
        float dnx = dx, dny = dy, dnz = dz, inv_len = 1.0f;
        if (first) {
          inv_len = rsqrtf(dot3(dx, dy, dz, dx, dy, dz));
          dnx = dx * inv_len;
          dny = dy * inv_len;
          dnz = dz * inv_len;
        }
        const float hx = ox + dx * t_best;
        const float hy = oy + dy * t_best;
        const float hz = oz + dz * t_best;
        float nux = hx - s.px, nuy = hy - s.py, nuz = hz - s.pz;
        const float n_inv = rsqrtf(dot3(nux, nuy, nuz, nux, nuy, nuz) + 1e-20f);
        nux *= n_inv;
        nuy *= n_inv;
        nuz *= n_inv;
        const float flip = dot3(nux, nuy, nuz, dx, dy, dz) < 0.0f ? 1.0f : -1.0f;
        const float nx = nux * flip, ny = nuy * flip, nz = nuz * flip;
        float ldx = 0.0f, ldy = 0.0f, ldz = 0.0f, l_inv = 0.0f, dr = 0.0f, dlw = 0.0f;
        if (NEE) {
          const float lvx = lb_x - hx, lvy = lb_y - hy, lvz = lb_z - hz;
          l_inv = rsqrtf(dot3(lvx, lvy, lvz, lvx, lvy, lvz) + 1e-20f);
          ldx = lvx * l_inv;
          ldy = lvy * l_inv;
          ldz = lvz * l_inv;
          dr = dot3(ldx, ldy, ldz, nx, ny, nz);
          const float diffuse = fminf(fmaxf(dr, 0.0f), 1.0f);
          const bool vis = (flags & 32) != 0;
          dl = diffuse * (vis ? 1.0f : 0.0f) * 0.5f;
          // The detached factor of d(dl)/d(dr): vis * 0.5 * clamp'.
          dlw = (vis ? 0.5f : 0.0f) * clip_grad(dr);
        }

        // cotangents of the hit point and the normal
        float hh[3] = {0.0f, 0.0f, 0.0f}, nh[3] = {0.0f, 0.0f, 0.0f};

        if (b + 1 < p.max_bounces) {
          // o' = h + n push; c = cs o1 + ss o2 + zc n, o2 = n x o1,
          // o1 = normalize(use_a ? (-ny, nx, 0) : (0, -nz, ny)); d' = c, or
          // under GLOSSY d' = normalize(reflect(normalize(c), n) + jitter).
          const bool use_a = fabsf(nx) > fabsf(nz);
          float o1x = use_a ? -ny : 0.0f;
          float o1y = use_a ? nx : -nz;
          float o1z = use_a ? 0.0f : ny;
          const float o1_inv = rsqrtf(dot3(o1x, o1y, o1z, o1x, o1y, o1z) + 1e-20f);
          o1x *= o1_inv;
          o1y *= o1_inv;
          o1z *= o1_inv;
          const float cs = tape.at(b, kTapeFrame), ss = tape.at(b, kTapeFrame + 1);
          const float zc = tape.at(b, kTapeFrame + 2);
          const float ohx = oh[0], ohy = oh[1], ohz = oh[2];
          // the cotangent of c
          float dhx = dh[0], dhy = dh[1], dhz = dh[2];
          hh[0] = ohx;
          hh[1] = ohy;
          hh[2] = ohz;
          nh[0] = p.push * ohx;
          nh[1] = p.push * ohy;
          nh[2] = p.push * ohz;
          if (GLOSSY) {
            const float o2x = ny * o1z - nz * o1y;
            const float o2y = nz * o1x - nx * o1z;
            const float o2z = nx * o1y - ny * o1x;
            const float cx = cs * o1x + ss * o2x + zc * nx;
            const float cy = cs * o1y + ss * o2y + zc * ny;
            const float cz = cs * o1z + ss * o2z + zc * nz;
            const float b_inv = rsqrtf(dot3(cx, cy, cz, cx, cy, cz) + 1e-20f);
            const float bx = cx * b_inv, by = cy * b_inv, bz = cz * b_inv;
            const float dn2 = 2.0f * dot3(bx, by, bz, nx, ny, nz);
            const float jx = tape.at(b, kTapeFrame + 3), jy = tape.at(b, kTapeFrame + 4);
            const float jz = tape.at(b, kTapeFrame + 5);
            const float qx = bx - dn2 * nx + jx - 0.005f;
            const float qy = by - dn2 * ny + jy - 0.005f;
            const float qz = bz - dn2 * nz + jz - 0.005f;
            const float g_inv = rsqrtf(dot3(qx, qy, qz, qx, qy, qz) + 1e-20f);
            // d' = q g_inv: q-hat = g_inv d'-hat - g_inv^3 (q . d'-hat) q; the
            // jitter is a constant, so this is the reflected ray's cotangent.
            const float qd = g_inv * g_inv * g_inv * dot3(qx, qy, qz, dhx, dhy, dhz);
            const float rhx = g_inv * dhx - qd * qx;
            const float rhy = g_inv * dhy - qd * qy;
            const float rhz = g_inv * dhz - qd * qz;
            // r = b - 2 (b . n) n: b-hat = r-hat - 2 (n . r-hat) n;
            // n-hat += -2 [(b . n) r-hat + (n . r-hat) b].
            const float nr2 = 2.0f * dot3(nx, ny, nz, rhx, rhy, rhz);
            const float bhx = rhx - nr2 * nx;
            const float bhy = rhy - nr2 * ny;
            const float bhz = rhz - nr2 * nz;
            nh[0] -= dn2 * rhx + nr2 * bx;
            nh[1] -= dn2 * rhy + nr2 * by;
            nh[2] -= dn2 * rhz + nr2 * bz;
            // b = c b_inv, as d' = q g_inv (the AD of the reference keeps this
            // projection of the already-unit c too).
            const float cd = b_inv * b_inv * b_inv * dot3(cx, cy, cz, bhx, bhy, bhz);
            dhx = b_inv * bhx - cd * cx;
            dhy = b_inv * bhy - cd * cy;
            dhz = b_inv * bhz - cd * cz;
          }
          nh[0] += zc * dhx;
          nh[1] += zc * dhy;
          nh[2] += zc * dhz;
          float t1x = cs * dhx, t1y = cs * dhy, t1z = cs * dhz;        // o1-hat
          const float t2x = ss * dhx, t2y = ss * dhy, t2z = ss * dhz;  // o2-hat
          // o2 = n x o1: n-hat += o1 x o2-hat; o1-hat += o2-hat x n.
          nh[0] += o1y * t2z - o1z * t2y;
          nh[1] += o1z * t2x - o1x * t2z;
          nh[2] += o1x * t2y - o1y * t2x;
          t1x += t2y * nz - t2z * ny;
          t1y += t2z * nx - t2x * nz;
          t1z += t2x * ny - t2y * nx;
          const float sd = o1x * t1x + o1y * t1y + o1z * t1z;
          const float p1x = o1_inv * (t1x - o1x * sd);
          const float p1y = o1_inv * (t1y - o1y * sd);
          const float p1z = o1_inv * (t1z - o1z * sd);
          nh[0] += use_a ? p1y : 0.0f;
          nh[1] += use_a ? -p1x : p1z;
          nh[2] += use_a ? 0.0f : -p1y;
        }

        // The t chain of the winner: t_u = tca + sig sqrt(r^2 - |q|^2),
        // q = rel - tca dn; k_p = corr dn - a q (= -k_o), k_d = corr rel +
        // tca a q, k_r = a r, a = sig / thc (gated on det > 0),
        // corr = 1 + a q.dn.
        const float relx = s.px - ox, rely = s.py - oy, relz = s.pz - oz;
        const float tca = dot3(relx, rely, relz, dnx, dny, dnz);
        const float qx = relx - tca * dnx;
        const float qy = rely - tca * dny;
        const float qz = relz - tca * dnz;
        const float det = s.rad * s.rad - dot3(qx, qy, qz, qx, qy, qz);
        const float inv_thc = det > 0.0f ? rsqrtf(det) : 0.0f;
        const float a_ = ((flags & 16) != 0 ? 1.0f : -1.0f) * inv_thc;
        const float ux = a_ * qx, uy = a_ * qy, uz = a_ * qz;
        const float corr = 1.0f + dot3(ux, uy, uz, dnx, dny, dnz);
        const float kpx = corr * dnx - ux;
        const float kpy = corr * dny - uy;
        const float kpz = corr * dnz - uz;
        const float kdx = corr * relx + tca * ux;
        const float kdy = corr * rely + tca * uy;
        const float kdz = corr * relz + tca * uz;
        const float kr = a_ * s.rad;
        const float t_u = first ? t_best / inv_len : t_best;
        const float il3 = inv_len * inv_len * inv_len;

        if (NEE) {
          // Lambert source: wdr = dC/d(dr). dr = dot(ld, n), ld = lv l_inv,
          // lv = lb - h: the normalize pullback of wdr n collapses to wdr bv.
          const float wdr =
              dlw * (g[0] * m[0] * le[0] * cc[0] + g[1] * m[1] * le[1] * cc[1] +
                     g[2] * m[2] * le[2] * cc[2]);
          const float bvx = l_inv * (nx - ldx * dr);
          const float bvy = l_inv * (ny - ldy * dr);
          const float bvz = l_inv * (nz - ldz * dr);
          nh[0] += wdr * ldx;
          nh[1] += wdr * ldy;
          nh[2] += wdr * ldz;
          const float lhx = wdr * bvx, lhy = wdr * bvy, lhz = wdr * bvz;
          hh[0] -= lhx;
          hh[1] -= lhy;
          hh[2] -= lhz;
          // lb = (l.px, l.py - l.rad, l.pz)
          lg[0] = -lhy;
          lg[1] = lhx;
          lg[2] = lhy;
          lg[3] = lhz;
        }
        if (AOV && first) {  // the stored normal is the flipped one
          nh[0] += aov[0];
          nh[1] += aov[1];
          nh[2] += aov[2];
        }

        // normal: n = flip (n_pre n_inv), n_pre = h - centre
        const float ax = flip * nh[0], ay = flip * nh[1], az = flip * nh[2];
        const float sd = nux * ax + nuy * ay + nuz * az;
        const float ppx = n_inv * (ax - nux * sd);
        const float ppy = n_inv * (ay - nuy * sd);
        const float ppz = n_inv * (az - nuz * sd);
        hh[0] += ppx;
        hh[1] += ppy;
        hh[2] += ppz;
        float phx = -ppx, phy = -ppy, phz = -ppz;  // the winner's centre

        // h = o + d t
        oh[0] = hh[0];
        oh[1] = hh[1];
        oh[2] = hh[2];
        dh[0] = t_best * hh[0];
        dh[1] = t_best * hh[1];
        dh[2] = t_best * hh[2];
        float t_hat = dx * hh[0] + dy * hh[1] + dz * hh[2];
        if (AOV && first) t_hat += aov[6];  // depth0 is t itself

        // t = t_u inv_len (inv_len is 1 after the first bounce)
        const float tu_hat = first ? t_hat * inv_len : t_hat;
        phx += tu_hat * kpx;
        phy += tu_hat * kpy;
        phz += tu_hat * kpz;
        oh[0] -= tu_hat * kpx;
        oh[1] -= tu_hat * kpy;
        oh[2] -= tu_hat * kpz;
        const float nhx = tu_hat * kdx, nhy = tu_hat * kdy, nhz = tu_hat * kdz;
        if (first) {
          // dn = d inv_len; inv_len = rsqrt(d.d)
          float il_hat = t_hat * t_u;
          il_hat += dx * nhx + dy * nhy + dz * nhz;
          const float sdot = -il3 * il_hat;
          dh[0] += inv_len * nhx + sdot * dx;
          dh[1] += inv_len * nhy + sdot * dy;
          dh[2] += inv_len * nhz + sdot * dz;
        } else {
          dh[0] += nhx;
          dh[1] += nhy;
          dh[2] += nhz;
        }
        sg[0] = tu_hat * kr;
        sg[1] = phx;
        sg[2] = phy;
        sg[3] = phz;
      }

      // -- shading: the product chain plus the NEE terms
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float cmv = first ? clip_grad(m[ch] * e[ch]) : 1.0f;
        const float src = NEE ? dl * le[ch] + hb[ch] : hb[ch];
        ae[ch] = g[ch] * (m[ch] * cmv);
        ac[ch] = g[ch] * (m[ch] * src);
        if (NEE) al[ch] = g[ch] * (m[ch] * dl * cc[ch]);  // the light's emission
        hb[ch] = cmv * e[ch] + src * cc[ch];
      }
    }

    // -- the bounce's adds, both lanes' in one pass
    bounce_adds<NEE, AOV>(acc, live, idx, li, first, lg, sg, ae, ac, al, aov);
  }

  if (GEOM) {
    // camera: o_0 is the eye; d_0 the bilinear blend of the corner rays. A
    // lane without a pixel never swept a bounce: its terms are zeros.
    float u = 0.0f, v = 0.0f;
    if (inside) primary_uv(p, rng, rows, cols, u, v);
    const float w[4] = {(1.0f - u) * (1.0f - v), u * (1.0f - v), (1.0f - u) * v, u * v};
    float cam[16];
#pragma unroll
    for (int a = 0; a < 3; ++a) cam[a] = oh[a];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int a = 0; a < 3; ++a) cam[3 + 3 * c + a] = w[c] * dh[a];
    }
    cam[15] = 0.0f;  // no slot
    Terms t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = acc.trade(cam[2 * j], cam[2 * j + 1]);
    if (acc.alone) {
#pragma unroll
      for (int a = 0; a < 15; ++a) acc.geom(n4 + a) += (double)cam[a];
    } else {
      // slot 4N + 2 j + lane; lane 1 has no eighth
      const bool eighth = acc.lane == 0;
      double s[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = j < 7 || eighth ? acc.geom(n4 + 2 * j + acc.lane) : 0.0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] += (double)t[j].t0;
        s[j] += (double)t[j].t1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 7 || eighth) acc.geom(n4 + 2 * j + acc.lane) = s[j];
      }
    }
  }
}

// One sample's forward path. TAPED: the hit bounces are taped (GEOM: with
// the ray and t) into a Tape or the path tape's TapeWriter, and counted in
// n_hit. -> the sample's colour in out.
template <bool GLOSSY, bool NEE, bool TAPED, bool GEOM, class TapeT>
__device__ __forceinline__ void forward(const TraceParams& p, const Rng& rng,
                                        float rows, float cols, Sample& out,
                                        TapeT& tape, int& n_hit) {
  out = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, false};
  float dx, dy, dz;
  primary_ray(p, rng, rows, cols, dx, dy, dz);
  float ox = c_blocks.eye[0], oy = c_blocks.eye[1], oz = c_blocks.eye[2];
  float mr = 1.0f, mg = 1.0f, mb = 1.0f;
  int sel;
  n_hit = 0;
  BounceTape entry = {};
  if (p.max_bounces >= 1 &&
      segment_taped<true, GLOSSY, NEE, TAPED>(p, rng, 0, ox, oy, oz, dx, dy, dz, mr,
                                              mg, mb, out, sel, entry)) {
    if (TAPED) tape_store<GEOM, GLOSSY>(tape, 0, entry, 1.0f, 1.0f, 1.0f);
    n_hit = 1;
    for (int b = 1; b < p.max_bounces; ++b) {
      const float pr = mr, pg = mg, pb = mb;  // the throughput before bounce b
      if (!segment_taped<false, GLOSSY, NEE, TAPED>(p, rng, b, ox, oy, oz, dx, dy,
                                                    dz, mr, mg, mb, out, sel, entry))
        break;
      if (TAPED) tape_store<GEOM, GLOSSY>(tape, b, entry, pr, pg, pb);
      n_hit = b + 1;
    }
  }
  if (TAPED) tape.finish(entry.flags, n_hit);  // entry: the last hit bounce's
}

// A block's shared memory at the start of a kernel: the sums zeroed, the
// sphere table copied, and this thread's views of them.
struct SweepBlock {
  SweepLayout lay;
  float* words;
  Acc acc;
  const Sphere* sph;
  float* loss;  // this thread's
  __device__ __forceinline__ SweepBlock(bool geom, const TraceParams& p, void* smem,
                                        int tid, int threads, bool ring = false)
      : lay(geom, p.num_spheres, threads, ring), words(static_cast<float*>(smem)) {
    const unsigned mask = __activemask();  // every thread of the block is here
    for (int k = tid; k < lay.sph_off; k += threads) words[k] = 0.0f;
    copy_sphere_table(p, words + lay.sph_off, tid, threads);
    __syncthreads();
    const int group = tid / kLanes;
    acc = {static_cast<double*>(smem) + group, words + lay.shade_off + group, lay.groups,
           tid % kLanes, tid % kLanes == 0 && tid + 1 == threads, mask};
    sph = reinterpret_cast<const Sphere*>(words + lay.sph_off);
    loss = words + lay.loss_off + tid;
  }
  __device__ __forceinline__ Tape tape() const {
    Tape t;
    t.words = lay.tape_words;
    return t;
  }
  __device__ __forceinline__ float* ring() const { return words + lay.ring_off; }

  // After the last sweep of a block: its sums in a fixed order, in double,
  // into its row of partial [blocks, 10N + 16] (sphere i at 10 i: radius,
  // position, emission, albedo; eye at 10N; corner rays at 10N + 3; loss at
  // 10N + 15). Thread k adds the row of output k, starting at column k so
  // that the threads read distinct banks. Without geometry slots the
  // geometry and camera outputs are exact zeros.
  __device__ __forceinline__ void sums(int tid, double* __restrict__ partial) const {
    __syncthreads();
    const int n = lay.n_shade / 6;
    const int n_out = 10 * n + 16;
    const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const double* geom = reinterpret_cast<const double*>(words);
    for (int k = tid; k < n_out; k += lay.threads) {
      int gslot = -1, fslot = -1;  // a geometry slot, a shading slot, or the loss
      if (k < 10 * n) {
        const int i = k / 10, c = k % 10;
        if (c < 4) gslot = 4 * i + c; else fslot = 6 * i + (c - 4);
      } else if (k < 10 * n + 15) {
        gslot = 4 * n + (k - 10 * n);
      }
      double v = 0.0;
      if (gslot >= 0) {
        if (lay.n_geom > 0) {
          const double* r = geom + gslot * lay.groups;
          for (int j = 0; j < lay.groups; ++j) {
            int t = j + k % lay.groups;
            if (t >= lay.groups) t -= lay.groups;
            v += r[t];
          }
        }
      } else {
        const int count = fslot >= 0 ? lay.groups : lay.threads;
        const float* r = fslot >= 0 ? words + lay.shade_off + fslot * lay.groups
                                    : words + lay.loss_off;
        for (int j = 0; j < count; ++j) {
          int t = j + k % count;
          if (t >= count) t -= count;
          v += (double)r[t];
        }
      }
      partial[block * n_out + k] = v;
    }
  }
};

}  // namespace pt
