"""What K3 (``ops/nee_grad_kernel.py``) and K4 (``ops/ad_grad_kernel.py``)
share: the Python side of their reverse sweep, ``csrc/sweep.cuh``.

- The output: flat sums [10N + 16] (sphere i at 10 i: radius, position xyz,
  emission rgb, albedo rgb; the eye at 10N, the corner rays 00, 10, 01, 11
  at 10N + 3, K3's fused loss at 10N + 15), laid out by ``block_from_sums``
  as the JAX package's gradient block, cropped ([N + 5, 11]), and read as
  (d_scene, d_camera) by ``grads_from_block``; ``agreement`` holds two of
  them against each other by kind of entry.
- The plain sweep ``_sweep_plain``, the kernels' order of operations over
  [h, W] tensors: ``LANES`` neighbouring threads share one set of sums, to
  which each slot takes lane 0's terms, then lane 1's (``LaneGroups``; the
  kernels add both in one pass, each slot by its owner); the geometry sums,
  which cancel heavily (walls of radius 1e5), are kept and summed in double.
- A launch's shared memory (``shared_bytes``) and the path tape: K1's taped
  colour pass writes a slab's paths into a ``PathTape`` and the taped
  replay of K3 or K4 sweeps them instead of tracing them again, with the
  same bits; ``step_tapes`` plans an inverse step's row slabs;
  ``lane_pair_shares`` reads from a tape how often a pair's two lanes add
  to one slot.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.ops.sampling import clip01_grad
from pathtrace_tpu_torch.scene import Scene
from pathtrace_tpu_torch.utils.transfer import to_device

MAX_BOUNCES = 16  # the sweep kernels' tapes hold this many bounces a thread
# A block's shared memory on sm_90. The largest launch either sweep kernel
# accepts (16 spheres, a 16 x 16 block: 131,712 bytes) is below it.
MAX_SHARED_BYTES = 232448
# Block layout (the JAX package's, cropped): rows 0..N-1 the spheres (col 0
# radius, 1-3 position, 4-6 emission, 7-9 albedo), row N the eye (cols 0-2)
# and the loss (col 10), rows N+1..N+4 the corner rays (cols 0-2).
BLOCK_COLS = 11
LOSS_COL = 10

LANES = 2  # csrc/sweep.cuh's kLanes: threads that share one set of sums
# csrc/sweep.cuh's path_tape_words: the 4-byte words of a bounce of an NEE
# path tape, by ``cfg.brdf`` (the glossy jitter takes three more)
TAPE_WORDS = {"diffuse": 14, "glossy": 17}
RING_WORDS = 14  # csrc/sweep.cuh's kRingWords: those of a bounce a taped replay's ring holds
HIT_SHIFT = 8  # csrc/sweep.cuh's kHitShift: a flags word's hit count lies above it


def n_slots(num_spheres: int, geom: bool = True) -> int:
    """4-byte words of sums a lane group: 6N shading floats and, with the
    geometry chain, 4N + 15 geometry doubles."""
    return 6 * num_spheres + (2 * (4 * num_spheres + 15) if geom else 0)


def shared_bytes(num_spheres: int, block: int, geom: bool = True, taped: bool = False) -> int:
    """Dynamic shared memory of a ``block`` x ``block`` launch
    (``csrc/sweep.cuh``'s ``SweepLayout``): the sums of every lane group, a
    loss float a thread and the sphere table; a taped replay's ring of two
    bounces of path tape a thread after them (``RING_WORDS`` of each: K4's
    glossy jitter waits in registers)."""
    threads = block * block
    groups = -(-threads // LANES)
    ring = 2 * RING_WORDS * threads if taped else 0
    return 4 * (n_slots(num_spheres, geom) * groups + threads + 10 * num_spheres + ring)


# -- the path tape ----------------------------------------------------------------

def tape_shape(cfg: RenderConfig, local_h: int, spp: int) -> tuple:
    """[spp, blocks, max_bounces, TAPE_WORDS[cfg.brdf], block^2]: the float32
    words of the path tape of a ``local_h`` x W slab (``csrc/sweep.cuh``'s
    ``PathTapeLayout``), blocks being the replay's ``cfg.block`` x
    ``cfg.block`` blocks over the slab, and a block's threads last."""
    blocks = -(-cfg.width // cfg.block) * -(-local_h // cfg.block)
    return (spp, blocks, cfg.max_bounces, TAPE_WORDS[cfg.brdf], cfg.block * cfg.block)


def tape_bytes(cfg: RenderConfig, local_h: int, spp: int) -> int:
    return 4 * math.prod(tape_shape(cfg, local_h, spp))


# The most device memory the two path tapes of an inverse step's slab may
# take (a twentieth of an H100's 80 GB); the step runs in as many row slabs
# as it needs to keep within it (``slab_rows``). At 5 bounces 256x256x16 and
# 512x512x16 NEE diffuse tape in one slab (2 x 293.6 MB, 2 x 1.17 GB);
# 512x512x32 takes two of 256 rows (2 x 1.17 GB diffuse, 2 x 1.43 GB glossy,
# against 2 x 2.35 GB and 2 x 2.85 GB for the whole frame).
TAPE_BUDGET = 4 << 30


def slab_rows(cfg: RenderConfig) -> int | None:
    """Rows a slab of the fewest equal row slabs of the frame (the last may
    be shorter) whose two path tapes take at most ``TAPE_BUDGET`` bytes, or
    None where even a slab of one row's would not. A tape grows by whole
    rows of replay blocks, each ``tape_bytes(cfg, 1, spp)``."""
    most = min(cfg.height, TAPE_BUDGET // (2 * tape_bytes(cfg, 1, cfg.spp)) * cfg.block)
    if most < 1:
        return None
    return -(-cfg.height // -(-cfg.height // most))


def step_tapes(cfg: RenderConfig, device: torch.device) -> tuple:
    """The plan of a whole-frame inverse step on ``device``
    (``grad_kernel.cross_grads``) -> (rows, (tape, tape)): its colour passes
    and replays go in slabs of ``rows`` rows (the last may be shorter), and
    the two empty path tapes of a slab of ``rows`` rows serve every slab
    (``PathTape.slab``). (cfg.height, (None, None)) where the replays trace
    their paths again: on the CPU, without NEE, and where even one row's two
    tapes would take more than ``TAPE_BUDGET`` bytes."""
    rows = slab_rows(cfg) if device.type == "cuda" and cfg.nee else None
    if rows is None:
        return cfg.height, (None, None)
    return rows, tuple(PathTape.empty(cfg, rows, cfg.spp, device) for _ in range(2))


@dataclasses.dataclass(eq=False)
class PathTape:
    """The paths of an NEE slab as K1's taped colour pass traced them, for
    the taped replay of K3 (diffuse) or K4 (glossy): ``words``
    [``tape_shape``] float32 on the card, made for ``sizes`` (local_h,
    width, spp, max_bounces, block, words a bounce). The colour pass sets
    ``written``. The tape holds no scene, camera or seed: a replay reads it
    with the blocks of the colour pass that wrote it."""

    words: torch.Tensor
    sizes: tuple
    written: bool = False

    @classmethod
    def empty(cls, cfg: RenderConfig, local_h: int, spp: int, device) -> "PathTape":
        words = torch.empty(tape_shape(cfg, local_h, spp), dtype=torch.float32, device=device)
        return cls(words, _tape_sizes(cfg, local_h, spp))

    def slab(self, cfg: RenderConfig, local_h: int, spp: int) -> "PathTape":
        """An unwritten tape of a ``local_h``-row slab in the first words of
        this one's memory, which must hold them: each slab of an inverse
        step reuses the step's two tapes."""
        shape = tape_shape(cfg, local_h, spp)
        n = math.prod(shape)
        if n > self.words.numel():
            raise ValueError(f"a path tape of {self.words.numel()} words cannot hold a slab "
                             f"of {n}")
        return PathTape(self.words.view(-1)[:n].view(shape), _tape_sizes(cfg, local_h, spp))

    def check(self, cfg: RenderConfig, local_h: int, spp: int, device, written: bool):
        """Raise ValueError unless a launch of ``cfg`` over ``local_h`` rows and
        ``spp`` samples on ``device`` can write the tape (``written`` False:
        K1) or read it (True: a replay, after a colour pass wrote it)."""
        if not cfg.nee:
            raise ValueError(f"a path tape needs nee=True, got nee={cfg.nee}, "
                             f"brdf={cfg.brdf!r}")
        want = _tape_sizes(cfg, local_h, spp)
        if self.sizes != want:
            raise ValueError(f"path tape made for (local_h, width, spp, max_bounces, block, "
                             f"words) {self.sizes}, the launch is {want}")
        if written and not self.written:
            raise ValueError("no colour pass has written this path tape")
        w = self.words
        if w.device != device:
            raise ValueError(f"path tape is on {w.device}, the launch on {device}")
        if w.dtype != torch.float32 or tuple(w.shape) != tape_shape(cfg, local_h, spp):
            raise ValueError(f"path tape words must be float32 {tape_shape(cfg, local_h, spp)}, "
                             f"got {w.dtype} {tuple(w.shape)}")
        if not w.is_contiguous():
            raise ValueError("path tape words must be contiguous")
        if cfg.max_bounces > MAX_BOUNCES:
            raise ValueError(f"a path tape holds at most {MAX_BOUNCES} bounces, "
                             f"got {cfg.max_bounces}")
        if device.type != "cuda":
            raise ValueError("a path tape is the CUDA kernels': the plain versions trace "
                             "every path")


def _tape_sizes(cfg: RenderConfig, local_h: int, spp: int) -> tuple:
    return (local_h, cfg.width, spp, cfg.max_bounces, cfg.block, TAPE_WORDS[cfg.brdf])


def lane_pair_shares(words: torch.Tensor, light_index: int) -> dict:
    """What the sweep's pass of a bounce meets, read from the flags words of
    a path tape ``words`` [spp, blocks, bounces, words a bounce, threads]
    (``PathTape.words``, of blocks inside the frame) -> by bounce, the lane
    pairs (threads 2 g and 2 g + 1; a block's lone last thread has no
    partner) in which a lane has a hit (``pairs``), and the share of them
    whose two lanes add to one slot: both hit the same sphere (``same``), or
    a lane's winner is the light (``light``), whose slots both lanes' light
    terms reach; ``either`` is their union."""
    flags = words[:, :, :, 0].contiguous().view(torch.int32)
    flags = flags[..., :flags.shape[-1] // LANES * LANES]
    bounce = torch.arange(flags.shape[2], device=flags.device)[:, None]
    live = (bounce < flags[:, :, -1:] >> HIT_SHIFT).unflatten(-1, (-1, LANES))
    idx = (flags & 15).unflatten(-1, (-1, LANES))
    l0, l1, i0, i1 = live[..., 0], live[..., 1], idx[..., 0], idx[..., 1]
    runs = l0 | l1
    same = l0 & l1 & (i0 == i1)
    light = (l0 & (i0 == light_index)) | (l1 & (i1 == light_index))
    pairs = runs.sum((0, 1, 3))

    def share(x):
        return (x & runs).sum((0, 1, 3)) / pairs.clamp(min=1)

    return {"pairs": pairs, "same": share(same), "light": share(light),
            "either": share(same | light)}


# -- a colour pass, then a replay -------------------------------------------------

def color_loss_replay(scene_block, cam_block, seed, cfg: RenderConfig, target, replay, *,
                      local_h: int, spp: int, device, reduce=None):
    """The gradient of the mean-squared pixel loss through a sweep kernel's
    replay: K1's colour sums of ``local_h`` rows and ``spp`` samples at
    ``seed`` (``reduce``: what adds them to those of the frame's other sample
    ranges; None where they are all of them); their mean over cfg.spp less
    ``target`` [local_h, W, 3] gives the loss's cotangent of the mean colour,
    2 (mean - target) / (H W 3), against which ``replay`` (a
    ``replay_color``) sweeps the same rows and samples -> (mean, mean -
    target, flat sums [10N + 16])."""
    kw = dict(local_h=local_h, spp=spp, device=device)
    sums = tk.trace(scene_block, cam_block, seed, cfg, mode="color", **kw)
    mean = (sums if reduce is None else reduce(sums)) / cfg.spp
    diff = mean - target
    denom = cfg.height * cfg.width * 3
    return mean, diff, replay(scene_block, cam_block, seed, cfg, 2.0 * diff / denom, **kw)


# -- the plain sweep ---------------------------------------------------------------

class LaneGroups:
    """The kernel's lane groups over a slab of [local_h, W] pixels: thread
    ``tid = ty * block + tx`` of a block adds into the sums of group
    ``tid // LANES``, as its lane ``tid % LANES``. A block's last thread is
    alone in its group when ``LANES`` does not divide ``block * block``; a
    thread outside the slab adds nothing."""

    def __init__(self, local_h: int, width: int, block: int, device, lanes: int = LANES):
        n_by, n_bx = -(-local_h // block), -(-width // block)
        threads = block * block
        groups = -(-threads // lanes)
        tid = torch.arange(groups * lanes, device=device)
        rows = torch.arange(n_by, device=device)[:, None, None] * block + tid // block
        cols = torch.arange(n_bx, device=device)[None, :, None] * block + tid % block
        inside = (tid < threads) & (rows < local_h) & (cols < width)
        flat = torch.where(inside, rows * width + cols, local_h * width)
        self.index = flat.reshape(n_by * n_bx, groups, lanes)
        self.lanes = lanes

    def split(self, x: torch.Tensor, fill=0.0):
        """Per-pixel ``x`` [local_h, W] -> one [blocks, groups] tensor a lane
        (``fill`` where the lane has no pixel)."""
        x = x.reshape(-1)
        return torch.cat([x, x.new_full((1,), fill)])[self.index].unbind(-1)

    def zeros(self, dtype):
        return torch.zeros(self.index.shape[:2], dtype=dtype, device=self.index.device)


def _pixel_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dtype=torch.float64).to(torch.float32)


def _sweep_plain(lat: tk.PlainLattice, cfg: RenderConfig, spp: int, ct, aov=None,
                 lanes: int = LANES):
    """The kernels' sweep loop (``csrc/sweep.cuh``) over [local_h, W] tensors
    against the colour cotangent ``ct`` [3] and, if given, the bounce-0 AOV
    cotangents ``aov`` [7] (normal xyz, albedo rgb, depth), for the
    configuration of ``cfg`` (diffuse or glossy, with or without NEE) ->
    (shading sums [6N] float32, geometry sums [4N + 15] float64 or None),
    each a [blocks, groups] tensor of the kernel's lane groups. The adds of a
    bounce are made lane by lane in the kernel's order. Without NEE and
    without ``aov`` the geometry chain is dead and only the shading chain
    runs (the kernel's shading-only instance): no geometry sums."""
    n = len(lat.sc)
    nee, glossy = cfg.nee, cfg.brdf == "glossy"
    with_geom = nee or aov is not None
    li = cfg.light_index if nee else 0
    lt = lat.sc[li]
    le = (lt["er"], lt["eg"], lt["eb"])
    push = cfg.push_ray_origin
    zeros = torch.zeros_like(lat.rows)
    groups = LaneGroups(lat.rows.shape[0], lat.rows.shape[1], cfg.block, lat.rows.device, lanes)
    inside = groups.split(torch.ones_like(lat.rows, dtype=torch.bool), False)
    shade = [groups.zeros(torch.float32) for _ in range(6 * n)]
    gsum = [groups.zeros(torch.float64) for _ in range(4 * n + 15)] if with_geom else None

    def run_turns(adds):
        """One bounce's adds (is geometry, slot, value, lanes that add), each
        lane in its turn."""
        adds = [(is_geom, j, groups.split(v), sel) for is_geom, j, v, sel in adds]
        for lane in range(lanes):
            for is_geom, j, v, sel in adds:
                term = torch.where(sel[lane], v[lane], 0.0)
                if is_geom:
                    gsum[j] = gsum[j] + term.to(torch.float64)
                else:
                    shade[j] = shade[j] + term

    for s in range(spp):
        tape = []
        lat.sample(s, cfg, tape)
        oh = [zeros] * 3
        dh = [zeros] * 3
        hb = [zeros] * 3
        for b in range(len(tape) - 1, -1, -1):
            hit, idx, m, e, cc, q = tape[b]
            first = b == 0
            hit_g = groups.split(hit, False)
            sel_g = [groups.split(hit & (idx == i), False) for i in range(n)]
            adds = []
            dl = q["dl"] if nee else zeros
            if with_geom:
                ox, oy, oz = q["o"]
                dx, dy, dz = q["d"]
                dnx, dny, dnz = q["dn"]
                inv_len, t_best = q["inv_len"], q["t"]
                nux, nuy, nuz = q["nu"]
                nx, ny, nz = q["n"]
                n_inv, flip = q["n_inv"], q["flip"]
                if nee:
                    ldx, ldy, ldz = q["ld"]
                    l_inv, dr = q["l_inv"], q["dr"]
                    dlw = torch.where(q["vis"], 0.5, 0.0) * clip01_grad(dr)

                hhx = hhy = hhz = nhx = nhy = nhz = zeros
                if b + 1 < cfg.max_bounces:
                    o1x, o1y, o1z = q["o1"]
                    o1_inv, use_a, cs, ss, zc = (q["o1_inv"], q["use_a"], q["cs"], q["ss"],
                                                 q["zc"])
                    ohx, ohy, ohz = oh
                    dhx, dhy, dhz = dh
                    hhx, hhy, hhz = ohx, ohy, ohz
                    nhx, nhy, nhz = push * ohx, push * ohy, push * ohz
                    if glossy:
                        cx, cy, cz = q["c"]
                        bx, by, bz = q["b"]
                        qx, qy, qz = q["q"]
                        b_inv, dn2, g_inv = q["b_inv"], q["dn2"], q["g_inv"]
                        qd = g_inv * g_inv * g_inv * tk._dot3(qx, qy, qz, dhx, dhy, dhz)
                        rhx = g_inv * dhx - qd * qx
                        rhy = g_inv * dhy - qd * qy
                        rhz = g_inv * dhz - qd * qz
                        nr2 = 2.0 * tk._dot3(nx, ny, nz, rhx, rhy, rhz)
                        bhx, bhy, bhz = rhx - nr2 * nx, rhy - nr2 * ny, rhz - nr2 * nz
                        nhx = nhx - (dn2 * rhx + nr2 * bx)
                        nhy = nhy - (dn2 * rhy + nr2 * by)
                        nhz = nhz - (dn2 * rhz + nr2 * bz)
                        cd = b_inv * b_inv * b_inv * tk._dot3(cx, cy, cz, bhx, bhy, bhz)
                        dhx = b_inv * bhx - cd * cx
                        dhy = b_inv * bhy - cd * cy
                        dhz = b_inv * bhz - cd * cz
                    nhx = nhx + zc * dhx
                    nhy = nhy + zc * dhy
                    nhz = nhz + zc * dhz
                    t1x, t1y, t1z = cs * dhx, cs * dhy, cs * dhz
                    t2x, t2y, t2z = ss * dhx, ss * dhy, ss * dhz
                    nhx = nhx + (o1y * t2z - o1z * t2y)
                    nhy = nhy + (o1z * t2x - o1x * t2z)
                    nhz = nhz + (o1x * t2y - o1y * t2x)
                    t1x = t1x + (t2y * nz - t2z * ny)
                    t1y = t1y + (t2z * nx - t2x * nz)
                    t1z = t1z + (t2x * ny - t2y * nx)
                    sd = o1x * t1x + o1y * t1y + o1z * t1z
                    p1x = o1_inv * (t1x - o1x * sd)
                    p1y = o1_inv * (t1y - o1y * sd)
                    p1z = o1_inv * (t1z - o1z * sd)
                    nhx = nhx + torch.where(use_a, p1y, zeros)
                    nhy = nhy + torch.where(use_a, -p1x, p1z)
                    nhz = nhz + torch.where(use_a, zeros, -p1y)

                spx, spy, spz = q["p"]
                rad = q["rad"]
                relx, rely, relz = spx - ox, spy - oy, spz - oz
                tca = tk._dot3(relx, rely, relz, dnx, dny, dnz)
                qx, qy, qz = relx - tca * dnx, rely - tca * dny, relz - tca * dnz
                det = rad * rad - tk._dot3(qx, qy, qz, qx, qy, qz)
                gate = det > 0.0
                inv_thc = torch.where(gate, torch.rsqrt(torch.where(gate, det, zeros + 1.0)),
                                      zeros)
                a_ = torch.where(q["far"], 1.0, -1.0) * inv_thc
                ux, uy, uz = a_ * qx, a_ * qy, a_ * qz
                corr = 1.0 + tk._dot3(ux, uy, uz, dnx, dny, dnz)
                kpx, kpy, kpz = corr * dnx - ux, corr * dny - uy, corr * dnz - uz
                kdx = corr * relx + tca * ux
                kdy = corr * rely + tca * uy
                kdz = corr * relz + tca * uz
                kr = a_ * rad

                if nee:
                    wdr = dlw * (ct[0] * m[0] * le[0] * cc[0] + ct[1] * m[1] * le[1] * cc[1]
                                 + ct[2] * m[2] * le[2] * cc[2])
                    bvx = l_inv * (nx - ldx * dr)
                    bvy = l_inv * (ny - ldy * dr)
                    bvz = l_inv * (nz - ldz * dr)
                    nhx, nhy, nhz = nhx + wdr * ldx, nhy + wdr * ldy, nhz + wdr * ldz
                    lhx, lhy, lhz = wdr * bvx, wdr * bvy, wdr * bvz
                    hhx, hhy, hhz = hhx - lhx, hhy - lhy, hhz - lhz
                    adds += [(True, 4 * li + 1, lhx, hit_g), (True, 4 * li + 2, lhy, hit_g),
                             (True, 4 * li + 3, lhz, hit_g), (True, 4 * li + 0, -lhy, hit_g)]
                if aov is not None and first:
                    nhx, nhy, nhz = nhx + aov[0], nhy + aov[1], nhz + aov[2]

                ax, ay, az = flip * nhx, flip * nhy, flip * nhz
                sd = nux * ax + nuy * ay + nuz * az
                ppx = n_inv * (ax - nux * sd)
                ppy = n_inv * (ay - nuy * sd)
                ppz = n_inv * (az - nuz * sd)
                hhx, hhy, hhz = hhx + ppx, hhy + ppy, hhz + ppz
                phx, phy, phz = -ppx, -ppy, -ppz

                t_hat = dx * hhx + dy * hhy + dz * hhz
                if aov is not None and first:
                    t_hat = t_hat + aov[6]
                tu_hat = t_hat * inv_len if first else t_hat
                r_hat = tu_hat * kr
                phx, phy, phz = phx + tu_hat * kpx, phy + tu_hat * kpy, phz + tu_hat * kpz
                new_oh = [hhx - tu_hat * kpx, hhy - tu_hat * kpy, hhz - tu_hat * kpz]
                new_dh = [t_best * hhx, t_best * hhy, t_best * hhz]
                dnhx, dnhy, dnhz = tu_hat * kdx, tu_hat * kdy, tu_hat * kdz
                if first:
                    il_hat = t_hat * (t_best / inv_len)
                    il_hat = il_hat + (dx * dnhx + dy * dnhy + dz * dnhz)
                    sdot = -(inv_len * inv_len * inv_len) * il_hat
                    new_dh = [new_dh[0] + (inv_len * dnhx + sdot * dx),
                              new_dh[1] + (inv_len * dnhy + sdot * dy),
                              new_dh[2] + (inv_len * dnhz + sdot * dz)]
                else:
                    new_dh = [new_dh[0] + dnhx, new_dh[1] + dnhy, new_dh[2] + dnhz]
                oh = [torch.where(hit, a, b_) for a, b_ in zip(new_oh, oh)]
                dh = [torch.where(hit, a, b_) for a, b_ in zip(new_dh, dh)]
                for param, v in enumerate((r_hat, phx, phy, phz)):
                    adds += [(True, 4 * i + param, v, sel_g[i]) for i in range(n)]

            for ch in range(3):
                cmv = clip01_grad(m[ch] * e[ch]) if first else 1.0
                src = dl * le[ch] + hb[ch] if nee else hb[ch]
                ae = ct[ch] * (m[ch] * cmv)
                acb = ct[ch] * (m[ch] * src)
                adds += [(False, 6 * i + ch, ae, sel_g[i]) for i in range(n)]
                adds += [(False, 6 * i + 3 + ch, acb, sel_g[i]) for i in range(n)]
                if nee:
                    adds.append((False, 6 * li + ch, ct[ch] * (m[ch] * dl * cc[ch]), hit_g))
                if aov is not None and first:
                    adds += [(False, 6 * i + 3 + ch, aov[3 + ch], sel_g[i]) for i in range(n)]
                hb[ch] = torch.where(hit, cmv * e[ch] + src * cc[ch], hb[ch])
            run_turns(adds)

        if with_geom and tape:
            u, v = tape[0][5]["uv"]
            w = [(1.0 - u) * (1.0 - v), u * (1.0 - v), (1.0 - u) * v, u * v]
            adds = [(True, 4 * n + a, oh[a], inside) for a in range(3)]
            adds += [(True, 4 * n + 3 + 3 * c + a, w[c] * dh[a], inside)
                     for c in range(4) for a in range(3)]
            run_turns(adds)
    return shade, gsum


def _flat_sums(n: int, shade, geom, loss):
    """The sums of the lane groups (``geom`` None: exact zeros) and the
    per-pixel loss, summed in double -> [10N + 16]."""
    if geom is None:
        geom = [shade[0].new_zeros(())] * (4 * n + 15)
    out = []
    for i in range(n):
        out += [geom[4 * i + p] for p in range(4)] + shade[6 * i: 6 * i + 6]
    out += geom[4 * n: 4 * n + 15] + [loss]
    return torch.stack([_pixel_sum(x) for x in out])


# -- agreement of two outputs ------------------------------------------------------
# The kernel against its plain version. Both add each pixel's contributions
# in the same order in float32 and sum over pixels in double, so an entry
# may differ by float32 rounding of the per-pixel terms: within rtol 1e-4
# plus 1e-6 of the largest |reference| among the entries of its kind
# (radius, position, emission, albedo, eye, corner rays, loss). Where two
# orders of operations meet (the replay against fused, slabs against the
# frame) the geometry sums' cancellation
# shows: 1e-4 of the largest of the kind, the JAX package's tolerance for
# its replay against its fused mode. Colour: trace_kernel.agreement's
# colour rule on the mean.
SUMS_RTOL = 1e-4
SUMS_ATOL = 1e-6  # x max |reference| of the entry's kind
CROSS_ATOL = 1e-4  # the same, between two orders of operations
KINDS = ("radius", "position", "emission", "albedo", "eye", "basis", "loss")


def entry_kinds(n: int) -> np.ndarray:
    """The kind (an index into ``KINDS``) of each of the 10N + 16 sums."""
    sphere = [0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    return np.array(sphere * n + [4] * 3 + [5] * 12 + [6])


def agreement(got: torch.Tensor, ref: torch.Tensor, kind: str, atol: float = SUMS_ATOL):
    """Hold ``got`` against ``ref`` -> (checks, max |got - ref|); each check
    is (name, share out of tolerance, ceiling, ok). ``kind``: "sums"
    [10N + 16] (``atol`` x the largest of the entry's kind) or "color"
    [h, W, 3] (means)."""
    if kind == "color":
        return tk.agreement(got, ref, "color", 1)
    if kind != "sums":
        raise ValueError(f"kind must be 'sums' or 'color', got {kind!r}")
    got = got.detach().to("cpu", torch.float64).numpy()
    ref = ref.detach().to("cpu", torch.float64).numpy()
    if got.shape != ref.shape or got.ndim != 1 or (got.shape[0] - 16) % 10:
        raise ValueError(f"shapes {got.shape} and {ref.shape} are not two [10N + 16] sums")
    kinds = entry_kinds((got.shape[0] - 16) // 10)
    diff = np.abs(got - ref)
    finite = np.isfinite(got) & np.isfinite(ref)
    out = [("finite", float((~finite).mean()), 0.0, bool(finite.all()))]
    for k, name in enumerate(KINDS):
        sel = kinds == k
        tol = SUMS_RTOL * np.abs(ref[sel]) + atol * np.abs(ref[sel]).max()
        share = float((~(diff[sel] <= tol)).mean())
        out.append((name, share, 0.0, share <= 0.0))
    return out, float(np.nan_to_num(diff, nan=np.inf).max())


# -- the gradient block ---------------------------------------------------------

def block_from_sums(sums: torch.Tensor) -> torch.Tensor:
    """Flat sums [10N + 16] -> the gradient block [N + 5, 11]."""
    n = (sums.shape[0] - 16) // 10
    block = sums.new_zeros((n + 5, BLOCK_COLS))
    block[:n, :10] = sums[: 10 * n].reshape(n, 10)
    block[n, 0:3] = sums[10 * n: 10 * n + 3]
    block[n + 1: n + 5, 0:3] = sums[10 * n + 3: 10 * n + 15].reshape(4, 3)
    block[n, LOSS_COL] = sums[10 * n + 15]
    return block


def scene_grads_from_block(block: torch.Tensor) -> Scene:
    n = block.shape[0] - 5
    return Scene(block[:n, 0], block[:n, 1:4], block[:n, 4:7], block[:n, 7:10])


def basis_jacobian(cam, cfg: RenderConfig) -> torch.Tensor:
    """[2, 12]: the derivatives of ``Camera.eye_ray_basis`` [4, 3] (flattened)
    by yaw and by pitch, taken with autograd where the camera lives, in one
    batched backward (the chain the ``"torch"`` backend differentiates; the
    basis does not depend on the position)."""
    yaw, pitch = (getattr(cam, k).detach().requires_grad_(True) for k in ("yaw", "pitch"))
    with torch.enable_grad():
        basis = Camera(cam.position.detach(), yaw, pitch).eye_ray_basis(cfg.width, cfg.height)
        rows = torch.eye(basis.numel(), dtype=basis.dtype, device=basis.device)
        d_yaw, d_pitch = torch.autograd.grad(basis, (yaw, pitch),
                                             grad_outputs=rows.reshape(-1, *basis.shape),
                                             is_grads_batched=True)
    return torch.stack([d_yaw, d_pitch])


def grads_from_block(scene, cam, cfg: RenderConfig, block: torch.Tensor):
    """Gradient block -> (d_scene, d_camera) on the block's device. The corner
    rays' cotangents are pulled back through ``Camera.eye_ray_basis`` as
    ``jax.vjp`` pulls them back on the block's device: its Jacobian
    (``basis_jacobian``) is taken where the camera lives, moved to the
    block's device without a wait for the card and contracted there, so
    nothing is read back from the card. The ray origin's eye cotangent is
    the position gradient."""
    n = scene.num_objects
    if tuple(block.shape) != (n + 5, BLOCK_COLS):
        raise ValueError(f"block must be [{n + 5}, {BLOCK_COLS}], got {tuple(block.shape)}")
    block = block.detach()
    jac = to_device(basis_jacobian(cam, cfg), block.device)
    d_yaw, d_pitch = (jac * block[n + 1: n + 5, 0:3].reshape(1, -1)).sum(dim=1)
    d_cam = Camera(block[n, 0:3].clone(), d_yaw, d_pitch, device=block.device)
    return scene_grads_from_block(block), d_cam
