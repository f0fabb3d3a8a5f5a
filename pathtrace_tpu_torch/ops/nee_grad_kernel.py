"""The NEE diffuse gradient kernel and its plain PyTorch versions.

The counterpart of ``pathtrace_tpu/ops/pallas_nee_grad.py``. ``csrc/
nee_grad_kernel.cu`` replaces its TPU kernel ``_nee_grad_kernel`` (K3): a
thread per pixel retraces its samples' NEE paths with the forward kernel's
own segment, tapes what cannot be recomputed, and runs the hand-derived
reverse sweep for ALL parameters: each sphere's radius, position, emission
and albedo, the eye and the four corner rays. Two modes:

- ``"fused"``: loss and gradients of the squared pixel error against a
  target, and the mean colour, in one launch: each thread loops over its
  pixel's samples twice, colour first, then the replay sweep against the
  pixel's own cotangent.
- ``"replay"``: gradients of ``sum(cotangent * colour sum)`` for a given
  per-pixel cotangent.

``fused`` and ``replay`` are the wrappers. On the CPU they run
``fused_plain`` and ``replay_plain``, a transcription of the kernel's own
order of operations over [h, W] tensors on top of ``trace_kernel``'s plain
trajectory; on a CUDA device they launch the kernel, or raise. The reverse
sweep (``csrc/sweep.cuh``, here ``_sweep_plain``) is shared with the
all-parameter backward of ``ops/ad_grad_kernel.py``, which instantiates it
for glossy, for no NEE and with the bounce-0 AOV cotangents as well. Both give
the flat sums [10N + 16]: sphere i at 10 i (radius, position xyz, emission
rgb, albedo rgb), the eye at 10N, the corner rays 00, 10, 01, 11 at
10N + 3, the loss (fused) at 10N + 15. ``block_from_sums`` lays them out
as the JAX package's gradient block, cropped to the rows and columns it
uses: [N + 5, 11].

The kernel lets ``LANES`` neighbouring threads of a block share one set of
sums in shared memory and add to it in ordered turns; the plain versions
follow that order (``LaneGroups``). The geometry sums cancel heavily (walls
of radius 1e5): they are kept in double, each contribution a float32, and
the sum over lane groups is taken in double precision too, by the kernel
and the plain versions alike.

Entry points (the JAX package's names, plus ``device=``):
``nee_loss_and_grads``, ``nee_grads_block_slab`` (rows and samples at an
offset: the sharding hook), ``grads_from_block``, and ``nee_color_grads``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.ops.grad_kernel import _per_pixel
from pathtrace_tpu_torch.ops.build import CSRC, load_function
from pathtrace_tpu_torch.ops.sampling import clip01_grad
from pathtrace_tpu_torch.scene import Scene
from pathtrace_tpu_torch.utils import timing
from pathtrace_tpu_torch.utils.transfer import to_device

SOURCE = CSRC / "nee_grad_kernel.cu"
MODES = ("fused", "replay")
MAX_BOUNCES = 16  # the kernel's tape holds this many bounces a thread
# A block's shared memory on sm_90. The largest launch either sweep kernel
# accepts (16 spheres, a 16 x 16 block: 131,712 bytes) is below it.
MAX_SHARED_BYTES = 232448
# Block layout (the JAX package's, cropped): rows 0..N-1 the spheres (col 0
# radius, 1-3 position, 4-6 emission, 7-9 albedo), row N the eye (cols 0-2)
# and the loss (col 10), rows N+1..N+4 the corner rays (cols 0-2).
BLOCK_COLS = 11
LOSS_COL = 10


def require_nee_diffuse(cfg: RenderConfig, what: str):
    if not cfg.nee or cfg.brdf != "diffuse":
        raise ValueError(f"{what} needs nee=True and brdf='diffuse', got nee={cfg.nee}, "
                         f"brdf={cfg.brdf!r}")


LANES = 2  # csrc/sweep.cuh's kLanes: threads that share one set of sums


def n_slots(num_spheres: int, geom: bool = True) -> int:
    """4-byte words of sums a lane group: 6N shading floats and, with the
    geometry chain, 4N + 15 geometry doubles."""
    return 6 * num_spheres + (2 * (4 * num_spheres + 15) if geom else 0)


def shared_bytes(num_spheres: int, block: int, geom: bool = True) -> int:
    """Dynamic shared memory of a ``block`` x ``block`` launch
    (``csrc/sweep.cuh``'s ``SweepLayout``): the sums of every lane group, a
    loss float a thread and the sphere table."""
    threads = block * block
    groups = -(-threads // LANES)
    return 4 * (n_slots(num_spheres, geom) * groups + threads + 10 * num_spheres)


# -- the plain versions ----------------------------------------------------------

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


def fused_plain(scene_block, cam_block, seed, cfg: RenderConfig, target, *, local_h: int,
                spp: int, device=None):
    """Plain fused mode -> (sums [10N + 16], colour [local_h, W, 3]): the
    gradient of sum((mean - target)^2) and, last, that loss; no 1/denom."""
    require_nee_diffuse(cfg, "fused_plain")
    lat = tk.PlainLattice(scene_block, cam_block, seed, cfg, local_h, device)
    inv_spp = tk._f32(1.0 / spp)
    col_sum = [torch.zeros_like(lat.rows)] * 3
    for s in range(spp):
        col, *_ = lat.sample(s, cfg)
        col_sum = [a + b for a, b in zip(col_sum, col)]
    mean = [x * inv_spp for x in col_sum]
    res = [m - t for m, t in zip(mean, target.unbind(-1))]
    shade, geom = _sweep_plain(lat, cfg, spp, [2.0 * r * inv_spp for r in res])
    loss = res[0] * res[0] + res[1] * res[1] + res[2] * res[2]
    return _flat_sums(len(lat.sc), shade, geom, loss), torch.stack(mean, dim=-1)


def replay_plain(scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *, local_h: int,
                 spp: int, device=None):
    """Plain replay mode -> sums [10N + 16] (0 in the loss slot): the gradient
    of sum(cotangent * colour sum), ``cotangent`` [local_h, W, 3] with 1/spp
    folded in by the caller."""
    require_nee_diffuse(cfg, "replay_plain")
    lat = tk.PlainLattice(scene_block, cam_block, seed, cfg, local_h, device)
    shade, geom = _sweep_plain(lat, cfg, spp, list(cotangent.unbind(-1)))
    return _flat_sums(len(lat.sc), shade, geom, torch.zeros_like(lat.rows))


# -- the CUDA kernel -------------------------------------------------------------

class CudaNeeGradKernel:
    """ctypes binding of ``pt_nee_grad_launch``. ``launches[mode]`` counts the
    kernel launches made through ``launch`` in each mode."""

    def __init__(self):
        self._lib = None  # keeps the library loaded while _fn is in use
        self._fn = None
        self.launches = {m: 0 for m in MODES}

    def _function(self):
        if self._fn is None:
            self._lib, self._fn = load_function(SOURCE, "pt_nee_grad_launch_padded", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int,
            ])
        return self._fn

    def occupancy(self, mode: str, block: int, num_spheres: int, pad_shared: int = 0) -> dict:
        """What the card gives a ``block`` x ``block`` launch of ``mode`` that
        asks for ``pad_shared`` dynamic shared bytes beyond its own: resident
        blocks an SM, registers a thread, dynamic shared bytes a block, local
        bytes a thread."""
        self._function()
        out = (ctypes.c_int * 4)()
        err = self._lib.pt_nee_grad_occupancy(MODES.index(mode), block, num_spheres,
                                              pad_shared, out)
        if err != 0:
            raise RuntimeError(f"NEE grad kernel occupancy query failed: cudaError {err}")
        return dict(zip(("blocks_per_sm", "registers", "shared_bytes", "local_bytes"), out))

    def launch(self, mode: str, scene_block, cam_block, seed, cfg: RenderConfig, pixels, *,
               local_h: int, spp: int, device: torch.device, pad_shared: int = 0):
        """Launch ``mode`` on the current stream of ``device`` (asynchronous).
        fused -> (sums, colour); replay -> sums. ``pad_shared``: dynamic
        shared bytes to ask for beyond the block's own, so that fewer blocks
        fit an SM; only the occupancy curve of ``scripts/
        torch_sweep_occupancy.py`` and ``chip_smoke.py`` passes it."""
        t0 = timing.launch_clock()
        fn = self._function()
        held, scene_at, cam_at, seed_at = tk.launch_operands(scene_block, cam_block, seed,
                                                              device)
        n_out = 10 * scene_block.shape[0] + 16
        w, block = cfg.width, cfg.block
        color = None
        if mode == "fused":
            color = torch.empty((local_h, w, 3), dtype=torch.float32, device=device)
        n_blocks = -(-w // block) * -(-local_h // block)
        partial = torch.empty((n_blocks, n_out), dtype=torch.float64, device=device)
        sums = torch.empty((n_out,), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(
                scene_at, scene_block.shape[0], cam_at, seed_at, local_h, w,
                tk._f32(1.0 / w), tk._f32(1.0 / cfg.height),
                spp, tk._f32(1.0 / spp), cfg.max_bounces, int(cfg.resolved_jitter),
                cfg.push_ray_origin, cfg.light_index, MODES.index(mode), block,
                pixels.data_ptr(),
                None if color is None else color.data_ptr(), partial.data_ptr(),
                sums.data_ptr(), stream, pad_shared,
            )
        if err != 0:
            raise RuntimeError(f"NEE grad kernel ({mode}) launch failed: cudaError {err}")
        self.launches[mode] += 1
        if mode == "replay":
            timing.add_launch_ns("k3.replay", t0)
        return (sums, color) if mode == "fused" else sums


CUDA_KERNEL = CudaNeeGradKernel()
timing.launch_counter("k3.replay", lambda: CUDA_KERNEL.launches["replay"])


def _check(scene_block, cam_block, seed, cfg: RenderConfig, local_h, spp, pixels, dev, what):
    require_nee_diffuse(cfg, what)
    tk.check_blocks(scene_block, cam_block, seed, cfg, local_h, spp)
    if cfg.max_bounces > MAX_BOUNCES:
        raise ValueError(f"the NEE gradient kernel takes at most {MAX_BOUNCES} bounces, "
                         f"got {cfg.max_bounces}")
    shape = (local_h, cfg.width, 3)
    if pixels.dtype != torch.float32 or tuple(pixels.shape) != shape:
        raise ValueError(f"per-pixel input must be float32 {shape}, got "
                         f"{pixels.dtype} {tuple(pixels.shape)}")
    if not pixels.is_contiguous():
        raise ValueError("per-pixel input must be contiguous")
    if pixels.device != dev:
        raise ValueError(f"per-pixel input is on {pixels.device}, the launch on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no NEE gradient kernel for device {dev}")


def fused(scene_block, cam_block, seed, cfg: RenderConfig, target, *, local_h: int, spp: int,
          device=None):
    """The fused-mode wrapper -> (sums [10N + 16], colour [local_h, W, 3]) on
    ``device`` (default: the blocks'). CPU: the plain version. CUDA: the
    kernel, or an exception."""
    dev = tk.launch_device(scene_block, device)
    _check(scene_block, cam_block, seed, cfg, local_h, spp, target, dev, "fused")
    kw = dict(local_h=local_h, spp=spp, device=dev)
    if dev.type == "cpu":
        return fused_plain(scene_block, cam_block, seed, cfg, target, **kw)
    return CUDA_KERNEL.launch("fused", scene_block, cam_block, seed, cfg, target, **kw)


def replay(scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *, local_h: int,
           spp: int, device=None):
    """The replay-mode wrapper -> sums [10N + 16] (0 in the loss slot)."""
    dev = tk.launch_device(scene_block, device)
    _check(scene_block, cam_block, seed, cfg, local_h, spp, cotangent, dev, "replay")
    kw = dict(local_h=local_h, spp=spp, device=dev)
    if dev.type == "cpu":
        return replay_plain(scene_block, cam_block, seed, cfg, cotangent, **kw)
    return CUDA_KERNEL.launch("replay", scene_block, cam_block, seed, cfg, cotangent, **kw)


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


# -- entry points (the JAX package's signatures, plus a device) ---------------------

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


def nee_loss_and_grads(scene, cam, cfg: RenderConfig, frame, target, device=None):
    """(loss, (d_scene, d_camera)) of the mean-squared pixel colour loss for an
    NEE diffuse config, all parameters: one fused launch."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    sums, _ = fused(sb, cb, tk.make_seed_block(cfg, frame), cfg, _per_pixel(target, device),
                    local_h=cfg.height, spp=cfg.spp, device=device)
    block = block_from_sums(sums) / (cfg.height * cfg.width * 3)
    return block[scene.num_objects, LOSS_COL], grads_from_block(scene, cam, cfg, block)


def nee_grads_block_slab(scene, cam, cfg: RenderConfig, frame, ct_block, row_offset=0,
                         local_h=None, spp=None, sample_offset=0, device=None):
    """Gradient block [N + 5, 11] of rows [row_offset, row_offset + local_h)
    and samples [sample_offset, sample_offset + spp) against a known
    per-SAMPLE colour cotangent ``ct_block`` [3, local_h, W] (1/global-spp
    folded in by the caller): one replay launch. Blocks of different slabs
    and sample ranges add up to the frame's."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    local_h = cfg.height if local_h is None else local_h
    ct = _per_pixel(ct_block, device).permute(1, 2, 0).contiguous()
    sums = replay(sb, cb, tk.make_seed_block(cfg, frame, sample_offset, row_offset), cfg, ct,
                  local_h=local_h, spp=cfg.spp if spp is None else spp, device=device)
    return block_from_sums(sums)


def nee_color_grads(scene, cam, cfg: RenderConfig, frame, cotangent, device=None):
    """Gradient block [N + 5, 11] of sum(cotangent * mean colour) for
    ``cotangent`` [H, W, 3]: one replay launch."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    ct = _per_pixel(cotangent, device) / cfg.spp
    sums = replay(sb, cb, tk.make_seed_block(cfg, frame), cfg, ct, local_h=cfg.height,
                  spp=cfg.spp, device=device)
    return block_from_sums(sums)
