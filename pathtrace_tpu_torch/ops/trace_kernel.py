"""The forward path-trace kernel and its plain PyTorch version.

``csrc/trace_kernel.cu`` replaces ``pathtrace_tpu/ops/pallas_trace.py::
_pathtrace_kernel``: the L sample lanes of a pixel (``sample_lanes``: one
for a frame that fills the card, up to 4 for a smaller one) trace its
samples round by round, add them into the pixel's sums in sample order
(``lane_schedule``, ``add_order``) and write one channels-last vector, in one
of three modes:

- ``"channels"``: 14 finished channels (means + variances);
- ``"partials"``: 22 mergeable channels, 10 raw sums + Welford
  (n, mean, M2) of the colour/normal/albedo/depth luminances;
- ``"color"``: 3 raw colour sums.

``trace`` is the wrapper. On the CPU it runs ``trace_plain``, a direct
transcription of ``trace_tile_sample`` + ``sample_body`` over [h, W]
tensors; on a CUDA device it launches the kernel, or raises. It never falls
back from one to the other. The scene [N, 10], camera [5, 3] and seed [5]
blocks are device arrays, as the TPU kernel's scalar-prefetch operands are
SMEM arrays: the launch queues their copy into the kernel's constant memory
on its stream, just before the kernel (``csrc/common.cuh::stage_blocks``).
The entry points build the scene and camera blocks where the scene and
camera live (``device_blocks``); the wrapper takes blocks on the launch
device, or on the host, which it moves there with the seed block by one
copy that does not wait for the card (``launch_operands``). So no entry
point reads a value back from the card, and a launch on device blocks can
be captured in a CUDA graph and replayed on new block contents.

``agreement`` holds two outputs of one mode against each other, channel by
channel, under the tolerances stated with it.

The kernel is built with nvcc at first use into ``pathtrace_tpu_torch/
build/`` (``ops/build.py``: rebuilt when the source, a header it includes or
the flags change) and bound with ctypes. Both versions draw the lattice of ``rng.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple, Union

import numpy as np
import torch

from pathtrace_tpu_torch import rng
from pathtrace_tpu_torch.config import MAX_BLOCK, RenderConfig
from pathtrace_tpu_torch.ops.build import CSRC, load_function
from pathtrace_tpu_torch.ops.variance import LUMA, Moments
from pathtrace_tpu_torch.render import FEATURES, resolve_device, unpack_channels
from pathtrace_tpu_torch.utils import timing
from pathtrace_tpu_torch.utils.transfer import to_device

T_BIG = 1.0e6
TWO_PI = 6.283185307179586
MAX_SPHERES = 16
MAX_THREADS = 256  # a block of the kernels K1 and K2: pixels x sample lanes
MAX_LANES = 4
# Threads an SM below which a launch of one thread a pixel leaves the card
# short of warps: 32 warps, what an SM keeps of a kernel at 64 registers.
FILL_THREADS = 1024
SPHERE_ROW_WORDS = 10  # a row of the shared sphere table: radius, position, emission, albedo
SHARED_BANKS = 32
MODES = {"channels": 14, "partials": 22, "color": 3}
# Names of the statistics channels 10.. of each mode.
STAT_CHANNELS = {
    "channels": tuple(f"{k}_var" for k in FEATURES),
    "partials": tuple(f"{k}_{s}" for k in FEATURES for s in ("n", "mean", "m2")),
    "color": (),
}

SOURCE = CSRC / "trace_kernel.cu"

# A seed block: the five integers of make_seed_block, or their int32 [5]
# tensor (seed_array), on the host or on the launch device.
SeedBlock = Union[Tuple[int, int, int, int, int], torch.Tensor]


def make_seed_block(cfg: RenderConfig, frame=0, sample_offset=0, row_offset=0,
                    col_offset=0) -> SeedBlock:
    """(seed, frame, sample offset, row offset, col offset): the absolute
    lattice position of a launch. The offsets are the sharding hook."""
    return (cfg.seed & 0x7FFFFFFF, int(frame), int(sample_offset), int(row_offset),
            int(col_offset))


def seed_array(seed: SeedBlock, device=None) -> torch.Tensor:
    """The seed block as the kernels read it: int32 [5] holding each value's
    low 32 bits (read as uint32), on ``device`` (default: the host), moved
    there without a wait for the card. ``make_seed_array``'s values in the
    JAX package."""
    if torch.is_tensor(seed):
        return to_device(seed, device)
    words = [int(x) & 0xFFFFFFFF for x in seed]
    host = torch.tensor([w - (1 << 32) if w >= 1 << 31 else w for w in words],
                        dtype=torch.int32)
    return to_device(host, device)


def seed_values(seed: SeedBlock) -> tuple:
    """The five integers of a seed block (a tensor's as uint32, read on the
    host: the plain versions' route)."""
    if torch.is_tensor(seed):
        return tuple(int(x) & 0xFFFFFFFF for x in seed.tolist())
    return tuple(seed)


def camera_block(cam, cfg: RenderConfig) -> torch.Tensor:
    """[5, 3] float32: the eye, then the corner rays 00, 10, 01, 11."""
    basis = cam.eye_ray_basis(cfg.width, cfg.height)
    return torch.cat([cam.position[None, :], basis], dim=0).to(torch.float32).contiguous()


# -- the plain version ---------------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _sample_plain(sc, eye, basis, rows, cols, draw, cfg: RenderConfig, tape=None):
    """ONE sample's trajectory over [h, W] tensors: ``trace_tile_sample``
    term for term. ``sc`` holds per-sphere Python floats (exact f32 values)
    with the f32 products ``rad * rad`` and ``py - rad`` precomputed, since
    a product of two Python floats would be taken in double. A list given as
    ``tape`` receives one (hit, sphere index, throughput, emission, albedo,
    geometry) entry a bounce, the throughput as it was before the bounce:
    the forward tape of the gradient kernels' reverse sweeps. ``geometry``
    is a dict of the bounce's geometric intermediates (with the light's under
    NEE and the reflection chain's under glossy), which the all-parameter
    sweep (``ops/nee_grad_kernel.py``, ``ops/ad_grad_kernel.py``) reads; the
    product-chain sweep (``ops/grad_kernel.py``) ignores it."""
    zeros = torch.zeros_like(rows)
    spb = cfg.slots_per_bounce
    push = cfg.push_ray_origin
    nee = cfg.light_index if cfg.nee else None

    def bilerp(axis, u, v):
        b00, b10, b01, b11 = (b[axis] for b in basis)
        return (b00 * (1.0 - u) + b10 * u) * (1.0 - v) + (b01 * (1.0 - u) + b11 * u) * v

    if cfg.resolved_jitter:
        r = rows + (draw(0) - 0.5)
        c = cols + (draw(1) - 0.5)
    else:
        r, c = rows, cols
    ndc_x = 2.0 * c * _f32(1.0 / cfg.width) - 1.0
    ndc_y = 1.0 - 2.0 * r * _f32(1.0 / cfg.height)
    u = (ndc_x + 1.0) * 0.5
    v = (ndc_y + 1.0) * 0.5
    dx, dy, dz = bilerp(0, u, v), bilerp(1, u, v), bilerp(2, u, v)
    ox, oy, oz = zeros + eye[0], zeros + eye[1], zeros + eye[2]

    col = [zeros, zeros, zeros]
    mask = [zeros + 1.0, zeros + 1.0, zeros + 1.0]
    active = torch.ones_like(rows, dtype=torch.bool)
    fn = [zeros, zeros, zeros]
    fa = [zeros, zeros, zeros]
    f_d = zeros
    hit0 = torch.zeros_like(active)

    for bounce in range(cfg.max_bounces):
        if bounce == 0:
            inv_len = torch.rsqrt(_dot3(dx, dy, dz, dx, dy, dz))
            dnx, dny, dnz = dx * inv_len, dy * inv_len, dz * inv_len
        else:
            inv_len = None
            dnx, dny, dnz = dx, dy, dz

        t_best = torch.full_like(rows, T_BIG)
        hit = torch.zeros_like(active)
        s_idx = torch.zeros_like(rows, dtype=torch.int64)
        s_p = [zeros, zeros, zeros]
        s_e = [zeros, zeros, zeros]
        s_c = [zeros, zeros, zeros]
        s_rad, s_far = zeros, torch.zeros_like(active)
        for i, s in enumerate(sc):
            rel_x, rel_y, rel_z = s["px"] - ox, s["py"] - oy, s["pz"] - oz
            tca = _dot3(rel_x, rel_y, rel_z, dnx, dny, dnz)
            qx, qy, qz = rel_x - tca * dnx, rel_y - tca * dny, rel_z - tca * dnz
            det = s["rad2"] - _dot3(qx, qy, qz, qx, qy, qz)
            thc = torch.where(det > 0.0, torch.sqrt(torch.clamp(det, min=0.0)), zeros)
            if inv_len is None:
                t_near, t_far = tca - thc, tca + thc
            else:
                t_near, t_far = (tca - thc) * inv_len, (tca + thc) * inv_len
            t = torch.where(t_near > 0.0, t_near, t_far)
            closer = (det >= 0.0) & (t > 0.0) & (t < T_BIG) & (t < t_best)
            t_best = torch.where(closer, t, t_best)
            hit = hit | closer
            if tape is not None:
                s_idx = torch.where(closer, i, s_idx)
                s_rad = torch.where(closer, s["rad"], s_rad)
                s_far = torch.where(closer, ~(t_near > 0.0), s_far)
            s_p = [torch.where(closer, s[k], x) for k, x in zip(("px", "py", "pz"), s_p)]
            s_e = [torch.where(closer, s[k], x) for k, x in zip(("er", "eg", "eb"), s_e)]
            s_c = [torch.where(closer, s[k], x) for k, x in zip(("cr", "cg", "cb"), s_c)]

        hit_now = active & hit
        hx, hy, hz = ox + dx * t_best, oy + dy * t_best, oz + dz * t_best
        nx, ny, nz = hx - s_p[0], hy - s_p[1], hz - s_p[2]
        n_inv = torch.rsqrt(_dot3(nx, ny, nz, nx, ny, nz) + 1e-20)
        nx, ny, nz = nx * n_inv, ny * n_inv, nz * n_inv
        flip = torch.where(_dot3(nx, ny, nz, dx, dy, dz) < 0.0, 1.0, -1.0)
        geo = None
        if tape is not None:
            geo = dict(uv=(u, v), o=(ox, oy, oz), d=(dx, dy, dz), dn=(dnx, dny, dnz),
                       inv_len=inv_len, t=t_best, p=tuple(s_p), rad=s_rad, far=s_far,
                       nu=(nx, ny, nz), n_inv=n_inv, flip=flip)
        nx, ny, nz = nx * flip, ny * flip, nz * flip
        if geo is not None:
            geo["n"] = (nx, ny, nz)

        e = [m * se for m, se in zip(mask, s_e)]
        if bounce == 0:
            e = [torch.clamp(x, 0.0, 1.0) for x in e]
        if nee is not None:
            lt = sc[nee]
            lb_x, lb_y, lb_z = lt["px"], lt["py_minus_rad"], lt["pz"]
            sox, soy, soz = hx + nx * push, hy + ny * push, hz + nz * push
            lvx, lvy, lvz = lb_x - hx, lb_y - hy, lb_z - hz
            l_inv = torch.rsqrt(_dot3(lvx, lvy, lvz, lvx, lvy, lvz) + 1e-20)
            ldx, ldy, ldz = lvx * l_inv, lvy * l_inv, lvz * l_inv
            svx, svy, svz = lb_x - sox, lb_y - soy, lb_z - soz
            t_light = torch.sqrt(_dot3(svx, svy, svz, svx, svy, svz))
            diffuse = torch.clamp(_dot3(ldx, ldy, ldz, nx, ny, nz), 0.0, 1.0)
            vis = torch.ones_like(active)
            for i, s in enumerate(sc):
                if i == nee:
                    continue
                rel_x, rel_y, rel_z = s["px"] - sox, s["py"] - soy, s["pz"] - soz
                tca = _dot3(rel_x, rel_y, rel_z, ldx, ldy, ldz)
                qx, qy, qz = rel_x - tca * ldx, rel_y - tca * ldy, rel_z - tca * ldz
                det = s["rad2"] - _dot3(qx, qy, qz, qx, qy, qz)
                thc = torch.where(det > 0.0, torch.sqrt(torch.clamp(det, min=0.0)), zeros)
                t_near, t_far = tca - thc, tca + thc
                t = torch.where(t_near > 0.0, t_near, t_far)
                vis = vis & ~((det >= 0.0) & (t > 0.0) & (t < t_light))
            dl = diffuse * torch.where(vis, 1.0, 0.0) * 0.5
            e = [x + m * dl * lt[k] * sc_ for x, m, k, sc_ in
                 zip(e, mask, ("er", "eg", "eb"), s_c)]
            if geo is not None:
                geo.update(ld=(ldx, ldy, ldz), l_inv=l_inv, vis=vis, dl=dl,
                           dr=_dot3(ldx, ldy, ldz, nx, ny, nz))
        col = [cc + torch.where(hit_now, x, zeros) for cc, x in zip(col, e)]
        if tape is not None:
            tape.append((hit_now, s_idx, mask, s_e, s_c, geo))
        mask = [torch.where(hit_now, m * c_, m) for m, c_ in zip(mask, s_c)]

        if bounce == 0:
            fn = [torch.where(hit_now, x, zeros) for x in (nx, ny, nz)]
            fa = [torch.where(hit_now, x, zeros) for x in s_c]
            f_d = torch.where(hit_now, t_best, zeros)
            hit0 = hit_now

        if bounce + 1 < cfg.max_bounces:
            u1 = draw(2 + spb * bounce)
            u2 = draw(2 + spb * bounce + 1)
            use_a = torch.abs(nx) > torch.abs(nz)
            o1x = torch.where(use_a, -ny, zeros)
            o1y = torch.where(use_a, nx, -nz)
            o1z = torch.where(use_a, zeros, ny)
            o1_inv = torch.rsqrt(_dot3(o1x, o1y, o1z, o1x, o1y, o1z) + 1e-20)
            o1x, o1y, o1z = o1x * o1_inv, o1y * o1_inv, o1z * o1_inv
            o2x = ny * o1z - nz * o1y
            o2y = nz * o1x - nx * o1z
            o2z = nx * o1y - ny * o1x
            phi = u1 * TWO_PI
            zc = torch.sqrt(u2)
            sin_t = torch.sqrt(torch.clamp(1.0 - zc * zc, min=0.0))
            cs, ss = torch.cos(phi) * sin_t, torch.sin(phi) * sin_t
            if geo is not None:
                geo.update(o1=(o1x, o1y, o1z), o1_inv=o1_inv, use_a=use_a, cs=cs, ss=ss, zc=zc)
            bdx = cs * o1x + ss * o2x + zc * nx
            bdy = cs * o1y + ss * o2y + zc * ny
            bdz = cs * o1z + ss * o2z + zc * nz
            if cfg.brdf == "glossy":
                b_inv = torch.rsqrt(_dot3(bdx, bdy, bdz, bdx, bdy, bdz) + 1e-20)
                if geo is not None:
                    geo.update(c=(bdx, bdy, bdz), b_inv=b_inv)
                bdx, bdy, bdz = bdx * b_inv, bdy * b_inv, bdz * b_inv
                dn2 = 2.0 * _dot3(bdx, bdy, bdz, nx, ny, nz)
                if geo is not None:
                    geo.update(b=(bdx, bdy, bdz), dn2=dn2)
                bdx, bdy, bdz = bdx - dn2 * nx, bdy - dn2 * ny, bdz - dn2 * nz
                bdx = bdx + 0.01 * draw(2 + spb * bounce + 2) - 0.005
                bdy = bdy + 0.01 * draw(2 + spb * bounce + 3) - 0.005
                bdz = bdz + 0.01 * draw(2 + spb * bounce + 4) - 0.005
                g_inv = torch.rsqrt(_dot3(bdx, bdy, bdz, bdx, bdy, bdz) + 1e-20)
                if geo is not None:
                    geo.update(q=(bdx, bdy, bdz), g_inv=g_inv)
                bdx, bdy, bdz = bdx * g_inv, bdy * g_inv, bdz * g_inv
            ox = torch.where(hit_now, hx + nx * push, ox)
            oy = torch.where(hit_now, hy + ny * push, oy)
            oz = torch.where(hit_now, hz + nz * push, oz)
            dx = torch.where(hit_now, bdx, dx)
            dy = torch.where(hit_now, bdy, dy)
            dz = torch.where(hit_now, bdz, dz)

        active = active & hit

    return col, fn, fa, f_d, hit0, active


def _f32(x: float) -> float:
    """The float32 rounding of ``x``, as a Python float."""
    return float(np.float32(x))


def _scene_scalars(scene_block: torch.Tensor):
    rows = scene_block.detach().to("cpu", torch.float32).numpy()
    keys = ("rad", "px", "py", "pz", "er", "eg", "eb", "cr", "cg", "cb")
    out = []
    for row in rows:
        s = {k: float(v) for k, v in zip(keys, row)}
        s["rad2"] = float(row[0] * row[0])  # float32 products
        s["py_minus_rad"] = float(row[2] - row[0])
        out.append(s)
    return out


class _Welford:
    def __init__(self, zeros):
        self.n, self.mean, self.m2 = zeros, zeros, zeros

    def add(self, x, include):
        inc = include.to(x.dtype)
        n_new = self.n + inc
        delta = x - self.mean
        step = inc * delta / torch.clamp(n_new, min=1.0)
        self.mean = self.mean + torch.where(n_new > 0.0, step, torch.zeros_like(step))
        self.m2 = self.m2 + inc * delta * (x - self.mean)
        self.n = n_new

    def var(self):
        return torch.where(self.n >= 2.0, self.m2 / torch.clamp(self.n - 1.0, min=1.0),
                           torch.zeros_like(self.m2))


def _luma(x, y, z):
    return LUMA[0] * x + LUMA[1] * y + LUMA[2] * z


class PlainLattice:
    """What the plain versions of the kernels share for one launch: the
    per-sphere scalars, eye and corner rays, the absolute pixel coordinates
    [local_h, W] of the slab and its keys on the lattice, on ``device``
    (default: the blocks')."""

    def __init__(self, scene_block, cam_block, seed: SeedBlock, cfg: RenderConfig,
                 local_h: int, device=None):
        dev = scene_block.device if device is None else torch.device(device)
        self.sc = _scene_scalars(scene_block)
        cam = cam_block.detach().to("cpu", torch.float32).numpy()
        self.eye = [float(x) for x in cam[0]]
        self.basis = [[float(x) for x in b] for b in cam[1:5]]
        seed_v, frame, self.sample_offset, row_offset, col_offset = seed_values(seed)
        rows_i = torch.arange(local_h, device=dev)[:, None] + row_offset
        cols_i = torch.arange(cfg.width, device=dev)[None, :] + col_offset
        rows_i, cols_i = torch.broadcast_tensors(rows_i, cols_i)
        self.rows, self.cols = rows_i.to(torch.float32), cols_i.to(torch.float32)
        self.pix_key = rng.pixel_keys(local_h, cfg.width, row_offset, col_offset, device=dev)
        self.bkey = rng.base_key(seed_v, frame, device=dev)
        self.n_slots = rng.JITTER_SLOTS + cfg.slots_per_bounce * cfg.max_bounces

    def sample(self, s: int, cfg: RenderConfig, tape=None):
        """``_sample_plain`` of the launch's sample ``s`` (sample offset
        added)."""
        s_u = self.sample_offset + s

        def draw(slot):
            return rng.uniform_from_keys(self.pix_key,
                                         rng.draw_key(self.bkey, s_u, slot, self.n_slots))

        return _sample_plain(self.sc, self.eye, self.basis, self.rows, self.cols, draw, cfg,
                             tape)


def trace_plain(scene_block: torch.Tensor, cam_block: torch.Tensor, seed: SeedBlock,
                cfg: RenderConfig, *, local_h: int, spp: int, mode: str,
                device=None) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on ``device`` (default: the
    blocks') -> [local_h, W, C] float32 (C from ``mode``)."""
    lat = PlainLattice(scene_block, cam_block, seed, cfg, local_h, device)
    zeros = torch.zeros_like(lat.rows)
    sums = [zeros] * 10
    w = [_Welford(zeros) for _ in range(4)]
    for s in range(spp):
        col, fn, fa, f_d, hit0, active = lat.sample(s, cfg)
        sums = [a + b for a, b in zip(sums, col + fn + fa + [f_d])]
        if mode == "color":
            continue
        w[0].add(_luma(*col), active)
        w[1].add(_luma(*fn), hit0)
        w[2].add(_luma(*fa), hit0)
        w[3].add(f_d, hit0)

    if mode == "color":
        chans = sums[:3]
    elif mode == "partials":
        chans = sums + [x for m in w for x in (m.n, m.mean, m.m2)]
    else:
        inv_spp = _f32(1.0 / spp)
        chans = [x * inv_spp for x in sums] + [m.var() for m in w]
    return torch.stack(chans, dim=-1)


# -- the kernels' schedule (csrc/trace_kernel.cu; csrc/grad_kernel.cu too) ------

def sample_lanes(spp: int, block: int, pixels: int, sm_count: int,
                 max_lanes: int = MAX_LANES) -> int:
    """L, the sample lanes of a pixel in a launch of K1 (``max_lanes`` 4) or
    K2 (2) over ``pixels`` pixels on a card of ``sm_count`` SMs. One lane
    where a thread a pixel already gives every SM ``FILL_THREADS`` threads
    (a 512x512 frame on an H100: more lanes only add shuffles and, in K2,
    turns), and at 1 spp; else the largest power of two up to ``max_lanes``
    and up to ``spp`` whose block of ``block`` x ``block`` pixels x L threads
    stays within ``MAX_THREADS`` (a 256x256 frame at 4+ spp in the default
    8x8 block: 4 in K1, 2 in K2)."""
    if pixels >= FILL_THREADS * sm_count:
        return 1
    lanes = 1
    while 2 * lanes <= min(spp, max_lanes) and block * block * 2 * lanes <= MAX_THREADS:
        lanes *= 2
    return lanes


def device_sm_count(device) -> int:
    """The SMs of a CUDA ``device`` (cached by torch)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def add_order(spp: int, lanes: int) -> list:
    """The samples of a pixel in the order its sums take them (K1) and its
    accumulators take their sweeps (K2): round r's lanes j = 0..L-1 hold
    samples r L + j, applied lowest lane first; an idle lane of the last
    round adds nothing."""
    return [base + j for base in range(0, spp, lanes) for j in range(lanes) if base + j < spp]


def lane_schedule(width: int, height: int, block: int, spp: int,
                  lanes: int) -> Dict[str, np.ndarray]:
    """Every (pixel, sample) a launch with ``lanes`` sample lanes traces, as
    the kernels assign them: a grid of ceil(W / block) x ceil(h / block)
    blocks of block^2 x L threads, thread t lane t % L of pixel q = t // L at
    (q % block, q // block) in its block, lane j tracing samples j, j + L,
    ... -> arrays ``block_x``, ``block_y``, ``thread``, ``lane``, ``round``,
    ``sample``, ``row``, ``col``, one entry a traced sample."""
    bx, by, t, r = np.meshgrid(np.arange(-(-width // block)), np.arange(-(-height // block)),
                               np.arange(block * block * lanes), np.arange(-(-spp // lanes)),
                               indexing="ij")
    lane, q = t % lanes, t // lanes
    out = dict(block_x=bx, block_y=by, thread=t, lane=lane, round=r, sample=r * lanes + lane,
               row=by * block + q // block, col=bx * block + q % block)
    keep = (out["row"] < height) & (out["col"] < width) & (out["sample"] < spp)
    return {k: v[keep] for k, v in out.items()}


def store_lane(channel: int, lanes: int) -> int:
    """The lane of a pixel that stores its output ``channel``."""
    return channel % lanes


def sphere_table_banks(num_spheres: int, field: int) -> np.ndarray:
    """The shared-memory banks of one field of the rows of the sphere table
    (row i, field f at word 10 i + f): a warp whose lanes hold any sphere
    indices reads that field in one wavefront when these are distinct."""
    return (SPHERE_ROW_WORDS * np.arange(num_spheres) + field) % SHARED_BANKS


# -- the CUDA kernel -----------------------------------------------------------

def launch_device(scene_block, device=None) -> torch.device:
    """The device of a launch: ``device``, or the scene block's; a CUDA
    device with its index."""
    dev = scene_block.device if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


CAM_WORD = SPHERE_ROW_WORDS * MAX_SPHERES  # csrc/common.cuh::kCamWord


def _host_words(block) -> np.ndarray:
    """A host block's 4-byte words as float32 bits: a float32 or int32
    tensor (``check_blocks``), or the seed's five integers."""
    if torch.is_tensor(block):
        return block.detach().numpy().reshape(-1).view(np.float32)
    return np.array([int(x) & 0xFFFFFFFF for x in block], np.uint32).view(np.float32)


def _stage(words: dict, device):
    """Host words {block index: float32 array} -> (one buffer on ``device``,
    {block index: word offset}), written on the host (pinned, for the card)
    and moved by one copy that does not wait for the card. All three blocks
    are laid out as the kernels' constant copy of them (``csrc/common.cuh::
    SceneBlocks``: the scene padded to ``MAX_SPHERES`` rows, the camera, the
    seed), so that a launch copies them in one piece; fewer, one after the
    other."""
    if len(words) == 3:
        starts = {0: 0, 1: CAM_WORD, 2: CAM_WORD + 15}
    else:
        starts, at = {}, 0
        for k, w in words.items():
            starts[k], at = at, at + w.size
    size = max(starts[k] + w.size for k, w in words.items())
    buf = torch.empty(size, dtype=torch.float32, pin_memory=device.type == "cuda")
    host = buf.numpy()
    host[:] = 0.0
    for k, w in words.items():
        host[starts[k]: starts[k] + w.size] = w
    return buf.to(device, non_blocking=True), starts


def launch_operands(scene_block, cam_block, seed: SeedBlock, device: torch.device):
    """The device addresses of a CUDA launch's scene [N, 10] and camera [5, 3]
    float32 and seed int32 [5] blocks -> (what keeps staged blocks alive
    until the launch is queued, scene, camera, seed address). A block on
    ``device`` is passed as it is; blocks on the host, and a seed given as
    its five integers, are staged by one copy (``_stage``); a block on
    another device raises ValueError."""
    blocks = [scene_block, cam_block, seed]
    for name, t in zip(("scene", "camera", "seed"), blocks):
        if torch.is_tensor(t) and t.device != device and t.device.type != "cpu":
            raise ValueError(f"{name} block is on {t.device}, the launch on {device}")
    words = {k: _host_words(t) for k, t in enumerate(blocks)
             if not torch.is_tensor(t) or t.device.type == "cpu"}
    if not words:
        return None, scene_block.data_ptr(), cam_block.data_ptr(), seed.data_ptr()
    staged, starts = _stage(words, device)
    addr = [staged.data_ptr() + 4 * starts[k] if k in starts else t.data_ptr()
            for k, t in enumerate(blocks)]
    return staged, *addr


def stage_blocks(blocks, device) -> tuple:
    """``blocks`` (scene [N, 10] and camera [5, 3] float32, and seed int32 [5],
    in that order; the seed may be left out) as tensors on ``device``: those
    on the host staged by one copy (``_stage``) and cut into views, the
    others moved without a wait for the card."""
    device = torch.device(device)
    blocks = list(blocks)
    words = {k: _host_words(t) for k, t in enumerate(blocks) if t.device.type == "cpu"}
    if words and device.type != "cpu":
        staged, starts = _stage(words, device)
        for k in words:
            t = blocks[k]
            part = staged[starts[k]: starts[k] + t.numel()]
            blocks[k] = (part if t.dtype == torch.float32 else part.view(t.dtype)).view(t.shape)
    return tuple(to_device(t, device) for t in blocks)


class CudaTraceKernel:
    """ctypes binding of ``pt_trace_launch_padded``. ``launches`` counts the
    kernel launches made through ``launch``. ``lanes`` of ``launch`` and
    ``occupancy`` defaults to ``sample_lanes`` for the launch and the card;
    only measurements pass another."""

    def __init__(self):
        self._lib = None  # keeps the library loaded while _fn is in use
        self._fn = None
        self.launches = 0

    def _function(self):
        if self._fn is None:
            self._lib, self._fn = load_function(SOURCE, "pt_trace_launch_padded", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ])
        return self._fn

    def occupancy(self, mode: str, cfg: RenderConfig, pad_shared: int = 0,
                  lanes: int | None = None) -> dict:
        """What the card gives a launch of ``mode`` under ``cfg`` (BRDF, NEE,
        block edge, spp) that asks for ``pad_shared`` dynamic shared bytes
        beyond its own: resident blocks an SM, registers a thread, dynamic
        shared bytes a block, local bytes a thread."""
        self._function()
        if lanes is None:
            lanes = sample_lanes(cfg.spp, cfg.block, cfg.width * cfg.height,
                                 device_sm_count(torch.cuda.current_device()))
        out = (ctypes.c_int * 4)()
        err = self._lib.pt_trace_occupancy(MODES[mode], int(cfg.brdf == "glossy"),
                                           int(cfg.nee), cfg.block, lanes, pad_shared, out)
        if err != 0:
            raise RuntimeError(f"trace kernel occupancy query failed: cudaError {err}")
        return dict(zip(("blocks_per_sm", "registers", "shared_bytes", "local_bytes"), out))

    def launch(self, scene_block, cam_block, seed: SeedBlock, cfg: RenderConfig, *,
               local_h: int, spp: int, mode: str, device: torch.device,
               pad_shared: int = 0, lanes: int | None = None) -> torch.Tensor:
        """Launch on the current stream of ``device`` -> [local_h, W, C]
        float32 (asynchronous, like any CUDA op). ``pad_shared``: dynamic
        shared bytes to ask for beyond the block's own, so that fewer blocks
        fit an SM; only the occupancy curve of ``scripts/
        torch_kernel_occupancy.py`` passes it."""
        t0 = timing.launch_clock()
        fn = self._function()
        held, scene_at, cam_at, seed_at = launch_operands(scene_block, cam_block, seed, device)
        n_ch = MODES[mode]
        if lanes is None:
            lanes = sample_lanes(spp, cfg.block, local_h * cfg.width, device_sm_count(device))
        out = torch.empty((local_h, cfg.width, n_ch), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(
                scene_at, scene_block.shape[0], cam_at, seed_at, local_h,
                cfg.width, _f32(1.0 / cfg.width),
                _f32(1.0 / cfg.height), spp, _f32(1.0 / spp), cfg.max_bounces,
                int(cfg.resolved_jitter), cfg.push_ray_origin,
                cfg.light_index if cfg.nee else -1, int(cfg.brdf == "glossy"),
                n_ch, cfg.block, lanes, out.data_ptr(), stream, pad_shared,
            )
        if err != 0:
            raise RuntimeError(f"trace kernel launch failed: cudaError {err}")
        self.launches += 1
        timing.add_launch_ns("k1", t0)
        return out


CUDA_KERNEL = CudaTraceKernel()
timing.launch_counter("k1", lambda: CUDA_KERNEL.launches)


def check_blocks(scene_block, cam_block, seed, cfg: RenderConfig, local_h, spp):
    """Raise ValueError on blocks, seed or sizes that no kernel takes."""
    for name, t, cols in (("scene", scene_block, 10), ("camera", cam_block, 3)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != cols:
            raise ValueError(f"{name} block must be float32 [*, {cols}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} block must be contiguous")
    n = scene_block.shape[0]
    if not 1 <= n <= MAX_SPHERES:
        raise ValueError(f"scene must have 1..{MAX_SPHERES} spheres, got {n}")
    if cam_block.shape[0] != 5:
        raise ValueError(f"camera block must be [5, 3], got {tuple(cam_block.shape)}")
    if cam_block.device != scene_block.device:
        raise ValueError("scene and camera blocks must be on one device")
    if torch.is_tensor(seed):
        if seed.dtype != torch.int32 or tuple(seed.shape) != (5,) or not seed.is_contiguous():
            raise ValueError(f"seed block must be a contiguous int32 [5], got {seed.dtype} "
                             f"{tuple(seed.shape)}")
        if seed.device not in (scene_block.device, torch.device("cpu")):
            raise ValueError(f"seed block is on {seed.device}, the scene block on "
                             f"{scene_block.device}")
    elif len(seed) != 5:
        raise ValueError(f"seed block must hold 5 integers, got {len(seed)}")
    if local_h < 1 or cfg.width < 1 or spp < 1 or cfg.max_bounces < 0:
        raise ValueError("local_h, width and spp must be >= 1, max_bounces >= 0")
    if cfg.nee and not 0 <= cfg.light_index < n:
        raise ValueError(f"light_index {cfg.light_index} out of range for {n} spheres")
    if not 1 <= cfg.block <= MAX_BLOCK:
        raise ValueError(f"block edge must be 1..{MAX_BLOCK}, got {cfg.block}")


def trace(scene_block: torch.Tensor, cam_block: torch.Tensor, seed: SeedBlock,
          cfg: RenderConfig, *, local_h: int, spp: int, mode: str,
          device=None) -> torch.Tensor:
    """The kernel wrapper -> [local_h, W, C] float32 on ``device`` (default:
    the blocks' device). CPU: the plain version. CUDA: the kernel, or an
    exception."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    check_blocks(scene_block, cam_block, seed, cfg, local_h, spp)
    dev = launch_device(scene_block, device)
    if dev.type == "cpu":
        return trace_plain(scene_block, cam_block, seed, cfg, local_h=local_h, spp=spp,
                           mode=mode, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"no trace kernel for device {dev}")
    return CUDA_KERNEL.launch(scene_block, cam_block, seed, cfg, local_h=local_h,
                              spp=spp, mode=mode, device=dev)


# -- agreement of two outputs ---------------------------------------------------
# The kernel against its plain version: every channel of every mode. A
# borderline hit decision may round the other way and send one sample down
# another path, so each channel group may be off on a small share of pixels;
# albedo changes only when the first hit flips. Raw sums (partials, color)
# are scaled to means for the colour and normal tolerances.
COLOR_ATOL = 1e-3  # colour; statistics: 1e-3 * max(1, max |reference|)
NORMAL_ATOL = 2e-6
DEPTH_RTOL = 5e-4
MAX_OFF_SHARE = 0.01  # colour, normal, depth and each statistics channel
MAX_ALBEDO_OFF_SHARE = 0.001  # albedo must be bit-equal elsewhere


def agreement(got: torch.Tensor, ref: torch.Tensor, mode: str, spp: int):
    """Hold ``got`` against ``ref``, two [h, W, C] outputs of ``mode`` ->
    (checks, max |got - ref| over all channels). Each check is (name, share
    of pixels out of tolerance, ceiling, ok)."""
    got = got.detach().to("cpu", torch.float64).numpy()
    ref = ref.detach().to("cpu", torch.float64).numpy()
    if got.shape != ref.shape or got.shape[-1] != MODES[mode]:
        raise ValueError(f"shapes {got.shape} and {ref.shape} do not fit mode {mode!r}")
    diff = np.abs(got - ref)
    scale = 1.0 if mode == "channels" else 1.0 / spp
    finite = np.isfinite(got).all(axis=-1) & np.isfinite(ref).all(axis=-1)
    checks = [
        ("finite", ~finite, 0.0),
        ("colour", diff[..., 0:3].max(axis=-1) * scale > COLOR_ATOL, MAX_OFF_SHARE),
    ]
    if mode != "color":
        checks += [
            ("normal", diff[..., 3:6].max(axis=-1) * scale > NORMAL_ATOL, MAX_OFF_SHARE),
            ("albedo", diff[..., 6:9].max(axis=-1) > 0.0, MAX_ALBEDO_OFF_SHARE),
            ("depth", diff[..., 9] > DEPTH_RTOL * np.abs(ref[..., 9]), MAX_OFF_SHARE),
        ]
        for k, name in enumerate(STAT_CHANNELS[mode], start=10):
            tol = COLOR_ATOL * max(1.0, float(np.abs(ref[..., k]).max()))
            checks.append((name, diff[..., k] > tol, MAX_OFF_SHARE))
    out = []
    for name, off, ceiling in checks:
        share = float(off.mean())
        out.append((name, share, ceiling, share <= ceiling))
    return out, float(diff.max())


# -- entry points (the JAX package's signatures, plus a device) ---------------

def device_blocks(scene, cam, cfg, device):
    """(scene block, camera block, device) of a launch on ``device`` (None: the
    current CUDA device, ``render.resolve_device``). The blocks are built
    where the scene and camera live (the camera's basis in its own
    arithmetic, so a host camera gives the same bits as ever). For a CUDA
    launch, host blocks stay on the host when both are there: the launch
    stages them with its seed block in one copy; else both go to the card
    without a wait for it. Nothing is read back from the card."""
    device = resolve_device(device)
    sb, cb = scene.packed(), camera_block(cam, cfg)
    if device.type == "cpu":
        return sb.to(device), cb.to(device), device
    if sb.device.type == cb.device.type == "cpu":
        return sb, cb, device
    sb, cb = stage_blocks((sb, cb), device)
    return sb, cb, device


def render_channels(scene, cam, cfg: RenderConfig, frame=0, device=None) -> torch.Tensor:
    """Render via the kernel -> packed [H, W, 14] buffer."""
    sb, cb, device = device_blocks(scene, cam, cfg, device)
    return trace(sb, cb, make_seed_block(cfg, frame), cfg, local_h=cfg.height, spp=cfg.spp,
                 mode="channels", device=device)


def render_aovs(scene, cam, cfg: RenderConfig, frame=0, device=None) -> Dict[str, torch.Tensor]:
    return unpack_channels(render_channels(scene, cam, cfg, frame, device))


def render_color_sums(scene, cam, cfg: RenderConfig, frame, row_offset=0, local_h=None,
                      spp=None, sample_offset=0, device=None) -> torch.Tensor:
    """RAW colour sums [local_h, W, 3] over samples [sample_offset,
    sample_offset + spp) of rows [row_offset, row_offset + local_h)."""
    sb, cb, device = device_blocks(scene, cam, cfg, device)
    return trace(sb, cb, make_seed_block(cfg, frame, sample_offset, row_offset), cfg,
                 local_h=cfg.height if local_h is None else local_h,
                 spp=cfg.spp if spp is None else spp, mode="color", device=device)


def partials_from_block(out: torch.Tensor):
    """[..., 22] partials -> (sums, moments) dicts, the contract of
    ``render.accumulate_frame``."""
    sums = {
        "color": out[..., 0:3],
        "normal": out[..., 3:6],
        "albedo": out[..., 6:9],
        "depth": out[..., 9],
    }
    moments = {
        k: Moments(out[..., 10 + 3 * i], out[..., 11 + 3 * i], out[..., 12 + 3 * i])
        for i, k in enumerate(FEATURES)
    }
    return sums, moments


def accumulate_frame_kernel(scene, cam, cfg: RenderConfig, frame, row_offset=0,
                            local_h=None, spp=None, sample_offset=0, device=None):
    """Kernel slab pass -> (sums, moments) partials: rows [row_offset,
    row_offset + local_h), samples [sample_offset, sample_offset + spp)."""
    sb, cb, device = device_blocks(scene, cam, cfg, device)
    out = trace(sb, cb, make_seed_block(cfg, frame, sample_offset, row_offset), cfg,
                local_h=cfg.height if local_h is None else local_h,
                spp=cfg.spp if spp is None else spp, mode="partials", device=device)
    return partials_from_block(out)


def render_partials(scene, cam, cfg: RenderConfig, frame=0, sample_offset=0, device=None):
    """Full-frame (sums, moments) partials over samples [sample_offset,
    sample_offset + cfg.spp)."""
    return accumulate_frame_kernel(scene, cam, cfg, frame, sample_offset=sample_offset,
                                   device=device)
