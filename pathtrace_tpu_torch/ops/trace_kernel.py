"""The forward path-trace kernel and its plain PyTorch version.

``csrc/trace_kernel.cu`` replaces ``pathtrace_tpu/ops/pallas_trace.py::
_pathtrace_kernel``: one CUDA thread per pixel loops over its samples and
bounces and writes one channels-last vector, in one of three modes:

- ``"channels"``: 14 finished channels (means + variances);
- ``"partials"``: 22 mergeable channels, 10 raw sums + Welford
  (n, mean, M2) of the colour/normal/albedo/depth luminances;
- ``"color"``: 3 raw colour sums.

``trace`` is the wrapper. On the CPU it runs ``trace_plain``, a direct
transcription of ``trace_tile_sample`` + ``sample_body`` over [h, W]
tensors; on a CUDA device it launches the kernel, or raises. It never falls
back from one to the other. The scene and camera blocks are the kernel's
by-value parameters: the entry points build them on the host, so a launch
reads nothing back from the device.

``agreement`` holds two outputs of one mode against each other, channel by
channel, under the tolerances stated with it.

The kernel is built with nvcc at first use into ``pathtrace_tpu_torch/
build/`` (``ops/build.py``: rebuilt when the source, a header it includes or
the flags change) and bound with ctypes. Both versions draw the lattice of ``rng.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from pathtrace_tpu_torch import rng
from pathtrace_tpu_torch.config import MAX_BLOCK, RenderConfig
from pathtrace_tpu_torch.ops.build import CSRC, load_function
from pathtrace_tpu_torch.ops.variance import LUMA, Moments
from pathtrace_tpu_torch.render import FEATURES, unpack_channels

T_BIG = 1.0e6
TWO_PI = 6.283185307179586
MAX_SPHERES = 16
MODES = {"channels": 14, "partials": 22, "color": 3}
# Names of the statistics channels 10.. of each mode.
STAT_CHANNELS = {
    "channels": tuple(f"{k}_var" for k in FEATURES),
    "partials": tuple(f"{k}_{s}" for k in FEATURES for s in ("n", "mean", "m2")),
    "color": (),
}

SOURCE = CSRC / "trace_kernel.cu"

SeedBlock = Tuple[int, int, int, int, int]


def make_seed_block(cfg: RenderConfig, frame=0, sample_offset=0, row_offset=0,
                    col_offset=0) -> SeedBlock:
    """(seed, frame, sample offset, row offset, col offset): the absolute
    lattice position of a launch. The offsets are the sharding hook."""
    return (cfg.seed & 0x7FFFFFFF, int(frame), int(sample_offset), int(row_offset),
            int(col_offset))


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
        seed_v, frame, self.sample_offset, row_offset, col_offset = seed
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


# -- the CUDA kernel -----------------------------------------------------------

def host_arrays(scene_block, cam_block, seed: SeedBlock):
    """A launch's by-value inputs as contiguous host arrays: scene [N, 10] and
    camera [5, 3] float32, seed [5] uint32. The kernels copy them into their
    parameter struct: host blocks cost no device round trip, device blocks
    are read back first."""
    return (np.ascontiguousarray(scene_block.detach().cpu().numpy(), np.float32),
            np.ascontiguousarray(cam_block.detach().cpu().numpy(), np.float32),
            np.array([x & 0xFFFFFFFF for x in seed], np.uint32))


class CudaTraceKernel:
    """ctypes binding of ``pt_trace_launch``. ``launches`` counts the
    kernel launches made through ``launch``."""

    def __init__(self):
        self._lib = None  # keeps the library loaded while _fn is in use
        self._fn = None
        self.launches = 0

    def _function(self):
        if self._fn is None:
            self._lib, self._fn = load_function(SOURCE, "pt_trace_launch", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ])
        return self._fn

    def launch(self, scene_block, cam_block, seed: SeedBlock, cfg: RenderConfig, *,
               local_h: int, spp: int, mode: str, device: torch.device) -> torch.Tensor:
        """Launch on the current stream of ``device`` -> [local_h, W, C]
        float32 (asynchronous, like any CUDA op)."""
        fn = self._function()
        scene_np, cam_np, seed_np = host_arrays(scene_block, cam_block, seed)
        n_ch = MODES[mode]
        out = torch.empty((local_h, cfg.width, n_ch), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(
                scene_np.ctypes.data, scene_np.shape[0], cam_np.ctypes.data,
                seed_np.ctypes.data, local_h, cfg.width, _f32(1.0 / cfg.width),
                _f32(1.0 / cfg.height), spp, _f32(1.0 / spp), cfg.max_bounces,
                int(cfg.resolved_jitter), cfg.push_ray_origin,
                cfg.light_index if cfg.nee else -1, int(cfg.brdf == "glossy"),
                n_ch, cfg.block, out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"trace kernel launch failed: cudaError {err}")
        self.launches += 1
        return out


CUDA_KERNEL = CudaTraceKernel()


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
    if len(seed) != 5:
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
    dev = scene_block.device if device is None else torch.device(device)
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

def host_blocks(scene, cam, cfg, device):
    """(scene block, camera block, device): the blocks are built on the host,
    since the kernel takes them by value."""
    device = scene.device if device is None else torch.device(device)
    cpu = torch.device("cpu")
    return scene.to(cpu).packed(), camera_block(cam.to(cpu), cfg), device


def render_channels(scene, cam, cfg: RenderConfig, frame=0, device=None) -> torch.Tensor:
    """Render via the kernel -> packed [H, W, 14] buffer."""
    sb, cb, device = host_blocks(scene, cam, cfg, device)
    return trace(sb, cb, make_seed_block(cfg, frame), cfg, local_h=cfg.height,
                 spp=cfg.spp, mode="channels", device=device)


def render_aovs(scene, cam, cfg: RenderConfig, frame=0, device=None) -> Dict[str, torch.Tensor]:
    return unpack_channels(render_channels(scene, cam, cfg, frame, device))


def render_color_sums(scene, cam, cfg: RenderConfig, frame, row_offset=0, local_h=None,
                      spp=None, sample_offset=0, device=None) -> torch.Tensor:
    """RAW colour sums [local_h, W, 3] over samples [sample_offset,
    sample_offset + spp) of rows [row_offset, row_offset + local_h)."""
    sb, cb, device = host_blocks(scene, cam, cfg, device)
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
    sb, cb, device = host_blocks(scene, cam, cfg, device)
    out = trace(sb, cb, make_seed_block(cfg, frame, sample_offset, row_offset), cfg,
                local_h=cfg.height if local_h is None else local_h,
                spp=cfg.spp if spp is None else spp, mode="partials", device=device)
    return partials_from_block(out)


def render_partials(scene, cam, cfg: RenderConfig, frame=0, sample_offset=0, device=None):
    """Full-frame (sums, moments) partials over samples [sample_offset,
    sample_offset + cfg.spp)."""
    return accumulate_frame_kernel(scene, cam, cfg, frame, sample_offset=sample_offset,
                                   device=device)
