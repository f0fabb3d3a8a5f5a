"""The plain path tracer, frozen, and the frame buffers it makes.

``sample_paths`` is a frozen copy of the trajectory of
``pathtrace_tpu_torch/ops/trace_kernel.py::_sample_plain`` (the kernels'
plain version; the reference's ``pathtrace.cu:78-236``), diffuse with or
without next-event estimation, written over tensors of any shape with a
leading sample axis. The spheres are tensors, so autograd runs through it
with every discrete decision fixed by the forward: which sphere a ray hits,
the normal's flip, the shadow test, the escape and every random draw.

``frame_buffer`` sums the samples in double and merges the luminance
moments with Chan's formula, so it does not depend on the order in which
the program adds them; ``color_mean`` is the differentiable colour.
``dtype`` runs the whole path in another precision (the control).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import lattice

T_BIG = 1.0e6
TWO_PI = 6.283185307179586
LUMA = (0.2126, 0.7152, 0.0722)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _f32(x: float) -> float:
    return float(np.float32(x))


def _sqrt_pos(det, zeros):
    """sqrt(det) where det > 0, else 0: the kernels' values, with a gradient
    that stays finite (0, not 0 x inf) where the ray misses."""
    pos = det > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, det, 1.0)), zeros)


class Frame:
    """One launch's fixed inputs: the spheres (dict of [N] and [N, 3]
    tensors: rad, pos, emis, alb), the eye [3] and corner rays [4, 3] as
    Python floats (f32 values), the image size, the rows drawn, and the
    lattice position (seed, frame)."""

    def __init__(self, spheres, eye, corners, width, height, seed, frame, rows,
                 max_bounces=5, push=0.05, light=None, device="cpu", dtype=torch.float32):
        self.sp = {k: v.to(device, dtype) for k, v in spheres.items()}
        self.eye = [float(x) for x in torch.as_tensor(eye, dtype=torch.float32)]
        self.corners = [[float(x) for x in c] for c in torch.as_tensor(corners, dtype=torch.float32)]
        self.width, self.height = width, height
        self.max_bounces, self.push, self.light = max_bounces, push, light
        self.dtype, self.device = dtype, torch.device(device)
        rows_i = torch.as_tensor(rows, dtype=torch.int64, device=device)[:, None]
        cols_i = torch.arange(width, dtype=torch.int64, device=device)[None, :]
        rows_i, cols_i = torch.broadcast_tensors(rows_i, cols_i)
        self.rows, self.cols = rows_i.to(dtype), cols_i.to(dtype)
        self.pix = lattice.pixel_keys(rows_i, cols_i)
        self.bkey = lattice.base_key(seed, frame, device)
        self.n_slots = lattice.n_slots(max_bounces)

    def paths(self, first: int, count: int, jitter: bool = True, hits=None):
        """Samples [first, first + count): (col, normal, albedo, depth, hit0,
        active), each [count, h, W] (lists of 3 for the vectors). A list
        given as ``hits`` receives each bounce's mask of live paths that
        hit."""
        samples = torch.arange(first, first + count, dtype=torch.int64,
                               device=self.device)[:, None, None]

        def draw(slot):
            return lattice.uniforms(self.bkey, self.pix, samples, slot,
                                    self.n_slots).to(self.dtype)

        return sample_paths(self, draw, count, jitter, hits)


def sample_paths(fr: Frame, draw, count: int, jitter: bool, hits=None):
    sp = fr.sp
    n = sp["rad"].shape[0]
    shape = (count,) + tuple(fr.rows.shape)
    zeros = torch.zeros(shape, dtype=fr.dtype, device=fr.device)
    rows, cols = fr.rows + zeros, fr.cols + zeros
    push = fr.push
    spheres = []
    for i in range(n):
        rad, p = sp["rad"][i], sp["pos"][i]
        spheres.append(dict(rad=rad, rad2=rad * rad, px=p[0], py=p[1], pz=p[2],
                            py_minus_rad=p[1] - rad,
                            er=sp["emis"][i, 0], eg=sp["emis"][i, 1], eb=sp["emis"][i, 2],
                            cr=sp["alb"][i, 0], cg=sp["alb"][i, 1], cb=sp["alb"][i, 2]))
    basis = fr.corners

    def bilerp(axis, u, v):
        b00, b10, b01, b11 = (b[axis] for b in basis)
        return (b00 * (1.0 - u) + b10 * u) * (1.0 - v) + (b01 * (1.0 - u) + b11 * u) * v

    if jitter:
        r, c = rows + (draw(0) - 0.5), cols + (draw(1) - 0.5)
    else:
        r, c = rows, cols
    ndc_x = 2.0 * c * _f32(1.0 / fr.width) - 1.0
    ndc_y = 1.0 - 2.0 * r * _f32(1.0 / fr.height)
    u, v = (ndc_x + 1.0) * 0.5, (ndc_y + 1.0) * 0.5
    dx, dy, dz = bilerp(0, u, v), bilerp(1, u, v), bilerp(2, u, v)
    ox, oy, oz = zeros + fr.eye[0], zeros + fr.eye[1], zeros + fr.eye[2]

    col = [zeros, zeros, zeros]
    mask = [zeros + 1.0, zeros + 1.0, zeros + 1.0]
    active = torch.ones(shape, dtype=torch.bool, device=fr.device)
    fn, fa, f_d, hit0 = [zeros] * 3, [zeros] * 3, zeros, torch.zeros_like(active)

    for bounce in range(fr.max_bounces):
        if bounce == 0:
            inv_len = torch.rsqrt(_dot3(dx, dy, dz, dx, dy, dz))
            dnx, dny, dnz = dx * inv_len, dy * inv_len, dz * inv_len
        else:
            inv_len = None
            dnx, dny, dnz = dx, dy, dz
        t_best = torch.full_like(zeros, T_BIG)
        hit = torch.zeros_like(active)
        s_p, s_e, s_c = [zeros] * 3, [zeros] * 3, [zeros] * 3
        for s in spheres:
            rel_x, rel_y, rel_z = s["px"] - ox, s["py"] - oy, s["pz"] - oz
            tca = _dot3(rel_x, rel_y, rel_z, dnx, dny, dnz)
            qx, qy, qz = rel_x - tca * dnx, rel_y - tca * dny, rel_z - tca * dnz
            det = s["rad2"] - _dot3(qx, qy, qz, qx, qy, qz)
            thc = _sqrt_pos(det, zeros)
            if inv_len is None:
                t_near, t_far = tca - thc, tca + thc
            else:
                t_near, t_far = (tca - thc) * inv_len, (tca + thc) * inv_len
            t = torch.where(t_near > 0.0, t_near, t_far)
            closer = (det >= 0.0) & (t > 0.0) & (t < T_BIG) & (t < t_best)
            t_best = torch.where(closer, t, t_best)
            hit = hit | closer
            s_p = [torch.where(closer, s[k], x) for k, x in zip(("px", "py", "pz"), s_p)]
            s_e = [torch.where(closer, s[k], x) for k, x in zip(("er", "eg", "eb"), s_e)]
            s_c = [torch.where(closer, s[k], x) for k, x in zip(("cr", "cg", "cb"), s_c)]

        hit_now = active & hit
        if hits is not None:
            hits.append(hit_now)
        hx, hy, hz = ox + dx * t_best, oy + dy * t_best, oz + dz * t_best
        nx, ny, nz = hx - s_p[0], hy - s_p[1], hz - s_p[2]
        n_inv = torch.rsqrt(_dot3(nx, ny, nz, nx, ny, nz) + 1e-20)
        nx, ny, nz = nx * n_inv, ny * n_inv, nz * n_inv
        flip = torch.where(_dot3(nx, ny, nz, dx, dy, dz) < 0.0, 1.0, -1.0).detach()
        nx, ny, nz = nx * flip, ny * flip, nz * flip

        e = [m * se for m, se in zip(mask, s_e)]
        if bounce == 0:
            e = [torch.clamp(x, 0.0, 1.0) for x in e]
        if fr.light is not None:
            lt = spheres[fr.light]
            lb_x, lb_y, lb_z = lt["px"], lt["py_minus_rad"], lt["pz"]
            sox, soy, soz = hx + nx * push, hy + ny * push, hz + nz * push
            lvx, lvy, lvz = lb_x - hx, lb_y - hy, lb_z - hz
            l_inv = torch.rsqrt(_dot3(lvx, lvy, lvz, lvx, lvy, lvz) + 1e-20)
            ldx, ldy, ldz = lvx * l_inv, lvy * l_inv, lvz * l_inv
            svx, svy, svz = lb_x - sox, lb_y - soy, lb_z - soz
            t_light = torch.sqrt(_dot3(svx, svy, svz, svx, svy, svz))
            diffuse = torch.clamp(_dot3(ldx, ldy, ldz, nx, ny, nz), 0.0, 1.0)
            vis = torch.ones_like(active)
            for i, s in enumerate(spheres):
                if i == fr.light:
                    continue
                rel_x, rel_y, rel_z = s["px"] - sox, s["py"] - soy, s["pz"] - soz
                tca = _dot3(rel_x, rel_y, rel_z, ldx, ldy, ldz)
                qx, qy, qz = rel_x - tca * ldx, rel_y - tca * ldy, rel_z - tca * ldz
                det = s["rad2"] - _dot3(qx, qy, qz, qx, qy, qz)
                thc = _sqrt_pos(det, zeros)
                t_near, t_far = tca - thc, tca + thc
                t = torch.where(t_near > 0.0, t_near, t_far)
                vis = vis & ~((det >= 0.0) & (t > 0.0) & (t < t_light))
            dl = diffuse * torch.where(vis, 1.0, 0.0) * 0.5
            e = [x + m * dl * lt[k] * sc_ for x, m, k, sc_ in
                 zip(e, mask, ("er", "eg", "eb"), s_c)]
        col = [cc + torch.where(hit_now, x, zeros) for cc, x in zip(col, e)]
        mask = [torch.where(hit_now, m * c_, m) for m, c_ in zip(mask, s_c)]

        if bounce == 0:
            fn = [torch.where(hit_now, x, zeros) for x in (nx, ny, nz)]
            fa = [torch.where(hit_now, x, zeros) for x in s_c]
            f_d = torch.where(hit_now, t_best, zeros)
            hit0 = hit_now

        if bounce + 1 < fr.max_bounces:
            u1 = draw(2 + lattice.SLOTS_PER_BOUNCE * bounce)
            u2 = draw(2 + lattice.SLOTS_PER_BOUNCE * bounce + 1)
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
            bdx = cs * o1x + ss * o2x + zc * nx
            bdy = cs * o1y + ss * o2y + zc * ny
            bdz = cs * o1z + ss * o2z + zc * nz
            ox = torch.where(hit_now, hx + nx * push, ox)
            oy = torch.where(hit_now, hy + ny * push, oy)
            oz = torch.where(hit_now, hz + nz * push, oz)
            dx = torch.where(hit_now, bdx, dx)
            dy = torch.where(hit_now, bdy, dy)
            dz = torch.where(hit_now, bdz, dz)
        active = active & hit

    return col, fn, fa, f_d, hit0, active


def _luma(v):
    return LUMA[0] * v[0] + LUMA[1] * v[1] + LUMA[2] * v[2]


def _moments(x, include):
    """(n, mean, m2) in double of the included samples along axis 0."""
    inc = include.double()
    x = x.double()
    n = inc.sum(0)
    mean = (x * inc).sum(0) / torch.clamp(n, min=1.0)
    m2 = (((x - mean) * inc) ** 2).sum(0)
    return n, mean, m2


def _merge(a, b):
    n = a[0] + b[0]
    safe = torch.clamp(n, min=1.0)
    delta = b[1] - a[1]
    return n, a[1] + delta * (b[0] / safe), a[2] + b[2] + delta * delta * (a[0] * b[0] / safe)


def frame_buffer(fr: Frame, spp: int, chunk: int = 64, jitter=None) -> torch.Tensor:
    """The 14-channel buffer of ``spp`` samples -> [h, W, 14] f32: the ten
    means, then the luminance variances (M2 / (n - 1), 0 where n < 2) of
    colour over paths that never escaped and of normal, albedo and depth
    over first hits. Sums and moments in double."""
    jitter = spp != 1 if jitter is None else jitter
    with torch.no_grad():
        sums, moments = None, None
        for first in range(0, spp, chunk):
            count = min(chunk, spp - first)
            col, fn, fa, f_d, hit0, active = fr.paths(first, count, jitter)
            s = torch.stack([x.double().sum(0) for x in col + fn + fa + [f_d]], dim=-1)
            m = [_moments(_luma(col), active), _moments(_luma(fn), hit0),
                 _moments(_luma(fa), hit0), _moments(f_d, hit0)]
            if sums is None:
                sums, moments = s, m
            else:
                sums = sums + s
                moments = [_merge(a, b) for a, b in zip(moments, m)]
        var = [torch.where(n >= 2.0, m2 / torch.clamp(n - 1.0, min=1.0), torch.zeros_like(m2))
               for n, _, m2 in moments]
        return torch.cat([sums / spp, torch.stack(var, dim=-1)], dim=-1).float()


def color_mean(fr: Frame, spp: int, chunk: int = 16) -> torch.Tensor:
    """The mean colour [h, W, 3] of ``spp`` samples, differentiable in the
    spheres."""
    total = None
    for first in range(0, spp, chunk):
        col = fr.paths(first, min(chunk, spp - first), spp != 1)[0]
        s = torch.stack([x.sum(0) for x in col], dim=-1)
        total = s if total is None else total + s
    return total / spp
