"""The plain glossy path tracer, frozen, with or without next-event estimation.

``sample_paths`` is a frozen copy of the trajectory of
``pathtrace_tpu_torch/ops/trace_kernel.py::_sample_plain`` under
``brdf="glossy"`` (the reference's "makeshift glossy BRDF",
``pathtrace.cu:181-184``, with its direct lighting, ``:138-148``): at each
hit the NEE term toward the light's bottom point, then five draws a
bounce, a cosine-weighted direction about the normal, mirrored about it,
moved by ``0.01 * u - 0.005`` on each axis and normalised. It is written as
``reference/tracer.py``'s diffuse copy is, over tensors with a leading sample
axis, with every discrete decision fixed by the forward (which sphere a ray
hits, the normal's flip, the shadow test, the ortho vector's branch, every
random draw), so autograd runs through it; ``tracer.frame_buffer`` and
``tracer.color_mean`` take a ``Frame`` of this module as they take their own.

Plain f32 torch: nothing of the program, no JAX, no matrix product (so no
TF32; ``drivers/inverse_glossy.py`` runs it under ``fpn.precision(False)``, TF32 off, all the
same).
"""

from __future__ import annotations

import torch

from benchmark.reference import lattice, tracer
from benchmark.reference.tracer import T_BIG, TWO_PI, _dot3, _f32, _sqrt_pos

SLOTS_PER_BOUNCE = 5  # two for the cosine direction, three for the jitter


class Frame(tracer.Frame):
    """``tracer.Frame`` on the glossy trajectory: five draw slots a bounce."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_slots = lattice.JITTER_SLOTS + SLOTS_PER_BOUNCE * self.max_bounces

    def paths(self, first: int, count: int, jitter: bool = True, hits=None):
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
            slot = 2 + SLOTS_PER_BOUNCE * bounce
            u1, u2 = draw(slot), draw(slot + 1)
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
            # the glossy lobe: normalise, mirror about the normal, jitter, normalise
            b_inv = torch.rsqrt(_dot3(bdx, bdy, bdz, bdx, bdy, bdz) + 1e-20)
            bdx, bdy, bdz = bdx * b_inv, bdy * b_inv, bdz * b_inv
            dn2 = 2.0 * _dot3(bdx, bdy, bdz, nx, ny, nz)
            bdx, bdy, bdz = bdx - dn2 * nx, bdy - dn2 * ny, bdz - dn2 * nz
            bdx = bdx + 0.01 * draw(slot + 2) - 0.005
            bdy = bdy + 0.01 * draw(slot + 3) - 0.005
            bdz = bdz + 0.01 * draw(slot + 4) - 0.005
            g_inv = torch.rsqrt(_dot3(bdx, bdy, bdz, bdx, bdy, bdz) + 1e-20)
            bdx, bdy, bdz = bdx * g_inv, bdy * g_inv, bdz * g_inv
            ox = torch.where(hit_now, hx + nx * push, ox)
            oy = torch.where(hit_now, hy + ny * push, oy)
            oz = torch.where(hit_now, hz + nz * push, oz)
            dx = torch.where(hit_now, bdx, dx)
            dy = torch.where(hit_now, bdy, dy)
            dz = torch.where(hit_now, bdz, dz)
        active = active & hit

    return col, fn, fa, f_d, hit0, active
