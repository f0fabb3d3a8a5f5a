"""The wavefront bounce pipeline: the ``"torch"`` backend.

The counterpart of ``pathtrace_tpu.ops.trace`` (reference ``trace_ray``,
``pathtrace.cu:150-201``): every ray of the batch steps through the
unrolled bounce loop together, and escape becomes an ``active`` mask. It
runs on any device and is differentiable with autograd (sphere choices
are masks, so they carry no gradient).

Behaviour (SURVEY.md §2.5):
- an escaped sample keeps its colour and still counts in the colour mean,
  but not in the colour variance;
- first-bounce emission is clamped to [0, 1];
- normals flip toward the incoming ray;
- normal/albedo/depth AOVs record bounce-0 hits only;
- the next ray origin is pushed 0.05 along the normal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtrace_tpu_torch.ops.intersect import intersect_scene_select
from pathtrace_tpu_torch.ops.sampling import (
    clip01,
    cosine_weighted_direction,
    direct_lighting,
    glossy_direction,
)


class TraceResult(NamedTuple):
    """Per-sample trace outputs for a batch of primary rays.

    color [..., 3]; normal, albedo [..., 3] and depth [...] at bounce 0
    (0 where no bounce-0 hit); hit0 [...] bool; include_color [...] bool
    (the path never escaped: the colour-variance mask).
    """

    color: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor
    depth: torch.Tensor
    hit0: torch.Tensor
    include_color: torch.Tensor


def _normalize(v):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-20)


def trace_paths(
    scene,
    origin,
    direction,
    bounce_uniforms,
    max_bounces: int = 5,
    push_ray_origin: float = 0.05,
    nee_light_index: int | None = None,
    brdf: str = "diffuse",
) -> TraceResult:
    """Trace a batch of primary rays through the scene.

    origin [3] or [..., 3]; direction [..., 3] (unnormalized, as the
    reference's primary rays: depth is measured in that basis);
    bounce_uniforms [..., S * max_bounces] with S = 2 for diffuse and 5 for
    glossy. ``nee_light_index`` adds next-event estimation at every hit.
    """
    batch_shape = direction.shape[:-1]
    dev, dt = direction.device, direction.dtype
    origin = torch.broadcast_to(origin, direction.shape)

    color = torch.zeros(batch_shape + (3,), dtype=dt, device=dev)
    mask = torch.ones(batch_shape + (3,), dtype=dt, device=dev)
    active = torch.ones(batch_shape, dtype=torch.bool, device=dev)
    first_normal = torch.zeros(batch_shape + (3,), dtype=dt, device=dev)
    first_albedo = torch.zeros(batch_shape + (3,), dtype=dt, device=dev)
    first_depth = torch.zeros(batch_shape, dtype=dt, device=dev)
    hit0 = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
    spb = 5 if brdf == "glossy" else 2

    ray_o, ray_d = origin, direction
    for n in range(max_bounces):
        hitdata = intersect_scene_select(ray_o, ray_d, scene)
        hit_now = active & hitdata.hit
        h3 = hit_now[..., None]

        pos = ray_o + ray_d * hitdata.t[..., None]
        normal_out = _normalize(pos - hitdata.center)
        facing = torch.sum(normal_out * ray_d, dim=-1) < 0.0
        normal = torch.where(facing[..., None], normal_out, -normal_out)

        contrib = mask * hitdata.emission
        if n == 0:
            contrib = clip01(contrib)  # pathtrace.cu:170-174
        if nee_light_index is not None:
            dl = direct_lighting(scene, normal, pos, nee_light_index, push_ray_origin)
            contrib = contrib + mask * dl * hitdata.color * 0.5
        color = color + torch.where(h3, contrib, torch.zeros_like(contrib))
        mask = torch.where(h3, mask * hitdata.color, mask)

        if n == 0:
            first_normal = torch.where(h3, normal, torch.zeros_like(normal))
            first_albedo = torch.where(h3, hitdata.color, torch.zeros_like(hitdata.color))
            first_depth = torch.where(hit_now, hitdata.t, torch.zeros_like(hitdata.t))
            hit0 = hit_now

        if n + 1 < max_bounces:
            u = [bounce_uniforms[..., spb * n + k] for k in range(spb)]
            if brdf == "glossy":
                new_d = glossy_direction(normal, *u)
            else:
                new_d = cosine_weighted_direction(normal, *u)
            new_o = pos + normal * push_ray_origin
            ray_o = torch.where(h3, new_o, ray_o)
            ray_d = torch.where(h3, new_d, ray_d)

        active = active & hitdata.hit

    return TraceResult(
        color=color,
        normal=first_normal,
        albedo=first_albedo,
        depth=first_depth,
        hit0=hit0,
        include_color=active,
    )
