"""Ray-sphere intersection, rays x spheres.

The counterpart of ``pathtrace_tpu.ops.intersect`` (reference
``pathtrace.cu:72-107``):

- a hit exists iff the discriminant >= 0;
- ``t = tNear if tNear > 0 else tFar``: hits from inside a sphere count,
  which the Cornell box needs (the camera is inside the wall spheres);
- the nearest hit is the first sphere with the strictly smallest t in
  (0, 1e6).

The discriminant is formed geometrically (the perpendicular foot from the
centre onto the ray), not as ``b^2 - 4ac``: with the r=1e5 wall spheres the
quadratic form cancels catastrophically in f32. ``t`` is in units of the
unnormalized direction (the reference's depth convention). Sphere choices
are boolean masks, so autograd sees them as constants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

T_MAX = 1.0e6  # tNearest init, pathtrace.cu:94


def _sqrt_pos(det: torch.Tensor) -> torch.Tensor:
    """sqrt(max(det, 0)) with a gradient that stays finite at det <= 0."""
    pos = det > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, det, torch.ones_like(det))),
                       torch.zeros_like(det))


class SceneHit(NamedTuple):
    """Nearest-hit data: hit [...] bool, t [...] f32 (undefined where no
    hit), index [...] int64, one_hot [..., N] f32 selector (detached)."""

    hit: torch.Tensor
    t: torch.Tensor
    index: torch.Tensor
    one_hot: torch.Tensor


class SelectedHit(NamedTuple):
    """Nearest hit with the winning sphere's parameters gathered: hit [...],
    t [...], center/emission/color [..., 3]."""

    hit: torch.Tensor
    t: torch.Tensor
    center: torch.Tensor
    emission: torch.Tensor
    color: torch.Tensor


def intersect_spheres(origin, direction, radius, position):
    """Per-sphere candidate ts: origin, direction [..., 3]; radius [N];
    position [N, 3] -> (t, valid), both [..., N]."""
    inv_len = torch.rsqrt(torch.sum(direction * direction, dim=-1))
    dn = direction * inv_len[..., None]
    rel = position - origin[..., None, :]  # [..., N, 3]
    tca = torch.sum(rel * dn[..., None, :], dim=-1)
    perp = rel - tca[..., None] * dn[..., None, :]
    d2 = torch.sum(perp * perp, dim=-1)
    det = radius * radius - d2
    thc = _sqrt_pos(det)
    t_near = (tca - thc) * inv_len[..., None]
    t_far = (tca + thc) * inv_len[..., None]
    t = torch.where(t_near > 0.0, t_near, t_far)
    valid = (det >= 0.0) & (t > 0.0) & (t < T_MAX)
    return t, valid


def intersect_scene_select(origin, direction, scene) -> SelectedHit:
    """Nearest hit by a running-min loop over spheres; every intermediate
    stays at ray-batch size. Later spheres win only when strictly closer."""
    inv_len = torch.rsqrt(torch.sum(direction * direction, dim=-1))
    dn = direction * inv_len[..., None]
    batch_shape = direction.shape[:-1]
    zeros3 = torch.zeros(batch_shape + (3,), dtype=direction.dtype, device=direction.device)

    t_best = torch.full(batch_shape, T_MAX, dtype=direction.dtype, device=direction.device)
    hit = torch.zeros(batch_shape, dtype=torch.bool, device=direction.device)
    center, emission, color = zeros3, zeros3, zeros3
    for i in range(scene.num_objects):
        rel = scene.position[i] - origin
        tca = torch.sum(rel * dn, dim=-1)
        perp = rel - tca[..., None] * dn
        d2 = torch.sum(perp * perp, dim=-1)
        det = scene.radius[i] * scene.radius[i] - d2
        thc = _sqrt_pos(det)
        t_near = (tca - thc) * inv_len
        t_far = (tca + thc) * inv_len
        t = torch.where(t_near > 0.0, t_near, t_far)
        valid = (det >= 0.0) & (t > 0.0) & (t < T_MAX)
        closer = valid & (t < t_best)
        t_best = torch.where(closer, t, t_best)
        hit = hit | closer
        c3 = closer[..., None]
        center = torch.where(c3, scene.position[i].expand_as(center), center)
        emission = torch.where(c3, scene.emission[i].expand_as(emission), emission)
        color = torch.where(c3, scene.color[i].expand_as(color), color)
    return SelectedHit(hit=hit, t=t_best, center=center, emission=emission, color=color)


def intersect_scene(origin, direction, scene) -> SceneHit:
    """Nearest hit over all spheres of ``scene`` for rays [..., 3]."""
    t, valid = intersect_spheres(origin, direction, scene.radius, scene.position)
    t_masked = torch.where(valid, t, torch.full_like(t, T_MAX))
    index = torch.argmin(t_masked.detach(), dim=-1)
    one_hot = torch.nn.functional.one_hot(index, scene.num_objects).to(t.dtype)
    t_hit = torch.sum(one_hot * t, dim=-1)
    hit = torch.any(valid, dim=-1)
    return SceneHit(hit=hit, t=t_hit, index=index, one_hot=one_hot)


def shadow_visibility(origin, direction, scene, light_index: int) -> torch.Tensor:
    """Binary visibility toward the light (reference ``testShadowRay``,
    ``pathtrace.cu:109-119``): occluded iff a non-light sphere is hit at
    0 < t < dist(origin, light_bottom), light_bottom = light.pos - (0, r, 0)."""
    light_bottom = scene.position[light_index] - torch.stack([
        torch.zeros_like(scene.radius[light_index]), scene.radius[light_index],
        torch.zeros_like(scene.radius[light_index]),
    ])
    t_nearest = torch.linalg.norm(light_bottom - origin, dim=-1)
    t, valid = intersect_spheres(origin, direction, scene.radius, scene.position)
    not_light = torch.arange(scene.num_objects, device=t.device) != light_index
    occludes = valid & not_light & (t < t_nearest[..., None])
    return torch.where(torch.any(occludes, dim=-1), 0.0, 1.0).to(t.dtype)
