"""Hemisphere sampling (diffuse and glossy BRDF) and direct lighting.

The counterpart of ``pathtrace_tpu.ops.sampling`` (reference
``pathtrace.cu:121-148``): an orthonormal basis about the normal from the
"combing coconuts" ortho vector, then a cosine-weighted direction::

    phi = 2*pi*u1;  z = sqrt(u2);  sin_t = sqrt(1 - z*z)
    dir = cos(phi)*sin_t*o1 + sin(phi)*sin_t*o2 + z*n
"""

from __future__ import annotations

import math

import torch

from pathtrace_tpu_torch.ops.intersect import shadow_visibility

TWO_PI = 2.0 * math.pi


def _normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    # eps is far below f32 ulp for unit-scale vectors but keeps the gradient
    # finite on masked-out zero lanes.
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1) with ``jnp.clip``'s subgradient: 1/2 at x == 0 and at
    x == 1, where max/min split a tie (``torch.clamp`` gives 1 there). The
    Cornell box's walls have emission 0 and its albedos include 0 and 1, so
    the gradients of the first-bounce emission clamp and of the inverse
    step's albedo clip sit on that boundary."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def clip01_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip01(x) / dx, written out for the kernels' hand-derived chains:
    1 inside (0, 1), 1/2 at 0 and 1, 0 outside."""
    inside = ((x >= 0.0) & (x <= 1.0)).to(x.dtype)
    edge = ((x == 0.0) | (x == 1.0)).to(x.dtype)
    return inside - 0.5 * edge


def ortho_vector(v: torch.Tensor, cond=None) -> torch.Tensor:
    """A vector orthogonal to v (reference ``orthoVector``,
    ``pathtrace.cu:121-124``): (-y, x, 0) if |x| > |z| else (0, -z, y).

    ``cond`` [...] bool supplies the branch from outside: the frozen-decision
    replay (``ops/frozen.py``) records it at the base point, so that finite
    differences of the replay never cross this discrete branch."""
    if cond is None:
        cond = torch.abs(v[..., 0]) > torch.abs(v[..., 2])
    zero = torch.zeros_like(v[..., 0])
    a = torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)
    b = torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1)
    return torch.where(cond[..., None], a, b)


def cosine_weighted_direction(normal, u1, u2, ortho_cond=None):
    """Cosine-weighted direction about ``normal`` [..., 3] from uniforms
    u1, u2 [...] (``pathtrace.cu:127`` with power = 1); ``ortho_cond`` is
    ``ortho_vector``'s ``cond``."""
    n = _normalize(normal)
    o1 = _normalize(ortho_vector(n, cond=ortho_cond))
    o2 = _normalize(torch.linalg.cross(n, o1, dim=-1))
    phi = u1 * TWO_PI
    z = torch.sqrt(u2)
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = ((torch.cos(phi) * sin_t)[..., None] * o1
         + (torch.sin(phi) * sin_t)[..., None] * o2
         + z[..., None] * n)
    return _normalize(d)


def reflect(incident, normal):
    """Mirror ``incident`` about ``normal``: I - 2 * dot(N, I) * N."""
    return incident - 2.0 * torch.sum(normal * incident, dim=-1, keepdim=True) * normal


def glossy_direction(normal, u1, u2, u3, u4, u5, ortho_cond=None):
    """The reference's "makeshift glossy BRDF" (``pathtrace.cu:181-184``):
    reflect the cosine-weighted sample about the normal, perturb by
    ``0.01 * uniform - 0.005`` per axis, renormalize."""
    d = cosine_weighted_direction(normal, u1, u2, ortho_cond=ortho_cond)
    d = reflect(d, normal)
    jig = 0.01 * torch.stack([u3, u4, u5], dim=-1) - 0.005
    return _normalize(d + jig)


def direct_lighting(scene, normal, position, light_index: int, push: float):
    """Lambert x emission x shadow toward the light's bottom point
    (reference ``getDirectLighting``, ``pathtrace.cu:138-148``)."""
    r = scene.radius[light_index]
    light_bottom = scene.position[light_index] - torch.stack(
        [torch.zeros_like(r), r, torch.zeros_like(r)])
    light_dir = _normalize(light_bottom - position)
    diffuse = clip01(torch.sum(light_dir * normal, dim=-1))
    shadow_origin = position + normal * push
    vis = shadow_visibility(shadow_origin, light_dir, scene, light_index)
    return (diffuse * vis)[..., None] * scene.emission[light_index]
