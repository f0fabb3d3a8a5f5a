"""Frozen-decision record/replay: the gradient-validation oracle.

The counterpart of ``pathtrace_tpu.ops.frozen``. The differentiable
renderer uses the detached-decision convention (``grad.py``): every
DISCRETE choice along a path (which sphere the ray hits, the near or far
root of the quadratic, the normal flip, the ortho-basis branch inside the
cosine sampler, the binary shadow visibility) is a constant to autograd,
while everything continuous (hit t, normals, the NEE Lambert term, bounce
directions) carries derivatives. So the estimator's gradient at a base point
theta_0 is d/d theta of the function "trace with the decisions FROZEN at
theta_0".

This module makes that function. ``record_frame`` traces op for op as
``ops/trace.py::trace_paths`` (the same colour bits, held by
tests/test_torch_frozen.py) and records the per-(sample, pixel, bounce)
decisions; replaying them gives a SMOOTH function of the scene and camera
whose value at theta_0 is the renderer's and whose derivative IS the
detached-decision estimator. Two uses (``scripts/torch_grad_oracle.py``):

1. **Finite-difference oracle**: a central FD of the frozen replay cannot
   step across a frozen decision, so no silhouette term enters it.
2. **Precision oracle**: the replay follows the dtype of its inputs; in
   float64, with decisions recorded by the f32 renderer, autograd gives the
   same estimator with ~1e-16 rounding, which separates gradient faults
   from f32 summation noise in the geometry sums that cancel heavily (the
   r=1e5 wall spheres).

Every entry point runs on ``device`` (``render.resolve_device``: the
current CUDA device unless given one).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from pathtrace_tpu_torch import camera as camera_lib
from pathtrace_tpu_torch import rng
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops.intersect import T_MAX, _sqrt_pos, shadow_visibility
from pathtrace_tpu_torch.ops.sampling import (
    _normalize,
    clip01,
    cosine_weighted_direction,
    glossy_direction,
)
from pathtrace_tpu_torch.render import resolve_device


class Decisions(NamedTuple):
    """Per-(sample, pixel, bounce) discrete choices, shapes [..., B].

    idx:      int32, the winning sphere, -1 = miss. A miss at bounce n means
              the path escaped, and every later bounce records a miss too.
    use_near: bool, the quadratic root taken (t_near > 0, else t_far).
    facing:   bool, the normal kept as outward (dot(n_out, dir) < 0), else
              negated (``pathtrace.cu:164-166``).
    ortho:    bool, the ortho-basis branch |n.x| > |n.z| of the direction
              drawn AT this bounce (``pathtrace.cu:121-124``); the last
              bounce draws none.
    vis:      float 0/1, the NEE shadow visibility (``pathtrace.cu:109-119``);
              all ones where NEE is off.
    """

    idx: torch.Tensor
    use_near: torch.Tensor
    facing: torch.Tensor
    ortho: torch.Tensor
    vis: torch.Tensor


def _intersect_record(scene, ray_o, dn, inv_len):
    """The running-min nearest hit, op for op
    ``ops/intersect.py::intersect_scene_select``, plus (idx, use_near)."""
    batch_shape = dn.shape[:-1]
    dt, dev = dn.dtype, dn.device
    zeros3 = torch.zeros(batch_shape + (3,), dtype=dt, device=dev)
    t_best = torch.full(batch_shape, T_MAX, dtype=dt, device=dev)
    idx = torch.full(batch_shape, -1, dtype=torch.int32, device=dev)
    use_near = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
    center, emission, color = zeros3, zeros3, zeros3
    for i in range(scene.num_objects):
        rel = scene.position[i] - ray_o
        tca = torch.sum(rel * dn, dim=-1)
        perp = rel - tca[..., None] * dn
        d2 = torch.sum(perp * perp, dim=-1)
        det = scene.radius[i] * scene.radius[i] - d2
        thc = _sqrt_pos(det)
        t_near = (tca - thc) * inv_len
        t_far = (tca + thc) * inv_len
        take_near = t_near > 0.0
        t = torch.where(take_near, t_near, t_far)
        valid = (det >= 0.0) & (t > 0.0) & (t < T_MAX)
        closer = valid & (t < t_best)
        t_best = torch.where(closer, t, t_best)
        idx = idx.masked_fill(closer, i)
        use_near = torch.where(closer, take_near, use_near)
        c3 = closer[..., None]
        center = torch.where(c3, scene.position[i].expand_as(center), center)
        emission = torch.where(c3, scene.emission[i].expand_as(emission), emission)
        color = torch.where(c3, scene.color[i].expand_as(color), color)
    return t_best, idx, use_near, center, emission, color


def _intersect_replay(scene, ray_o, dn, inv_len, idx, use_near):
    """The nearest hit with the sphere CHOICE frozen: t and the parameters of
    sphere ``idx``, differentiable; miss lanes (-1) take sphere 0's inert
    values, masked out downstream as in ``trace_paths``."""
    hit = idx >= 0
    safe = idx.clamp(0, scene.num_objects - 1).long()
    center, emission = scene.position[safe], scene.emission[safe]
    color, radius = scene.color[safe], scene.radius[safe]
    rel = center - ray_o
    tca = torch.sum(rel * dn, dim=-1)
    perp = rel - tca[..., None] * dn
    d2 = torch.sum(perp * perp, dim=-1)
    det = radius * radius - d2
    # A grazing hit may push det below 0 under a perturbation: the clamp keeps
    # the replay defined and continuous there (t -> tca), and the double
    # where inside _sqrt_pos keeps the backward free of NaN.
    thc = _sqrt_pos(det)
    t = torch.where(use_near, tca - thc, tca + thc) * inv_len
    return t, hit, center, emission, color


def _light_dir(scene, position, light_index):
    """Unit direction to the light's bottom point, as
    ``ops/sampling.direct_lighting`` forms it."""
    r = scene.radius[light_index]
    light_bottom = scene.position[light_index] - torch.stack(
        [torch.zeros_like(r), r, torch.zeros_like(r)])
    return _normalize(light_bottom - position)


def _direct_lighting_frozen(scene, normal, position, light_index, vis):
    """``ops/sampling.direct_lighting`` with the binary shadow visibility
    given (piecewise constant, so autograd sees no gradient through it;
    freezing it keeps an FD from stepping across an occlusion flip)."""
    diffuse = clip01(torch.sum(_light_dir(scene, position, light_index) * normal, dim=-1))
    return (diffuse * vis)[..., None] * scene.emission[light_index]


def frozen_trace(scene, origin, direction, bounce_uniforms, decisions: Decisions | None = None,
                 max_bounces: int = 5, push_ray_origin: float = 0.05,
                 nee_light_index: int | None = None, brdf: str = "diffuse"):
    """Trace primary rays -> (colour [..., 3], Decisions).

    With ``decisions=None`` this records: the forward is op for op
    ``ops/trace.py::trace_paths`` (the same colour bits) while every discrete
    choice is captured. With decisions given, those choices are frozen and
    the trace is a smooth function of the scene and camera parameters.
    """
    record = decisions is None
    batch_shape = direction.shape[:-1]
    dev, dt = direction.device, direction.dtype
    origin = torch.broadcast_to(origin, direction.shape)

    color = torch.zeros(batch_shape + (3,), dtype=dt, device=dev)
    mask = torch.ones(batch_shape + (3,), dtype=dt, device=dev)
    active = torch.ones(batch_shape, dtype=torch.bool, device=dev)
    spb = 5 if brdf == "glossy" else 2
    rec = {k: [] for k in Decisions._fields}

    ray_o, ray_d = origin, direction
    for n in range(max_bounces):
        inv_len = torch.rsqrt(torch.sum(ray_d * ray_d, dim=-1))
        dn = ray_d * inv_len[..., None]
        if record:
            t, idx, use_near, center, emission, obj_color = _intersect_record(
                scene, ray_o, dn, inv_len)
            hit = idx >= 0
        else:
            idx, use_near = decisions.idx[..., n], decisions.use_near[..., n]
            t, hit, center, emission, obj_color = _intersect_replay(
                scene, ray_o, dn, inv_len, idx, use_near)
        hit_now = active & hit
        h3 = hit_now[..., None]

        pos = ray_o + ray_d * t[..., None]
        normal_out = _normalize(pos - center)
        if record:
            facing = torch.sum(normal_out * ray_d, dim=-1) < 0.0
        else:
            facing = decisions.facing[..., n]
        normal = torch.where(facing[..., None], normal_out, -normal_out)

        contrib = mask * emission
        if n == 0:
            contrib = clip01(contrib)  # pathtrace.cu:170-174
        if nee_light_index is not None:
            if record:
                vis = shadow_visibility(pos + normal * push_ray_origin,
                                        _light_dir(scene, pos, nee_light_index), scene,
                                        nee_light_index)
            else:
                vis = decisions.vis[..., n]
            dl = _direct_lighting_frozen(scene, normal, pos, nee_light_index, vis)
            contrib = contrib + mask * dl * obj_color * 0.5
        else:
            vis = torch.ones(batch_shape, dtype=dt, device=dev)
        color = color + torch.where(h3, contrib, torch.zeros_like(contrib))
        mask = torch.where(h3, mask * obj_color, mask)

        if record:
            # The sampler's own branch, on the normalized normal as
            # ortho_vector sees it; record mode lets the sampler take it.
            nrm = _normalize(normal)
            ortho = torch.abs(nrm[..., 0]) > torch.abs(nrm[..., 2])
            ortho_arg = None
        else:
            ortho = ortho_arg = decisions.ortho[..., n]
        if n + 1 < max_bounces:
            u = [bounce_uniforms[..., spb * n + k] for k in range(spb)]
            if brdf == "glossy":
                new_d = glossy_direction(normal, *u, ortho_cond=ortho_arg)
            else:
                new_d = cosine_weighted_direction(normal, *u, ortho_cond=ortho_arg)
            new_o = pos + normal * push_ray_origin
            ray_o = torch.where(h3, new_o, ray_o)
            ray_d = torch.where(h3, new_d, ray_d)

        active = active & hit
        if record:
            rec["idx"].append(torch.where(hit_now, idx, torch.full_like(idx, -1)))
            rec["use_near"].append(use_near & hit_now)
            rec["facing"].append(facing & hit_now)
            rec["ortho"].append(ortho & hit_now)
            rec["vis"].append(torch.where(hit_now, vis, torch.zeros_like(vis)))

    if record:
        decisions = Decisions(**{k: torch.stack(v, dim=-1) for k, v in rec.items()})
    return color, decisions


def _chunk_rays(cam_eye, basis, cfg: RenderConfig, frame, chunk_spp: int, sample_offset: int):
    """Primary rays and bounce uniforms of one spp chunk, as
    ``render._trace_chunk`` makes them, in the dtype and on the device of
    ``basis``: the uniforms are drawn in f32 and then cast. -> (origin [3],
    directions [S, H, W, 3], bounce uniforms [S, H, W, slots])."""
    dt, dev = basis.dtype, basis.device
    uniforms = rng.sample_uniforms(
        cfg.seed, frame, chunk_spp, cfg.height, cfg.width, cfg.max_bounces, sample_offset,
        slots_per_bounce=cfg.slots_per_bounce, device=dev,
    ).to(dt)
    rows = torch.arange(cfg.height, dtype=dt, device=dev)[:, None].expand(cfg.height, cfg.width)
    cols = torch.arange(cfg.width, dtype=dt, device=dev)[None, :].expand(cfg.height, cfg.width)
    if cfg.resolved_jitter:
        rows = rows + (uniforms[..., 0] - 0.5)
        cols = cols + (uniforms[..., 1] - 0.5)
    ndc_x, ndc_y = camera_lib.pixel_ndc(rows, cols, cfg.width, cfg.height)
    directions = camera_lib.ray_directions(basis, ndc_x, ndc_y)
    if directions.dim() == 3:  # no jitter -> no sample axis; add it
        directions = directions.expand(chunk_spp, cfg.height, cfg.width, 3)
    return cam_eye.to(dt), directions, uniforms[..., 2:]


def _trace_kwargs(cfg: RenderConfig) -> dict:
    return dict(max_bounces=cfg.max_bounces, push_ray_origin=cfg.push_ray_origin,
                nee_light_index=cfg.light_index if cfg.nee else None, brdf=cfg.brdf)


def record_frame(scene, cam, cfg: RenderConfig, frame=0, device=None):
    """Trace the whole frame with the renderer's arithmetic (f32 for the
    f32 scene and camera), recording the decisions of each spp chunk.
    -> (mean colour [H, W, 3], list of Decisions, one a chunk, on ``device``)."""
    device = resolve_device(device)
    scene, cam = scene.to(device), cam.to(device)
    eye, basis = cam.position, cam.eye_ray_basis(cfg.width, cfg.height)
    total = torch.zeros((cfg.height, cfg.width, 3), dtype=basis.dtype, device=device)
    recs, offset = [], 0
    with torch.no_grad():
        for chunk in cfg.chunks():
            o, d, bu = _chunk_rays(eye, basis, cfg, frame, chunk, offset)
            color, dec = frozen_trace(scene, o, d, bu, **_trace_kwargs(cfg))
            total = total + torch.sum(color, dim=0)
            recs.append(dec)
            offset += chunk
    return total / cfg.spp, recs


def replay_color(scene, eye, basis, cfg: RenderConfig, frame, recs, remat: bool = True,
                 device=None):
    """Mean colour [H, W, 3] of the frozen replay, smooth in (scene, eye,
    basis); the dtype follows ``basis`` (cast the scene, eye and basis to
    float64 for the precision oracle). ``recs`` zip with ``cfg.chunks()``.
    ``remat`` checkpoints each chunk (``torch.utils.checkpoint``), so the
    backward keeps one chunk's intermediates at a time, as ``grad.py``."""
    device = resolve_device(device)
    scene, eye, basis = scene.to(device), eye.to(device), basis.to(device)
    dt = basis.dtype

    def chunk_color(scene_, eye_, basis_, dec, chunk, offset):
        o, d, bu = _chunk_rays(eye_, basis_, cfg, frame, chunk, offset)
        color, _ = frozen_trace(scene_, o, d, bu, decisions=dec, **_trace_kwargs(cfg))
        return torch.sum(color, dim=0)

    total = torch.zeros((cfg.height, cfg.width, 3), dtype=dt, device=device)
    offset = 0
    for dec, chunk in zip(recs, cfg.chunks()):
        dec = Decisions(*(x.to(device, dt if x.is_floating_point() else x.dtype) for x in dec))
        if remat:
            total = total + checkpoint(chunk_color, scene, eye, basis, dec, chunk, offset,
                                       use_reentrant=False, preserve_rng_state=False)
        else:
            total = total + chunk_color(scene, eye, basis, dec, chunk, offset)
        offset += chunk
    return total / cfg.spp


def replay_loss(scene, cam, cfg: RenderConfig, frame, recs, target, dtype=torch.float32,
                device=None):
    """Mean-squared pixel loss of the frozen replay, differentiable in
    (scene, camera): its gradient is the detached-decision estimator at the
    record point. The whole chain, the camera's pose -> eye-ray basis
    included (dtype-generic, ``camera.py``), runs in ``dtype``: the f64
    oracle differentiates the function the f32 renderer computes, with
    ~1e-16 rounding."""
    device = resolve_device(device)
    cam = cam.to(device).astype(dtype)
    color = replay_color(scene.astype(dtype), cam.position,
                         cam.eye_ray_basis(cfg.width, cfg.height), cfg, frame, recs,
                         device=device)
    diff = color - torch.as_tensor(target, device=device).to(dtype)
    return torch.sum(diff * diff) / (cfg.height * cfg.width * 3)


def replay_loss_grads(scene, cam, cfg: RenderConfig, frame, recs, target, dtype=torch.float32,
                      device=None):
    """(loss, (d_scene, d_camera)) of the frozen replay by autograd, the
    gradients in the dtype of the given scene and camera (``dtype`` is the
    arithmetic's), as ``grad._value_and_grad``."""
    from pathtrace_tpu_torch.grad import _value_and_grad

    device = resolve_device(device)

    def f(scene_, cam_):
        return replay_loss(scene_, cam_, cfg, frame, recs, target, dtype=dtype, device=device)

    return _value_and_grad(f, scene, cam, device)


def pixel_jvp_fd(perturb, cfg: RenderConfig, frame, recs, eps: float, device=None):
    """The per-pixel derivative of the replay's mean colour along one
    parameter h, at h = 0, two ways: forward mode (``torch.func.jvp``) and a
    central finite difference with step ``eps``. ``perturb(h)`` -> (scene,
    camera) in the dtype to run in (float64 for the oracle); ``recs`` zip
    with ``cfg.chunks()``. -> (J, D), float64 numpy arrays [H, W, 3]."""
    device = resolve_device(device)

    def color_of(h):
        scene, cam = perturb(h)
        return replay_color(scene, cam.position, cam.eye_ray_basis(cfg.width, cfg.height), cfg,
                            frame, recs, remat=False, device=device)

    h0 = torch.zeros((), dtype=torch.float64, device=device)
    _, tangent = torch.func.jvp(color_of, (h0,), (torch.ones_like(h0),))
    with torch.no_grad():
        cp, cm = color_of(h0 + eps), color_of(h0 - eps)
    J = tangent.detach().to("cpu", torch.float64).numpy()
    D = ((cp - cm) / (2 * eps)).to("cpu", torch.float64).numpy()
    return J, D

