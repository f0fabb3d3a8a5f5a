"""Differentiable rendering: pixel gradients with respect to scene and camera.

The counterpart of ``pathtrace_tpu.grad``. Two backends, as for rendering:

- ``"torch"``: autograd through the plain wavefront (``ops/trace.py``). The
  discrete decisions are detached: which sphere a ray hits, the normal
  flip, the escape mask and every random draw are fixed per sample (sphere
  choices are boolean masks). Silhouette gradients are therefore biased
  toward zero; interior shading and geometry gradients are exact in
  expectation. Each spp chunk is checkpointed (``torch.utils.checkpoint``),
  so its intermediates are recomputed in the backward instead of kept.
- ``"cuda"``: the hand-written kernels, for every configuration. Diffuse
  without NEE (``ops/grad_kernel.py``): a sample's colour is a product
  chain in emission and albedo, so gradients of the colour with respect to
  positions, radii and the camera are exactly zero, and are returned as
  zeros. NEE diffuse (``ops/nee_grad_kernel.py``): the colour depends
  continuously on sphere positions, radii and the camera through the
  Lambert term of the light sample, and the kernel returns the gradients
  of all seven fields. Glossy, with or without NEE
  (``ops/ad_grad_kernel.py``): the all-parameter backward, after a colour
  pass of the forward kernel. ``render_aovs_diff`` and
  ``render_geometry_grads`` differentiate all four AOVs with autograd on
  ``"torch"`` whatever the backend, as in the JAX package; the kernel that
  takes the cotangents of the normal, albedo and depth AOVs is reached
  through ``ops.ad_grad_kernel.ad_aov_grads``.

``"auto"`` is ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU.
Gradients come back as a ``Scene`` and a ``Camera`` holding the gradient of
each field.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import grad_kernel
from pathtrace_tpu_torch.ops import variance as var_lib
from pathtrace_tpu_torch.render import _trace_chunk, finalize_aovs, resolve_backend
from pathtrace_tpu_torch.scene import Scene

SCENE_FIELDS = ("radius", "position", "emission", "color")
CAMERA_FIELDS = ("position", "yaw", "pitch")


def _accumulate_checkpointed(scene, cam, cfg: RenderConfig, frame):
    """``render.accumulate_frame`` with each spp chunk checkpointed."""

    def chunk(spp, offset):
        return checkpoint(_trace_chunk, scene, cam, cfg, frame, spp, offset,
                          use_reentrant=False, preserve_rng_state=False)

    chunks = cfg.chunks()
    sums, moments = chunk(chunks[0], 0)
    offset = chunks[0]
    for chunk_spp in chunks[1:]:
        s, m = chunk(chunk_spp, offset)
        sums = {k: sums[k] + s[k] for k in sums}
        moments = {k: var_lib.merge_moments(moments[k], m[k]) for k in moments}
        offset += chunk_spp
    return sums, moments


def _device(scene, device) -> torch.device:
    return scene.device if device is None else torch.device(device)


def render_aovs_diff(scene, cam, cfg: RenderConfig, frame=0, device=None):
    """Differentiable AOV dict on the ``"torch"`` backend, whatever
    ``cfg.backend`` says (for given AOV cotangents on the kernels see
    ``ops.ad_grad_kernel.ad_aov_grads``).

    Colour is differentiable in albedo and emission everywhere, and in
    geometry only through the NEE Lambert term (``cfg.nee``). Depth and
    normal are continuously differentiable in sphere position and radius and
    in the camera pose for interior rays."""
    device = _device(scene, device)
    sums, moments = _accumulate_checkpointed(scene.to(device), cam.to(device), cfg, frame)
    return finalize_aovs(sums, moments, cfg.spp)


def render_color(scene, cam, cfg: RenderConfig, frame=0, device=None) -> torch.Tensor:
    """Differentiable colour image [H, W, 3]: on ``"cuda"`` a kernel forward
    and a kernel or contraction backward for every configuration
    (``grad_kernel.render_color``), autograd on ``"torch"``."""
    device = _device(scene, device)
    if resolve_backend(cfg, device) == "cuda":
        return grad_kernel.render_color(scene, cam, cfg, frame, device)
    return render_aovs_diff(scene, cam, cfg, frame, device)["color"]


def l2_image_loss(color, target):
    return torch.mean((color - target) ** 2)


def _value_and_grad(f: Callable, scene, cam, device):
    """(f(scene, cam), (d_scene, d_cam)) by autograd; a field that f does not
    reach gets a zero gradient."""
    scene_leaves = [getattr(scene, k).detach().to(device).requires_grad_(True)
                    for k in SCENE_FIELDS]
    cam_leaves = [getattr(cam, k).detach().to(device).requires_grad_(True)
                  for k in CAMERA_FIELDS]
    value = f(Scene(*scene_leaves), Camera(*cam_leaves))
    leaves = scene_leaves + cam_leaves
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return value.detach(), (Scene(*grads[:4]), Camera(*grads[4:]))


def render_loss_grads(scene, cam, cfg: RenderConfig, frame=0, target=None, device=None):
    """(loss, (d_scene, d_camera)) of the mean-squared pixel loss against
    ``target`` [H, W, 3], or against a zero image when there is none. On
    ``"cuda"`` the kernels compute loss and gradients: one fused launch of
    the product-chain kernel for diffuse or of the NEE kernel for NEE
    diffuse; for glossy one colour pass of the forward kernel and one launch
    of the all-parameter backward."""
    device = _device(scene, device)
    if target is None:
        target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    if resolve_backend(cfg, device) == "cuda":
        return grad_kernel.loss_and_grads(scene, cam, cfg, frame, target, device)

    def loss_fn(scene_, cam_):
        return l2_image_loss(render_color(scene_, cam_, cfg, frame, device), target)

    return _value_and_grad(loss_fn, scene, cam, device)


def render_scalar_grads(scene, cam, cfg: RenderConfig, frame=0, device=None):
    """Gradients of the mean image luminance, the probe of the finite-
    difference tests (albedo and emission; and geometry under NEE). On
    ``"cuda"`` through ``grad_kernel.render_color``, any configuration."""
    device = _device(scene, device)

    def f(scene_, cam_):
        return torch.mean(var_lib.luminance(render_color(scene_, cam_, cfg, frame, device)))

    return _value_and_grad(f, scene, cam, device)


def render_geometry_grads(scene, cam, cfg: RenderConfig, frame=0, device=None):
    """Gradients of a geometry probe, mean depth (scaled to O(1)) plus mean
    normal-y, which is continuous in sphere position and radius and in the
    camera pose: the finite-difference oracle for geometry."""
    device = _device(scene, device)

    def f(scene_, cam_):
        aovs = render_aovs_diff(scene_, cam_, cfg, frame, device)
        return torch.mean(aovs["depth"]) * 1e-4 + torch.mean(aovs["normal"][..., 1])

    return _value_and_grad(f, scene, cam, device)


def finite_difference(f: Callable, x, eps: float) -> np.ndarray:
    """Central finite differences of scalar f at x (elementwise), with the
    perturbation taken in float64 and f called on float32 arrays of x's
    shape."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for idx in np.ndindex(x.shape):
        xp, xm = x.copy(), x.copy()
        xp[idx] += eps
        xm[idx] -= eps
        g[idx] = (float(f(xp.astype(np.float32))) - float(f(xm.astype(np.float32)))) / (2 * eps)
    return g


def grad_config(cfg: RenderConfig) -> RenderConfig:
    """A config for the backward pass: the ``"torch"`` backend with
    checkpointed spp chunks of at most 8 samples."""
    spp_chunk = cfg.spp_chunk if cfg.spp_chunk > 0 else min(cfg.spp, 8)
    return dataclasses.replace(cfg, backend="torch", spp_chunk=spp_chunk)
