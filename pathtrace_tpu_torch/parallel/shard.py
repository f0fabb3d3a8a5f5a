"""Rendering and loss+gradients over a ("tiles", "samples") grid of ranks.

The counterpart of ``pathtrace_tpu.parallel.shard`` on ``torch.
distributed``. Each rank renders its row slab (axis "tiles") for its spp
range (axis "samples") of the ONE global sample lattice: the kernels take
the slab's absolute row and sample offsets (``trace_kernel.
make_seed_block``), so a rank computes exactly its part of the single-
device lattice. Then:

- the 22-channel partials (10 raw sums, Welford (n, mean, M2) of four
  luminances) are gathered over "samples" (``all_gather``) and folded in
  ``si`` order: the sums add, the moments merge with Chan's formula
  (``ops/variance.merge_moments``; the merge is affine, not a sum). One
  gather carries both, and every rank of a slab folds the same values in
  the same order, so they hold the same bits;
- the finished slab [H/t, W, 14] is gathered over "tiles" for the frame
  [H, W, 14] every rank returns (``render_channels_sharded``), or kept
  (``render_slab_sharded``), so that a denoiser takes it without the frame
  being gathered (``models/spatial.py``, ``models/fpn_spatial.py``);
- for gradients, the colour is all-reduced over "samples", the loss over
  "tiles", the gradient block over the grid, and the camera's pullback runs
  once on each rank, so every rank returns the same loss and gradients.

A sum's order differs from the single-device launch's (and a slab of fewer
pixels may get more sample lanes, ``trace_kernel.sample_lanes``), so the
merged frame equals the single-device frame to float tolerance, not to the
bit: tests/test_torch_parallel.py states the tolerances.

``cfg.backend`` picks the engine of a rank's slab on the rank's device:
``"cuda"`` (the hand-written kernels, or their plain versions for CPU
tensors) or ``"torch"`` (the wavefront, autograd for gradients); ``"auto"``
is ``"cuda"`` on a card and ``"torch"`` on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import variance as var_lib
from pathtrace_tpu_torch.parallel.mesh import Mesh
from pathtrace_tpu_torch.render import (FEATURES, accumulate_frame, finalize_aovs,
                                        pack_channels, resolve_backend, unpack_channels)
from pathtrace_tpu_torch.scene import Scene

AXES = ("tiles", "samples")


# -- collectives ------------------------------------------------------------------

def _group(mesh: Mesh, axes: Sequence[str]):
    axes = tuple(axes)
    if axes == ("tiles",):
        return mesh.tiles_group
    if axes == ("samples",):
        return mesh.samples_group
    if sorted(axes) == sorted(AXES):
        return mesh.group
    raise ValueError(f"axes must be 'tiles', 'samples' or both, got {axes}")


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` (the sum: ``psum``) over the ranks of
    ``axes``, on every one of them; ``x`` is left as it was."""
    out = x.clone()
    if mesh.distributed:
        dist.all_reduce(out, op, group=_group(mesh, axes))
    return out


def all_gather_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """``x`` of every rank of ``axis``, in the axis's order (``ti`` for
    "tiles", ``si`` for "samples"); each rank's ``x`` has one shape."""
    if not mesh.distributed:
        return [x]
    group = _group(mesh, (axis,))
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def gather_rows(slab: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of every "tiles" rank, top to bottom: [h, ...] -> [h t, ...]
    (``out_specs=P("tiles")``)."""
    return torch.cat(all_gather_axis(slab, mesh, "tiles"), dim=0)


def shard_rows(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a whole [H, ...] tensor (``P("tiles")``)."""
    n_t = mesh.shape["tiles"]
    if full.shape[0] % n_t:
        raise ValueError(f"height {full.shape[0]} not divisible by tiles={n_t}")
    h = full.shape[0] // n_t
    return full[mesh.ti * h:(mesh.ti + 1) * h]


# -- the sharded render --------------------------------------------------------------

def slab_extent(cfg: RenderConfig, mesh: Mesh) -> Dict[str, int]:
    """This rank's ``row_offset``, ``local_h``, ``spp`` and ``sample_offset``
    on the lattice; raises where height or spp does not divide the grid."""
    n_t, n_s = mesh.shape["tiles"], mesh.shape["samples"]
    if cfg.height % n_t:
        raise ValueError(f"height {cfg.height} not divisible by tiles={n_t}")
    if cfg.spp % n_s:
        raise ValueError(f"spp {cfg.spp} not divisible by samples={n_s}")
    local_h, local_spp = cfg.height // n_t, cfg.spp // n_s
    return dict(row_offset=mesh.ti * local_h, local_h=local_h, spp=local_spp,
                sample_offset=mesh.si * local_spp)


def pack_partials(sums, moments) -> torch.Tensor:
    """(sums, moments) dicts -> [..., 22] partials in the layout of the trace
    kernel's partials mode (``trace_kernel.partials_from_block`` reads it)."""
    chans = [sums["color"], sums["normal"], sums["albedo"], sums["depth"][..., None]]
    for k in FEATURES:
        m = moments[k]
        chans += [m.n[..., None], m.mean[..., None], m.m2[..., None]]
    return torch.cat(chans, dim=-1)


def slab_partials(scene, cam, cfg: RenderConfig, mesh: Mesh, frame=0) -> torch.Tensor:
    """This rank's partials [H/t, W, 22]: its rows and samples of the
    lattice, on its device: one launch of the trace kernel in its partials
    mode on ``"cuda"``, the wavefront on ``"torch"``."""
    ext = slab_extent(cfg, mesh)
    if resolve_backend(cfg, mesh.device) == "cuda":
        from pathtrace_tpu_torch.ops import trace_kernel as tk

        sums, moments = tk.accumulate_frame_kernel(scene, cam, cfg, frame, device=mesh.device,
                                                   **ext)
    else:
        sums, moments = accumulate_frame(scene.to(mesh.device), cam.to(mesh.device), cfg,
                                         frame, **ext)
    return pack_partials(sums, moments)


def fold_partials(parts: Sequence[torch.Tensor]):
    """Partials of consecutive sample ranges, in order -> (sums, moments) of
    their union: sums added, moments merged with Chan's formula."""
    from pathtrace_tpu_torch.ops.trace_kernel import partials_from_block

    sums, moments = partials_from_block(parts[0])
    for part in parts[1:]:
        s, m = partials_from_block(part)
        sums = {k: sums[k] + s[k] for k in sums}
        moments = {k: var_lib.merge_moments(moments[k], m[k]) for k in moments}
    return sums, moments


def render_slab_sharded(scene, cam, cfg: RenderConfig, mesh: Mesh, frame=0) -> torch.Tensor:
    """This rank's rows of the finished frame, [H/t, W, 14], on its device:
    its slab's partials, gathered over "samples" and folded."""
    parts = all_gather_axis(slab_partials(scene, cam, cfg, mesh, frame), mesh, "samples")
    sums, moments = fold_partials(parts)
    return pack_channels(finalize_aovs(sums, moments, cfg.spp))


def render_channels_sharded(scene, cam, cfg: RenderConfig, mesh: Mesh, frame=0) -> torch.Tensor:
    """The packed [H, W, 14] frame, rendered over the grid, on every rank."""
    return gather_rows(render_slab_sharded(scene, cam, cfg, mesh, frame), mesh)


def render_aovs_sharded(scene, cam, cfg: RenderConfig, mesh: Mesh, frame=0):
    return unpack_channels(render_channels_sharded(scene, cam, cfg, mesh, frame))


# -- loss and gradients -----------------------------------------------------------------

def _zero_geometry(scene, cam, emission, color, device):
    scene, cam = scene.to(device), cam.to(device)
    d_scene = Scene(torch.zeros_like(scene.radius), torch.zeros_like(scene.position),
                    emission, color)
    d_cam = Camera(torch.zeros_like(cam.position), torch.zeros_like(cam.yaw),
                   torch.zeros_like(cam.pitch))
    return d_scene, d_cam


def _kernel_slab(scene, cam, cfg: RenderConfig, mesh: Mesh, target, frame, ext) -> dict:
    """This rank's launch of the route's backward kernel on its slab
    (``pallas_grad.pallas_loss_and_grads``'s dispatch, ``shard_fn_pallas``):
    diffuse without NEE, one K2 dump; NEE diffuse, a K1 colour pass and one
    K3 replay; glossy, a K1 colour pass and one K4 replay. -> dict of
    "route" (``grad_kernel.route``), "diff" (this rank's rows of the global
    colour less the target) and the launch's outputs: "color" and "acc" of
    the dump (means over the rank's samples) and "scale" (local_spp / spp);
    or the per-sample colour cotangent "ct" [3, local_h, W] the replay was
    given and its gradient block "block" [N + 5, 11], this rank's share."""
    from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
    from pathtrace_tpu_torch.ops import grad_kernel as gk
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
    from pathtrace_tpu_torch.ops import trace_kernel as tk

    dev = mesh.device
    denom = cfg.height * cfg.width * 3
    kind = gk.route(cfg)
    if kind == "chain":
        local_color, acc = gk.grad_acc_slab(scene, cam, cfg, frame, device=dev, **ext)
        # local_color and acc are means over the rank's samples: rescaled to
        # the global spp average before the "samples" sum.
        scale = ext["spp"] / cfg.spp
        color = all_reduce(local_color * scale, mesh, ("samples",))
        return dict(route=kind, diff=color - target, color=local_color, acc=acc, scale=scale)
    sums = tk.render_color_sums(scene, cam, cfg, frame, device=dev, **ext)
    color = all_reduce(sums, mesh, ("samples",)) / cfg.spp  # [local_h, W, 3]
    diff = color - target
    if kind == "nee":
        ct = (2.0 * diff / denom / cfg.spp).permute(2, 0, 1)
        block = nk.nee_grads_block_slab(scene, cam, cfg, frame, ct, device=dev, **ext)
    else:
        ct = ak.pack_cotangents(cfg, ct_color=2.0 * diff / denom, local_h=ext["local_h"],
                                device=dev)
        block = ak.ad_grads_block_slab(scene, cam, cfg, frame, ct, device=dev, **ext)
    return dict(route=kind, diff=diff, ct=ct, block=block)


def kernel_slab_launch(scene, cam, cfg: RenderConfig, mesh: Mesh, target, frame=0) -> dict:
    """The backward kernel's launch on this rank's slab, as ``sharded_loss_grads``
    makes it on ``"cuda"`` (every rank of the grid calls it: it all-reduces the
    colour), with what the launch was given: ``_kernel_slab``'s dict plus
    "ext" (``slab_extent``). For holding a slab launch against its plain
    version on the same inputs."""
    ext = slab_extent(cfg, mesh)
    target = shard_rows(torch.as_tensor(target, dtype=torch.float32, device=mesh.device), mesh)
    return dict(_kernel_slab(scene, cam, cfg, mesh, target, frame, ext), ext=ext)


def _kernel_loss_grads(scene, cam, cfg: RenderConfig, mesh: Mesh, target, frame, ext):
    """The kernels' route: this rank's slab launch (``_kernel_slab``), the
    loss summed over "tiles", the gradients over the grid."""
    from pathtrace_tpu_torch.ops import grad_kernel as gk
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk

    out = _kernel_slab(scene, cam, cfg, mesh, target, frame, ext)
    denom = cfg.height * cfg.width * 3
    diff = out["diff"]
    loss = all_reduce(torch.sum(diff * diff), mesh, ("tiles",)) / denom
    if out["route"] == "chain":
        d_e, d_c = gk.contract(2.0 * diff / denom * out["scale"], out["acc"])
        g = all_reduce(torch.cat([d_e, d_c], dim=1), mesh, AXES)
        return loss, _zero_geometry(scene, cam, g[:, 0:3], g[:, 3:6], mesh.device)
    block = all_reduce(out["block"], mesh, AXES)
    return loss, nk.grads_from_block(scene, cam, cfg, block)


def _autograd_loss_grads(scene, cam, cfg: RenderConfig, mesh: Mesh, target, frame, ext):
    """The wavefront's route (``shard_fn``): autograd of the slab's partial
    colour sums against the hand-made cotangent 2 diff / (H W 3 spp), taken
    from the colour summed over "samples"; the gradients are all-reduced
    over the grid. The differentiated region holds no collective."""
    from pathtrace_tpu_torch.grad import CAMERA_FIELDS, SCENE_FIELDS

    dev = mesh.device
    scene_leaves = [getattr(scene, k).detach().to(dev).requires_grad_(True)
                    for k in SCENE_FIELDS]
    cam_leaves = [getattr(cam, k).detach().to(dev).requires_grad_(True)
                  for k in CAMERA_FIELDS]
    with torch.enable_grad():
        sums, _ = accumulate_frame(Scene(*scene_leaves), Camera(*cam_leaves), cfg, frame,
                                   **ext)
        partial = sums["color"]
    color = all_reduce(partial.detach(), mesh, ("samples",)) / cfg.spp
    diff = color - target
    denom = cfg.height * cfg.width * 3
    loss = all_reduce(torch.sum(diff * diff), mesh, ("tiles",)) / denom
    leaves = scene_leaves + cam_leaves
    grads = torch.autograd.grad(partial, leaves, grad_outputs=(2.0 / (denom * cfg.spp)) * diff,
                                allow_unused=True)
    grads = [all_reduce(torch.zeros_like(x) if g is None else g, mesh, AXES)
             for x, g in zip(leaves, grads)]
    return loss, (Scene(*grads[:4]), Camera(*grads[4:]))


def sharded_loss_grads(scene, cam, cfg: RenderConfig, mesh: Mesh, target, frame=0):
    """(loss, (d_scene, d_camera)) of the global mean-squared pixel loss
    against ``target`` [H, W, 3] (this rank takes its rows), computed over
    the grid; every rank returns the same values. ``"cuda"``: the kernels'
    slab launches; ``"torch"``: autograd through the wavefront."""
    ext = slab_extent(cfg, mesh)
    target = shard_rows(torch.as_tensor(target, dtype=torch.float32, device=mesh.device), mesh)
    if resolve_backend(cfg, mesh.device) == "cuda":
        return _kernel_loss_grads(scene, cam, cfg, mesh, target, frame, ext)
    return _autograd_loss_grads(scene, cam, cfg, mesh, target, frame, ext)
