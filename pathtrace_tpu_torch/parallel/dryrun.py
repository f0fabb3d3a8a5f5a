"""The multi-device dry run of the port: one sharded render and one sharded
loss+gradients step on a (n/2, 2) grid, then one batch-data-parallel
training step of the denoiser over the same ranks.

The counterpart of ``__graft_entry__.dryrun_multichip`` (which stays the
JAX package's): the renderer's two axes, row slabs ("tiles") and sample
ranges ("samples"), with the partials folded over "samples" and the
gradients all-reduced over the grid, through the kernels' slab launches
(``backend="cuda"``; on the CPU their plain versions); then
``train.dryrun_cnn_dp``, the batch split with BatchNorm's statistics and
the gradients all-reduced over every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pathtrace_tpu_torch.parallel.launch import launch


def _dryrun_rank(device=None) -> dict:
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch.parallel.mesh import make_mesh
    from pathtrace_tpu_torch.parallel.shard import render_channels_sharded, sharded_loss_grads
    from pathtrace_tpu_torch.train import dryrun_cnn_dp

    n = dist.get_world_size()
    samples = 2 if n % 2 == 0 else 1
    tiles = n // samples
    mesh = make_mesh(tiles=tiles, samples=samples, device=device)
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=32, height=8 * tiles, spp=2 * samples, backend="cuda",
                       max_bounces=2)

    out = render_channels_sharded(scene, cam, cfg, mesh)
    if tuple(out.shape) != (cfg.height, cfg.width, 14) or not torch.isfinite(out).all():
        raise RuntimeError(f"sharded render gave {tuple(out.shape)} or non-finite values")

    target = torch.zeros((cfg.height, cfg.width, 3))
    loss, (d_scene, _) = sharded_loss_grads(scene, cam, cfg, mesh, target)
    if not torch.isfinite(loss):
        raise RuntimeError(f"sharded loss {float(loss)} is not finite")

    # NEE: the colour sums, then the NEE replay; geometry gradients too.
    cfg_n = dataclasses.replace(cfg, nee=True)
    loss_n, (ds_n, _) = sharded_loss_grads(scene, cam, cfg_n, mesh, target)
    if not (torch.isfinite(loss_n) and torch.isfinite(ds_n.position).all()):
        raise RuntimeError("sharded NEE loss or position gradient is not finite")
    return {"rank": dist.get_rank(), "mesh": dict(mesh.shape), "frame_shape": tuple(out.shape),
            "loss": float(loss), "loss_nee": float(loss_n),
            "d_color": d_scene.color.detach().cpu(), "loss_cnn_dp": dryrun_cnn_dp(mesh)}


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run the dry run on a local world of ``n_devices`` ranks (``device``
    None: the card; ``"cpu"``) -> what each rank returned; raises with the
    failing rank's traceback."""
    return launch(_dryrun_rank, n_devices, device=device)
