"""Training-data collection: render noisy/ground-truth pairs in-process.

The counterpart of ``pathtrace_tpu.data.collect``. The reference shells out
to the renderer binary per camera pose and round-trips through EXR files
(``collect_data.py:17-43``: 2 spp '_train' + 20,000 spp '_gt' per pose).
Here the renderer is a library call: pairs are rendered in-process on the
device (K1 on a card, ``backend="auto"``) and handed to the trainer as
arrays. EXR export remains available for interop (``save_dir``), with the
reference's file names ``{i}_train.exr`` / ``{i}_gt.exr``.

``random_pose`` keeps the reference's (unused) sampling ranges
(``collect_data.py:8-14``): x in [0,90], y in [0,175], z in [0,500],
yaw in [0,360], pitch in [-89,89].

The ground truth is ``render_aovs`` at ``spp_gt`` with ``spp_chunk =
min(spp_gt, 64)`` and ``seed + 1``, as in the JAX package. The kernel route
traces all ``spp_gt`` samples in one launch and ignores ``spp_chunk``; the
plain route traces chunks and merges them, so the two sum in another order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.render import pack_channels, render_aovs, resolve_device


def random_pose(rng: np.random.Generator) -> Tuple[float, float, float, float, float]:
    return (
        float(rng.uniform(0, 90)),
        float(rng.uniform(0, 175)),
        float(rng.uniform(0, 500)),
        float(rng.uniform(0, 360)),
        float(rng.uniform(-89, 89)),
    )


def render_pair(
    scene,
    pose: Sequence[float],
    cfg: RenderConfig,
    spp_train: int = 2,
    spp_gt: int = 512,
    frame: int = 0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (noisy, ground-truth) packed channel pair [H, W, 14] on the host for
    a camera pose (x, y, z, yaw, pitch), rendered on ``device`` (default: the
    current CUDA device). spp_gt defaults far below the reference's offline
    20,000; pass 20000 for parity."""
    device = resolve_device(device)
    x, y, z, yaw, pitch = pose
    cam = Camera.create(position=(x, y, z), yaw=yaw, pitch=pitch)
    train_cfg = dataclasses.replace(cfg, spp=spp_train)
    gt_cfg = dataclasses.replace(
        cfg, spp=spp_gt, spp_chunk=min(spp_gt, 64), seed=cfg.seed + 1
    )
    noisy = pack_channels(render_aovs(scene, cam, train_cfg, frame, device))
    gt = pack_channels(render_aovs(scene, cam, gt_cfg, frame, device))
    return noisy.cpu().numpy(), gt.cpu().numpy()


def collect_dataset(
    scene,
    poses: Sequence[Sequence[float]],
    cfg: RenderConfig,
    spp_train: int = 2,
    spp_gt: int = 512,
    save_dir: Optional[str] = None,
    device=None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Render pairs for every pose on ``device``; optionally export
    reference-style EXRs."""
    device = resolve_device(device)
    noisies, gts = [], []
    for i, pose in enumerate(poses):
        noisy, gt = render_pair(scene, pose, cfg, spp_train, spp_gt, frame=i, device=device)
        noisies.append(noisy)
        gts.append(gt)
        if save_dir:
            from pathtrace_tpu_torch.io import save_aovs_exr
            from pathtrace_tpu_torch.render import unpack_channels

            os.makedirs(save_dir, exist_ok=True)
            save_aovs_exr(os.path.join(save_dir, f"{i}_train.exr"), unpack_channels(noisy))
            save_aovs_exr(os.path.join(save_dir, f"{i}_gt.exr"), unpack_channels(gt))
    return noisies, gts


def load_poses(path: str) -> np.ndarray:
    """Camera-pose list file (whitespace table, one pose per row) — the
    ``--list`` input of collect_data.py:28."""
    return np.loadtxt(path, ndmin=2)


def main(argv=None) -> int:
    """CLI parity with the reference's collect_data.py (flags
    ``--list/--samples-train/--samples-gt``, ``data/`` output layout) —
    minus its subprocess spawning: rendering happens in-process. ``--device``
    takes a CUDA device index (default 0) or ``cpu``."""
    import argparse
    import sys

    from pathtrace_tpu_torch.cli import device_arg, resolve_device_arg
    from pathtrace_tpu_torch.scene import cornell_box

    p = argparse.ArgumentParser(description="Collect denoiser training data")
    p.add_argument("--list", type=str, required=True,
                   help="File with list of camera positions to render")
    p.add_argument("--samples-train", type=int, default=2,
                   help="Samples per pixel for training images")
    p.add_argument("--samples-gt", type=int, default=20000,
                   help="Samples per pixel for ground truth images")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", type=str, default="data")
    p.add_argument("--device", type=device_arg, default=0,
                   help="CUDA device index to render on, or 'cpu'")
    args = p.parse_args(argv)
    device, err = resolve_device_arg(args.device)
    if err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1

    poses = load_poses(args.list)
    cfg = RenderConfig(width=args.size, height=args.size, spp=2, backend="auto")
    collect_dataset(
        cornell_box(),
        [tuple(map(float, row)) for row in poses],
        cfg,
        spp_train=args.samples_train,
        spp_gt=args.samples_gt,
        save_dir=args.out,
        device=device,
    )
    print(f"wrote {len(poses)} train/gt EXR pairs to {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
