"""Evaluate a denoiser checkpoint of the PyTorch port on the held-out validation frame.

The port of scripts/eval_checkpoint.py. Renders the validation pair at the
reference's default pose (a --spp-train noisy input and a --spp-gt ground
truth, frame 10000 as the trainer's validation pair, the
``collect_data.py:21-22`` workload), runs the checkpoint's ``DenoiseCNN``
(``train.load_checkpoint``; f32, TF32 off) and prints both PSNR conventions
side by side:

- the trainer's formula 10 log10(1 / L1) (the reference's own quirk,
  ``denoise_cnn/train.py:43``), and
- the standard MSE PSNR.

Writes ``PREFIX_{noisy,denoised,gt}.png`` only where ``--out-prefix`` is
given. A checkpoint directory is what ``train.save_checkpoint`` writes
(``model.json`` and ``model_epoch.pt`` / ``model_best.pt``).

Usage, from the root of a checkout:

    python scripts/torch_eval_checkpoint.py RUN_DIR [--size 512] [--spp-gt 20000]
        [--snapshot model_best|model_epoch] [--out-prefix PREFIX] [--device cpu|0]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def psnrs(pred, gt):
    """(10 log10(1 / L1), 10 log10(1 / MSE)) of images clipped to [0, 1]."""
    pred = np.clip(np.asarray(pred, np.float64), 0, 1)
    gt = np.clip(np.asarray(gt, np.float64), 0, 1)
    l1 = np.abs(pred - gt).mean()
    mse = ((pred - gt) ** 2).mean()
    return 10 * np.log10(1.0 / max(l1, 1e-12)), 10 * np.log10(1.0 / max(mse, 1e-12))


def main(argv=None) -> int:
    import torch
    from pathtrace_tpu_torch import RenderConfig, cornell_box, train
    from pathtrace_tpu_torch.cli import device_arg, resolve_device_arg
    from pathtrace_tpu_torch.data.collect import render_pair
    from pathtrace_tpu_torch.io.png import write_png
    from pathtrace_tpu_torch.models.denoise_cnn import cudnn_tf32
    from pathtrace_tpu_torch.models.preprocess import preprocess_channels, preprocess_target

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt_dir")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp-train", type=int, default=2)
    ap.add_argument("--spp-gt", type=int, default=20000)
    ap.add_argument("--out-prefix", type=str, default=None,
                    help="Write PREFIX_{noisy,denoised,gt}.png (no files without it)")
    ap.add_argument("--snapshot", choices=["model_epoch", "model_best"], default=None,
                    help="Which snapshot to evaluate (default: model_best if present, else "
                         "model_epoch)")
    ap.add_argument("--device", type=device_arg, default=0,
                    help="CUDA device index to run on, or 'cpu'")
    args = ap.parse_args(argv)
    device, err = resolve_device_arg(args.device)
    if err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1

    cfg = RenderConfig(width=args.size, height=args.size, spp=2, backend="auto")
    noisy, gt = render_pair(cornell_box(), train.DEFAULT_POSE, cfg, spp_train=args.spp_train,
                            spp_gt=args.spp_gt, frame=train.VALIDATION_FRAME, device=device)
    gt_rgb = preprocess_target(torch.from_numpy(gt)).numpy()
    noisy_rgb = np.clip(noisy[..., 0:3], 0.0, 1.0)

    # The best-validation snapshot where the run kept one: the latest can be
    # worse (the JAX package's r4 run lost 0.6 dB to it).
    name = args.snapshot
    if name is None:
        best = os.path.isfile(train.checkpoint_file(args.ckpt_dir, "model_best"))
        name = "model_best" if best else "model_epoch"
    print(f"snapshot: {name}")
    payload = torch.load(train.checkpoint_file(args.ckpt_dir, name), map_location="cpu",
                         weights_only=True)
    model = train.load_checkpoint(args.ckpt_dir, name=name)
    model = model.to(device, memory_format=torch.channels_last).eval()
    with torch.inference_mode(), cudnn_tf32(False):
        x = preprocess_channels(torch.from_numpy(noisy).to(device))
        out = model(x[None])[0].cpu().numpy()

    epoch = payload.get("epoch")
    rows = [(f"noisy {args.spp_train}-spp input", *psnrs(noisy_rgb, gt_rgb)),
            (f"denoised (epoch {epoch})", *psnrs(out, gt_rgb))]
    print(f"checkpoint: {args.ckpt_dir} epoch={epoch} lr={payload.get('lr')} device={device}")
    print("| image | trainer PSNR (10log10(1/L1)) | MSE PSNR |")
    print("|---|---|---|")
    for label, p_l1, p_mse in rows:
        print(f"| {label} | {p_l1:.2f} dB | {p_mse:.2f} dB |")

    if args.out_prefix:
        for kind, img in (("noisy", noisy_rgb), ("denoised", out), ("gt", gt_rgb)):
            write_png(f"{args.out_prefix}_{kind}.png", img)
        print(f"wrote {args.out_prefix}_{{noisy,denoised,gt}}.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
