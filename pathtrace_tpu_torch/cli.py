"""Command-line interface: the single frame, the interactive loop, the viewer.

The reference's flag names, short options and defaults (``src/main.cu:
20-46``, as in ``pathtrace_tpu.cli``): size 512, 4 samples, camera
(50, 52, 295.6) yaw -90 pitch 0, output ``output/out``. By default it
renders one frame, prints ``Render completed in Xms (Y fps)`` and writes an
EXR plus 8 bitmaps (``--nobitmap`` drops the bitmaps); ``-d`` first passes
the colour AOV through the denoise CNN of ``--checkpoint`` (a missing
checkpoint is an error). ``-i`` runs the headless frame loop for
``--frames`` frames (0: until interrupted), writing BMPs into ``frames/``
beside the ``-o`` prefix, with per-frame JSONL records to ``--metrics``;
``--viewer`` serves the browser viewer on ``--viewer-port``.
``--threads-per-block`` is the kernel's CUDA block edge. ``--device`` takes
a CUDA device index (default 0) or ``cpu``: with no CUDA device the CLI
exits with an error unless ``--device cpu`` is given.

Run as ``python -m pathtrace_tpu_torch.cli [options]``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from pathtrace_tpu_torch.config import MAX_BLOCK


def _block_arg(value: str) -> int:
    block = int(value)
    if not 1 <= block <= MAX_BLOCK:
        raise argparse.ArgumentTypeError(f"block edge must be 1..{MAX_BLOCK}, got {block}")
    return block


def device_arg(value: str):
    """``--device``'s type: a CUDA device index or ``"cpu"``."""
    if value == "cpu":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a CUDA device index or 'cpu', got {value!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtrace-torch",
        description="Path tracer in PyTorch + CUDA (port of tpu-pathtrace)",
    )
    p.add_argument("-t", "--threads-per-block", type=_block_arg, default=8,
                   help=f"Edge of the kernel's square CUDA thread block, 1..{MAX_BLOCK}: "
                        "the kernel takes up to 80 registers a thread, too many for "
                        "32x32 blocks.")
    p.add_argument("--size", type=int, default=512, help="Size of the screen in pixels")
    p.add_argument("-s", "--samples", type=int, default=4, help="Number of samples per pixel")
    p.add_argument("--device", type=device_arg, default=0,
                   help="CUDA device index to render on, or 'cpu'")
    p.add_argument("-d", "--denoising", action="store_true", help="Use denoising neural network.")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="Interactive mode - will render single frame only if not set.")
    p.add_argument("--nobitmap", action="store_true", help="Don't output bitmaps for each channel")
    p.add_argument("-o", "--output", type=str, default="output/out", help="Prefix of output file/path")
    p.add_argument("-x", "--camera-x", type=float, default=50.0, help="Starting camera position x")
    p.add_argument("-y", "--camera-y", type=float, default=52.0, help="Starting camera position y")
    p.add_argument("-z", "--camera-z", type=float, default=295.6, help="Starting camera position z")
    p.add_argument("-c", "--camera-yaw", type=float, default=-90.0, help="Starting camera view yaw")
    p.add_argument("-p", "--camera-pitch", type=float, default=0.0, help="Starting camera view pitch")
    p.add_argument("--backend", choices=["auto", "torch", "cuda"], default="auto",
                   help="Tracer: the CUDA kernel, the plain PyTorch wavefront, or "
                        "auto (the kernel on a CUDA device, the wavefront on the CPU)")
    p.add_argument("--bounces", type=int, default=5, help="Path depth (5 in the reference)")
    p.add_argument("--nee", action="store_true",
                   help="Next-event-estimation direct lighting (pathtrace.cu:138-148)")
    p.add_argument("--brdf", choices=["diffuse", "glossy"], default="diffuse",
                   help="BRDF: cosine-weighted diffuse, or the reference's glossy experiment")
    p.add_argument("--spp-chunk", type=int, default=0,
                   help="Torch backend: trace spp in chunks of this size (bounds memory)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--frames", type=int, default=0,
                   help="Interactive mode: stop after N frames (0 = until interrupted)")
    p.add_argument("--viewer", action="store_true",
                   help="Serve a live browser viewer (WASD/mouse/TAB, the reference's GLFW "
                        "window, Window.h:16-193) instead of the headless frame writer")
    p.add_argument("--viewer-port", type=int, default=8764)
    p.add_argument("--metrics", type=str, default=None,
                   help="Append per-frame JSONL metrics to this file (interactive mode)")
    p.add_argument("--checkpoint", type=str, default="denoise_cnn_ckpt",
                   help="Denoise-CNN checkpoint directory (for --denoising)")
    p.add_argument("--exr-compression", choices=["none", "zips", "zip"], default="zip")
    return p


def resolve_device_arg(arg):
    """(torch.device, None) for ``--device``'s value, or (None, an error
    message) where it names no device that exists."""
    if arg == "cpu":
        return torch.device("cpu"), None
    if not torch.cuda.is_available():
        return None, "no CUDA device available; pass --device cpu to render on the CPU"
    if arg >= torch.cuda.device_count():
        return None, f"device {arg} out of range ({torch.cuda.device_count()} available)"
    return torch.device("cuda", arg), None


def _render_ms(render, device):
    """(milliseconds, result) of one render: CUDA events on a card, the
    host clock on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = render()
            end.record()
            end.synchronize()
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = render()
    return (time.perf_counter() - t0) * 1000.0, out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device, err = resolve_device_arg(args.device)
    if err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1
    if args.denoising:
        from pathtrace_tpu_torch.models.infer import load_pretrained

        try:  # loads the model once, outside the timed render
            load_pretrained(args.checkpoint, device)
        except FileNotFoundError as e:
            print(f"ERROR: no denoiser checkpoint in {args.checkpoint!r} ({e.strerror}: "
                  f"{e.filename})", file=sys.stderr)
            return 1

    width = height = args.size
    print("pathtrace-torch 0.1")
    print("------------------")
    print(f"Dimensions: {width} x {height}")
    print(f"Samples per pixel: {args.samples}")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Using device: {device} ({name})")
    if args.interactive or args.viewer:
        print("Running in interactive mode: "
              + ("denoising is on" if args.denoising else "denoising is off"))
    else:
        print(f"Output file prefix: {args.output}")
    print(f"Camera: {args.camera_x} {args.camera_y} {args.camera_z} "
          f"{args.camera_yaw} {args.camera_pitch}")

    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch.io import save_aovs_bitmaps, save_aovs_exr
    from pathtrace_tpu_torch.render import render_aovs

    cfg = RenderConfig(
        width=width, height=height, spp=args.samples, max_bounces=args.bounces,
        spp_chunk=args.spp_chunk, backend=args.backend, seed=args.seed,
        brdf=args.brdf, nee=args.nee, block=args.threads_per_block,
    )
    # Scene and camera stay on the host: render_aovs moves them where the
    # backend reads them (the kernel takes them by value).
    scene = cornell_box()
    cam = Camera.create(position=(args.camera_x, args.camera_y, args.camera_z),
                        yaw=args.camera_yaw, pitch=args.camera_pitch)

    if args.viewer:
        from pathtrace_tpu_torch.viewer import serve

        serve(scene, cam, cfg, denoising=args.denoising, checkpoint=args.checkpoint,
              port=args.viewer_port, device=device)
        return 0
    if args.interactive:
        from pathtrace_tpu_torch.interactive import run_interactive

        run_interactive(scene, cam, cfg, denoising=args.denoising, max_frames=args.frames,
                        checkpoint=args.checkpoint,
                        out_dir=os.path.join(os.path.dirname(args.output), "frames"),
                        metrics_path=args.metrics, device=device)
        return 0

    # The first call builds the kernel (once per source change) and warms up.
    first_ms, _ = _render_ms(lambda: render_aovs(scene, cam, cfg, 0, device), device)
    render_ms, aovs = _render_ms(lambda: render_aovs(scene, cam, cfg, 1, device), device)
    print(f"Render completed in {render_ms:.3f}ms ({1000.0 / render_ms:.1f} fps)"
          f" [first call incl. build: {first_ms:.0f}ms]")
    if args.denoising:
        from pathtrace_tpu_torch.models.infer import denoise_aovs

        denoise_ms, color = _render_ms(lambda: denoise_aovs(aovs, args.checkpoint), device)
        aovs = dict(aovs, color=color)
        print(f"Denoise completed in {denoise_ms:.3f}ms")
    print()

    aovs = {k: np.asarray(v.detach().cpu()) for k, v in aovs.items()}
    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    save_aovs_exr(args.output + ".exr", aovs, compression=args.exr_compression)
    if not args.nobitmap:
        save_aovs_bitmaps(args.output, aovs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
