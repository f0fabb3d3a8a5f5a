"""Command-line interface: the single-frame render.

The reference's flag names, short options and defaults (``src/main.cu:
20-46``, as in ``pathtrace_tpu.cli``): size 512, 4 samples, camera
(50, 52, 295.6) yaw -90 pitch 0, output ``output/out``. It renders one
frame, prints ``Render completed in Xms (Y fps)`` and writes an EXR plus 8
bitmaps (``--nobitmap`` drops the bitmaps). ``--threads-per-block`` is the
kernel's CUDA block edge. ``--device`` takes a CUDA device index (default
0) or ``cpu``: with no CUDA device the CLI exits with an error unless
``--device cpu`` is given. The denoiser (``-d``), the interactive mode
(``-i``) and the viewer are not ported yet and exit with an error.

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


def _device_arg(value: str):
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
    p.add_argument("--device", type=_device_arg, default=0,
                   help="CUDA device index to render on, or 'cpu'")
    p.add_argument("-d", "--denoising", action="store_true",
                   help="Use denoising neural network (not ported yet).")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="Interactive mode (not ported yet).")
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
    p.add_argument("--viewer", action="store_true", help="Live browser viewer (not ported yet)")
    p.add_argument("--exr-compression", choices=["none", "zips", "zip"], default="zip")
    return p


def _resolve_device(arg):
    """torch.device for --device, or an error message."""
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
    for flag, on in (("--denoising", args.denoising), ("--interactive", args.interactive),
                     ("--viewer", args.viewer)):
        if on:
            print(f"ERROR: {flag} is not ported yet", file=sys.stderr)
            return 2
    device, err = _resolve_device(args.device)
    if err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1

    width = height = args.size
    print("pathtrace-torch 0.1")
    print("------------------")
    print(f"Dimensions: {width} x {height}")
    print(f"Samples per pixel: {args.samples}")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Using device: {device} ({name})")
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

    # The first call builds the kernel (once per source change) and warms up.
    first_ms, _ = _render_ms(lambda: render_aovs(scene, cam, cfg, 0, device), device)
    render_ms, aovs = _render_ms(lambda: render_aovs(scene, cam, cfg, 1, device), device)
    print(f"Render completed in {render_ms:.3f}ms ({1000.0 / render_ms:.1f} fps)"
          f" [first call incl. build: {first_ms:.0f}ms]")
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
