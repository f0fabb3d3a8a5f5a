"""Interactive frame loop, headless.

The counterpart of ``pathtrace_tpu.interactive``. The reference's
interactive mode (``src/main.cu:141-177``) is a GLFW window: WASD moves the
camera (``Window.h:133-147``), TAB toggles the CNN denoiser live
(``Window.h:168-169``), and a 'denoise' kernel packs clamped RGB for display
(``src/denoise.cu``). Here ``FrameStepper`` (``camera, frame -> display
RGB``) has the same controls as an API (``move``/``look``/
``toggle_denoising``) and drives the frame writer ``run_interactive`` or the
browser viewer (``viewer.py``). Frames render on the card through the
forward kernel; the denoiser runs on the same device (``models/infer.py``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.io.bmp import write_bmp
from pathtrace_tpu_torch.models.infer import denoise_channels
from pathtrace_tpu_torch.progressive import ProgressiveRenderer
from pathtrace_tpu_torch.render import pack_channels, render_aovs, resolve_device
from pathtrace_tpu_torch.utils.metrics import JsonlLogger
from pathtrace_tpu_torch.utils.timing import span


def to_display(color: torch.Tensor) -> torch.Tensor:
    """Clamp [H, W, 3] float colour to [0, 1] and pack to uint8
    (denoise.cu:17-23)."""
    return (torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)


class FrameStepper:
    """Stateful interactive session: camera + denoising toggle + frame
    counter, on ``device`` (default: the current CUDA device). ``step()``
    renders one frame and returns display RGB uint8 [H, W, 3].

    With ``progressive=True`` (the viewer's mode) a still camera converges:
    each idle step accumulates more samples into the running Welford partials
    (``progressive.ProgressiveRenderer``), in batches that double up to 512,
    until ``max_spp``; any camera motion restarts the accumulation at
    ``cfg.spp`` on a new frame index."""

    # Progressive-denoise fade (``step``): the CNN dominates while the
    # accumulated mean's per-pixel luma std is above denoise_fade_std, and
    # for the first denoise_fade_spp samples whatever the sampled variance
    # (a 2-sample pixel whose samples agree proves nothing about its error).
    denoise_fade_std = 0.05
    denoise_fade_spp = 16.0

    def __init__(self, scene, camera: Camera, cfg: RenderConfig, denoising: bool = False,
                 checkpoint: Optional[str] = None, progressive: bool = False,
                 max_spp: int = 16384, device=None):
        self.device = resolve_device(device)
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.denoising = denoising
        self.checkpoint = checkpoint
        self.progressive = progressive
        self.max_spp = max_spp
        self.frame = 0
        self.last_ms = float("nan")
        self._prog = None
        self._moved = True

    @property
    def spp_accumulated(self) -> int:
        """Samples currently in the displayed image (HUD)."""
        if self.progressive and self._prog is not None:
            return self._prog.samples_done
        return self.cfg.spp

    # -- control semantics (Window.h key handling) -------------------------
    def move(self, direction: str, delta_time: float = 1.0 / 60.0):
        """WASD: forward/backward/left/right."""
        self.camera = self.camera.move(direction, delta_time)
        self._moved = True

    def look(self, dx: float, dy: float):
        self.camera = self.camera.look(dx, dy)
        self._moved = True

    def toggle_denoising(self):
        """TAB (Window.h:168-169). Does not reset the accumulator: it only
        switches the display path."""
        self.denoising = not self.denoising

    # -- frame step --------------------------------------------------------
    def _step_aovs(self):
        if not self.progressive:
            return render_aovs(self.scene, self.camera, self.cfg, self.frame, self.device)
        if self._moved or self._prog is None:
            # Camera moved: restart on a fresh frame index (the lattice key).
            self._prog = ProgressiveRenderer(self.scene, self.camera, self.cfg, self.frame,
                                             self.device)
            self._moved = False
            self._prog.accumulate(max(self.cfg.spp, 1))
        elif self._prog.samples_done < self.max_spp:
            # Idle: refine, doubling the batch up to 512.
            batch = min(max(self._prog.samples_done, self.cfg.spp, 1), 512)
            self._prog.accumulate(min(batch, self.max_spp - self._prog.samples_done))
        return self._prog.aovs()

    def step(self) -> np.ndarray:
        """One frame, in the spans ``frame`` (the call), ``frame.render``,
        ``frame.denoise`` (with the fade) and ``frame.display``."""
        with span("frame"):
            t0 = time.perf_counter()
            with span("frame.render"):
                aovs = self._step_aovs()
            if self.denoising and self.checkpoint:
                with span("frame.denoise"):
                    color = denoise_channels(pack_channels(aovs), self.checkpoint)
                    if self.progressive and self._prog is not None:
                        # Denoise while converging: w * CNN + (1 - w) * accumulation,
                        # w = clip(max(sqrt(max(var, 0) / n) / fade_std, fade_spp / n), 0, 1)
                        # per pixel (pathtrace_tpu/interactive.py:117-159).
                        n = float(max(self._prog.samples_done, 1))
                        std_mean = torch.sqrt(torch.clamp(aovs["color_var"], min=0.0) / n)
                        w = torch.clamp(torch.clamp(std_mean / self.denoise_fade_std,
                                                    min=self.denoise_fade_spp / n),
                                        0.0, 1.0)[..., None]
                        color = w * color + (1.0 - w) * aovs["color"]
            else:
                color = aovs["color"]
            with span("frame.display"):
                rgb = to_display(color).cpu().numpy()  # the copy waits for the card
            self.last_ms = (time.perf_counter() - t0) * 1000.0
            self.frame += 1
        return rgb


def run_interactive(scene, camera: Camera, cfg: RenderConfig, denoising: bool = False,
                    max_frames: int = 0, checkpoint: Optional[str] = None,
                    out_dir: str = "output/frames", script=None, logger=print,
                    metrics_path: Optional[str] = None, device=None):
    """Headless interactive loop: renders frames along a camera script
    (default: a slow strafe and look, the WASD and mouse paths), writes each
    frame as a BMP, prints per-frame ms/fps like the reference's render loop,
    and optionally appends a per-frame JSONL record. Ctrl-C or
    ``max_frames`` ends the session."""
    stepper = FrameStepper(scene, camera, cfg, denoising, checkpoint, device=device)
    os.makedirs(out_dir, exist_ok=True)
    n = max_frames if max_frames > 0 else 10_000_000
    metrics = JsonlLogger(metrics_path)
    try:
        for i in range(n):
            if script is not None:
                script(stepper, i)
            else:
                stepper.move("right", 1.0 / 120.0)
                stepper.look(0.05, 0.0)
            rgb = stepper.step()
            write_bmp(os.path.join(out_dir, f"frame_{i:05d}.bmp"), rgb)
            fps = 1000.0 / max(stepper.last_ms, 1e-9)
            logger(f"frame {i}: {stepper.last_ms:.2f}ms ({fps:.1f} fps)"
                   + (" [denoised]" if stepper.denoising else ""))
            metrics.log("frame", frame=i, ms=stepper.last_ms, fps=fps,
                        denoised=stepper.denoising)
    except KeyboardInterrupt:
        logger("interrupted")
    finally:
        metrics.close()
    return stepper
