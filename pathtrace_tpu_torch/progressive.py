"""Progressive rendering: resumable high-spp accumulation.

The counterpart of ``pathtrace_tpu.progressive``. Sample batches are keyed
by their global sample offsets on the counter-based lattice, so "resume" is
re-keying: batches render samples [done, done + spp) of one frame, their
sums add and their Welford moments merge with Chan's formula
(``ops/variance.merge_moments``), and the running partials can be written to
disk between batches.

On ``"cuda"`` a batch is one launch of the forward kernel in its 22-channel
partials mode (``ops/trace_kernel.accumulate_frame_kernel``), for every
configuration (the JAX class sends only diffuse to its kernel); on
``"torch"`` it is the plain wavefront (``render.accumulate_frame``). N
batches equal one render of all their samples up to the reassociation of
the float sums (the 1e-3 rule of tests/test_progressive.py); the kernel
route equals the kernel's plain version on the same batches to the bit.

Also the building block of interactive progressive refinement
(``interactive.FrameStepper``): accumulate until the camera moves.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import trace_kernel
from pathtrace_tpu_torch.ops.variance import Moments, merge_moments
from pathtrace_tpu_torch.render import (accumulate_frame, finalize_aovs, resolve_backend,
                                        resolve_device)


def merge_partials(sums, moments, new_sums, new_moments):
    """(sums, moments) of two disjoint sample ranges -> those of their union."""
    merged_sums = {k: sums[k] + new_sums[k] for k in sums}
    merged_moments = {k: merge_moments(moments[k], new_moments[k]) for k in moments}
    return merged_sums, merged_moments


class ProgressiveRenderer:
    """Accumulates spp batches for one (scene, camera, frame) into running
    (sums, moments) partials on ``device`` (default: the current CUDA
    device); ``aovs()`` finalises at any time."""

    def __init__(self, scene, cam, cfg: RenderConfig, frame: int = 0, device=None):
        self.device = resolve_device(device)
        self.scene = scene
        self.cam = cam
        self.cfg = cfg
        self.frame = frame
        self.samples_done = 0
        self._sums = None
        self._moments = None

    def accumulate(self, spp: int) -> "ProgressiveRenderer":
        """Trace ``spp`` more samples (global offsets continue where the last
        batch ended: the lattice of a monolithic render). The jitter decision
        is the configuration's, whatever the batch size."""
        cfg = dataclasses.replace(self.cfg, spp=max(self.cfg.spp, 1))
        if resolve_backend(cfg, self.device) == "cuda":
            sums, moments = trace_kernel.accumulate_frame_kernel(
                self.scene, self.cam, cfg, self.frame, spp=spp,
                sample_offset=self.samples_done, device=self.device)
        else:
            sums, moments = accumulate_frame(
                self.scene.to(self.device), self.cam.to(self.device), cfg, self.frame,
                spp=spp, sample_offset=self.samples_done)
        if self._sums is None:
            self._sums, self._moments = sums, moments
        else:
            self._sums, self._moments = merge_partials(self._sums, self._moments, sums, moments)
        self.samples_done += spp
        return self

    def aovs(self) -> Dict[str, torch.Tensor]:
        if self._sums is None:
            raise ValueError("no samples accumulated yet")
        return finalize_aovs(self._sums, self._moments, self.samples_done)

    # -- persistence --------------------------------------------------------
    def save(self, path: str):
        """Persist the running partials (crash-safe ground-truth rendering).
        The keys are the JAX package's, but a file is not exchangeable
        between the packages: ``cfg`` holds ``tile_shape`` there and
        ``block`` here."""
        state = {
            "samples_done": self.samples_done,
            "frame": self.frame,
            "cfg": dataclasses.asdict(self.cfg),
            "sums": {k: v.detach().cpu().numpy() for k, v in (self._sums or {}).items()},
            "moments": {k: tuple(x.detach().cpu().numpy() for x in m)
                        for k, m in (self._moments or {}).items()},
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, scene, cam, device=None) -> "ProgressiveRenderer":
        """A renderer from a file ``save`` wrote (only such a file: unpickling
        runs code)."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        self = cls(scene, cam, RenderConfig(**state["cfg"]), state["frame"], device)
        self.samples_done = state["samples_done"]
        if state["sums"]:
            self._sums = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                          for k, v in state["sums"].items()}
            self._moments = {k: Moments(*(torch.from_numpy(np.asarray(x)).to(self.device)
                                          for x in m))
                             for k, m in state["moments"].items()}
        return self


def render_high_spp(scene, cam, cfg: RenderConfig, total_spp: int, batch_spp: int = 64,
                    checkpoint_path: Optional[str] = None, frame: int = 0, logger=None,
                    device=None) -> Dict[str, torch.Tensor]:
    """Ground-truth renderer: accumulate ``total_spp`` in batches, resuming
    from ``checkpoint_path`` if present (the reference's 20,000-spp frames at
    bounded memory)."""
    if checkpoint_path and os.path.exists(checkpoint_path):
        prog = ProgressiveRenderer.load(checkpoint_path, scene, cam, device)
    else:
        prog = ProgressiveRenderer(scene, cam, cfg, frame, device)
    while prog.samples_done < total_spp:
        step = min(batch_spp, total_spp - prog.samples_done)
        prog.accumulate(step)
        if checkpoint_path:
            prog.save(checkpoint_path)
        if logger:
            logger(f"progressive: {prog.samples_done}/{total_spp} spp")
    return prog.aovs()
