"""Render configuration.

The same fields and defaults as ``pathtrace_tpu.config.RenderConfig``
(the reference's ``src/main.cu:20-46`` flags): size 512, 4 spp, 5 bounces.
The reference's ``--threads-per-block`` is the CUDA block edge again
(``block``), as it was in the CUDA reference (``Renderer.h:29-33``).
"""

from __future__ import annotations

import dataclasses

# MAX_BOUNCES and PUSH_RAY_ORIGIN mirror reference src/pathtrace.cu:7-8.
MAX_BOUNCES = 5
PUSH_RAY_ORIGIN = 0.05
BACKENDS = ("auto", "torch", "cuda")
BRDFS = ("diffuse", "glossy")
# The largest block edge, in pixels: the kernels are compiled with
# __launch_bounds__ of MAX_BLOCK**2 = 256 threads (csrc/common.cuh), and a
# block of K1 or K2 takes as many sample lanes a pixel as fit in them
# (ops/trace_kernel.py::sample_lanes), so any block up to it launches.
MAX_BLOCK = 16
# Channel count of the AOV feature buffer (reference include/OutputBuffer.h).
NUM_CHANNELS = 14
# Channel layout of the packed feature buffer, the reference's buffer writes
# (src/pathtrace.cu:240-254), as pathtrace_tpu.config.CHANNEL_NAMES.
CHANNEL_NAMES = (
    "color_r", "color_g", "color_b",
    "normal_x", "normal_y", "normal_z",
    "albedo_r", "albedo_g", "albedo_b",
    "depth",
    "color_var", "normal_var", "albedo_var", "depth_var",
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of a render.

    Attributes:
      width, height: image size in pixels.
      spp: samples per pixel (reference ``--samples``, default 4).
      max_bounces: path depth (5 in the reference).
      spp_chunk: the ``"torch"`` backend traces samples in chunks of this
        size and merges their moments (Chan's formula); 0 means one chunk.
      backend: ``"cuda"`` (the hand-written kernel), ``"torch"`` (the
        plain wavefront), or ``"auto"`` (``"cuda"`` on a CUDA device,
        ``"torch"`` on the CPU).
      jitter: sub-pixel jitter; None jitters iff spp != 1 as the reference.
      seed: RNG seed of the counter-based lattice (``rng.py``).
      block: edge of the kernel's square CUDA thread block (1..MAX_BLOCK).
      nee, light_index: next-event estimation toward sphere ``light_index``.
      brdf: ``"diffuse"`` or the reference's ``"glossy"`` experiment.
    """

    width: int = 512
    height: int = 512
    spp: int = 4
    max_bounces: int = MAX_BOUNCES
    spp_chunk: int = 0
    backend: str = "auto"
    jitter: bool | None = None
    seed: int = 0
    push_ray_origin: float = PUSH_RAY_ORIGIN
    block: int = 8
    nee: bool = False
    light_index: int = 8
    brdf: str = "diffuse"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.brdf not in BRDFS:
            raise ValueError(f"brdf must be one of {BRDFS}, got {self.brdf!r}")

    @property
    def slots_per_bounce(self) -> int:
        return 5 if self.brdf == "glossy" else 2

    @property
    def resolved_jitter(self) -> bool:
        if self.jitter is None:
            return self.spp != 1
        return self.jitter

    def chunks(self, total: int | None = None) -> list[int]:
        """Split ``total`` (default ``spp``) samples into chunk sizes."""
        total = self.spp if total is None else total
        if self.spp_chunk <= 0 or self.spp_chunk >= total:
            return [total]
        n_full, rem = divmod(total, self.spp_chunk)
        return [self.spp_chunk] * n_full + ([rem] if rem else [])
