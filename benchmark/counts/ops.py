"""Operation counts and the peak they are divided by, frozen.

- ``OPS_PER_SEGMENT``: counted operations (f32, int32 and transcendental;
  a multiply and an add as two) of one path segment, 9 spheres, 5 bounces.
  Frozen from ``pathtrace_tpu_torch/utils/roofline.py::OPS_PER_SEGMENT``:
  K1's 568.0 and 877.8 from the jaxprs of the JAX package's kernels
  (docs/ROOFLINE.md sections 1 and 6); K3's replay 1,211.6 by
  ``scripts/torch_count_ops.py`` on the port's plain sweep (its
  ``ad_nee_color`` instance, which is the replay's).
- ``PEAK_F32``: the published f32 rate of one H100 SXM outside the tensor
  cores, 67 TFLOP/s at its 700 W limit (NVIDIA's data sheet). No path here
  uses the tensor cores: the kernels are scalar f32 and the CNN runs f32
  with TF32 off.
- ``bound_ms``: the least milliseconds of ``segments`` segments.
- ``conv_operations``: the denoiser's convolutions, counted as
  ``chip_smoke.py::cnn_operations`` counts them (2 x input channels x
  kernel area + 1 an output element; BatchNorm, ReLU, resizes and adds, under
  1% of the total, left out), on the meta device: no arithmetic is done.
- ``segments``: the segments a frame traces, by the frozen tracer: every
  sample's primary ray and one more for each bounce, but the last, whose
  path hit (``utils/roofline.py::count_segments``).
"""

from __future__ import annotations

import torch

from benchmark.reference import fpn

PEAK_F32 = 67.0e12
OPS_PER_SEGMENT = {
    "forward_diffuse": 568.0,  # K1, 14 channels (render_aovs, render_pair, the stepper)
    "color_nee": 877.8,  # K1, colour sums under NEE (the inverse step's two passes)
    "nee_replay": 1211.6,  # K3 replay (the inverse step's two replays)
}


def bound_ms(segments: float, ops_per_segment: float, peak: float = PEAK_F32) -> float:
    if peak <= 0:
        raise ValueError(f"peak must be positive, got {peak}")
    return 1e3 * segments * ops_per_segment / peak


def nominal_segments(width: int, height: int, spp: int, bounces: int) -> int:
    """W x H x spp x bounces: every path hits at every bounce (the repo's
    convention for Mrays/s)."""
    return width * height * spp * bounces


def conv_operations(batch: int, height: int, width: int, widths=fpn.WIDTHS,
                    lateral=fpn.LATERAL) -> int:
    """Operations of one forward of the denoiser on [batch, height, width, 14]."""
    params = {k: torch.empty(s, device="meta") for k, s in fpn.shapes(widths, lateral).items()}
    counter = []
    fpn.forward(params, torch.empty(batch, height, width, fpn.IN_CHANNELS, device="meta"),
                counter=counter, widths=widths)
    return int(sum(counter))


def segments(frame, spp: int, chunk: int = 8) -> int:
    """Segments ``frame`` (a ``reference.tracer.Frame``) traces at ``spp``."""
    total = 0
    with torch.no_grad():
        for first in range(0, spp, chunk):
            count = min(chunk, spp - first)
            hits = []
            frame.paths(first, count, spp != 1, hits)
            total += count * frame.rows.numel() + sum(int(h.sum()) for h in hits[:-1])
    return total
