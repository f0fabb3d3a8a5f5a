"""AOV preprocessing for the denoise CNN.

The counterpart of ``pathtrace_tpu.models.preprocess``, which is the
reference's normalisation (``denoise_cnn/load_data.py:21-30``,
``denoise_cnn/train.py:50-55``):

  epsilon = 0.00316
  color      /= epsilon + albedo          (albedo divide; skipped for targets)
  depth      /= epsilon + max(depth)
  {color,normal,albedo,depth}_var /= epsilon + max(of that channel)

Targets keep only clip(color, 0, 1) (``load_data.py:32-35``).

Operates on the packed [..., H, W, 14] buffer (``config.CHANNEL_NAMES``);
the maxima reduce over each image's own spatial dimensions, never over a
batch.
"""

from __future__ import annotations

import torch

EPSILON = 0.00316


def preprocess_channels(buf: torch.Tensor) -> torch.Tensor:
    """Normalise a packed [..., H, W, 14] buffer for CNN input."""
    color = buf[..., 0:3]
    normal = buf[..., 3:6]
    albedo = buf[..., 6:9]
    depth = buf[..., 9:10]
    variances = buf[..., 10:14]

    color = color / (EPSILON + albedo)
    spatial = (buf.dim() - 3, buf.dim() - 2)
    depth = depth / (EPSILON + torch.amax(depth, dim=spatial + (-1,), keepdim=True))
    variances = variances / (EPSILON + torch.amax(variances, dim=spatial, keepdim=True))
    return torch.cat([color, normal, albedo, depth, variances], dim=-1)


def preprocess_target(buf: torch.Tensor) -> torch.Tensor:
    """Ground-truth target: clipped colour only ([..., H, W, 3])."""
    return torch.clamp(buf[..., 0:3], 0.0, 1.0)
