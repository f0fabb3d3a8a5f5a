"""Denoising CNN: residual encoder + FPN-style top-down refinement.

The counterpart of ``pathtrace_tpu.models.denoise_cnn`` (the reference's
``denoise_cnn/model.py:33-119``) in ``torch.nn``; its convolutions go to
cuDNN on a CUDA device:

- 6 stride-2 ``ResidualBlock``s 14->32->64->128->256->512->1024; each block
  is conv3x3/s2 -> relu -> BN -> conv3x3/s1 -> relu -> BN plus a
  conv3x3/s2 -> relu -> BN residual branch (conv before relu before BN, as
  the reference orders them).
- FPN top-down pass: 1x1 lateral convs to 32 channels, a 3x3/s2 'backwards'
  conv, then bilinear upsample-and-add down to the input resolution.
- head: 3x3 conv to RGB; output = clip(rgb * (0.00316 + albedo), 0, 1).
  In training the clip is ``ops.sampling.clip01``, whose gradient is 1/2
  at an exact 0 or 1 as ``jnp.clip``'s under ``jax.grad`` (``torch.clamp``
  passes it whole); out of training it is ``torch.clamp``, the same values.

Submodules carry the Flax tree's names (``block1..6`` holding ``Conv_0..2``
and ``BatchNorm_0..2``, ``lat_0..6``, ``backwards_65..21``,
``backwards_10``, ``rgb_conv``), so a state-dict key reads as the Flax path
(``convert.denoise_state_dict_from_flax``). Three details keep the forward
equal to Flax's:

- ``padding="SAME"`` pads from the size at run time: a 3x3 stride-2 conv
  pads (0, 1) on an even size and (1, 1) on an odd one (``SameConv2d``);
  torch's ``padding=1`` would shift every even level by a pixel.
- Bilinear resizing is ``align_corners=False`` (half-pixel centres, as
  ``jax.image.resize``); every resize here enlarges or keeps the size.
- ``BatchNorm``'s running variance takes the biased batch variance in
  training, as Flax's ``batch_stats`` do (torch's own takes n/(n-1) of it);
  momentum 0.01 in torch's sense is Flax's 0.99, eps 1e-5 in both.

Input is NHWC ``[N, H, W, 14]``, as in the JAX package: the module permutes
it to an NCHW view with channels-last strides, so no copy is made.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pathtrace_tpu_torch.config import NUM_CHANNELS
from pathtrace_tpu_torch.ops.sampling import clip01

EPSILON = 0.00316  # the reference's epsilon (model.py:114)
ALBEDO_SLICE = slice(6, 9)  # channel layout of the 14-channel input
DEFAULT_WIDTHS = (32, 64, 128, 256, 512, 1024)
# Flax's lecun_normal draws a normal truncated at two standard deviations and
# divides the scale by this, the standard deviation of that truncated normal.
TRUNCATED_STD = 0.87962566103423978


class SameConv2d(nn.Conv2d):
    """A convolution with Flax's ``padding="SAME"``: output size ceil(n / s),
    padded (total // 2, total - total // 2) in each spatial dimension from the
    input's size."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(reversed(x.shape[-2:]), reversed(self.kernel_size),
                              reversed(self.stride)):  # F.pad takes the last dim first
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        return super().forward(x)


class BatchNorm(nn.BatchNorm2d):
    """Flax's ``nn.BatchNorm`` (momentum 0.99, eps 1e-5): in training the
    batch's biased variance normalises and also enters the running
    variance."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        # Normalised by the batch's own statistics, with their gradients; no
        # running statistics are passed, so torch updates none.
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ResidualBlock(nn.Module):
    """conv/s2-relu-BN, conv/s1-relu-BN + a strided conv-relu-BN residual."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        # Flax names them in the order its compact __call__ creates them.
        self.Conv_0 = SameConv2d(in_features, features, 3, 2)  # residual
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = SameConv2d(in_features, features, 3, 2)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = SameConv2d(features, features, 3, 1)
        self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.BatchNorm_0(F.relu(self.Conv_0(x)))
        y = self.BatchNorm_1(F.relu(self.Conv_1(x)))
        y = self.BatchNorm_2(F.relu(self.Conv_2(y)))
        return y + residual


def _upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear-resize NCHW x to y's spatial size and add (model.py:78-80)."""
    x = F.interpolate(x, size=tuple(y.shape[-2:]), mode="bilinear", align_corners=False)
    return x + y


class DenoiseCNN(nn.Module):
    """14-channel AOV buffer -> denoised RGB. Input NHWC [N, H, W, 14],
    output NHWC [N, H, W, 3]."""

    def __init__(self, widths: Sequence[int] = DEFAULT_WIDTHS, lateral_features: int = 32):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.lateral_features = int(lateral_features)
        lat, n = self.lateral_features, len(self.widths)
        ins = (NUM_CHANNELS,) + self.widths[:-1]
        for i, (c_in, c_out) in enumerate(zip(ins, self.widths), start=1):
            self.add_module(f"block{i}", ResidualBlock(c_in, c_out))
        self.add_module(f"lat_{n}", SameConv2d(self.widths[-1], lat, 1))
        for i in range(n - 1, 0, -1):
            self.add_module(f"backwards_{i + 1}{i}", SameConv2d(lat, lat, 3, 2))
            self.add_module(f"lat_{i}", SameConv2d(self.widths[i - 1], lat, 1))
        self.backwards_10 = SameConv2d(lat, lat, 3, 2)
        self.lat_0 = SameConv2d(NUM_CHANNELS, lat, 1)
        self.rgb_conv = SameConv2d(lat, 3, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.widths)
        inp = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        raws, h = [], inp
        for i in range(1, n + 1):
            h = getattr(self, f"block{i}")(h)
            raws.append(h)

        rep = F.relu(getattr(self, f"lat_{n}")(raws[-1]))
        for i in range(n - 1, 0, -1):
            rep = F.relu(getattr(self, f"backwards_{i + 1}{i}")(rep))
            lateral = F.relu(getattr(self, f"lat_{i}")(raws[i - 1]))
            rep = _upsample_add(rep, lateral)
        rep = F.relu(self.backwards_10(rep))
        rep = _upsample_add(rep, F.relu(self.lat_0(inp)))

        rgb = self.rgb_conv(rep).permute(0, 2, 3, 1)
        # Albedo re-multiply + clip (model.py:114).
        out = rgb * (EPSILON + x[..., ALBEDO_SLICE])
        return clip01(out) if self.training else torch.clamp(out, 0.0, 1.0)


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation of every convolution of ``model``, in
    place, drawn from ``generator`` in module order: kernels lecun-normal
    (truncated at two standard deviations), biases 0."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Conv2d):
                fan_in = module.in_channels * module.kernel_size[0] * module.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
                nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                nn.init.zeros_(module.bias)
    return model


def init_model(generator: torch.Generator, widths: Sequence[int] = DEFAULT_WIDTHS,
               lateral_features: int = 32) -> DenoiseCNN:
    """A ``DenoiseCNN`` on the CPU with Flax's default initialisation drawn
    from ``generator`` (``flax_init_``); BN scale 1 and bias 0, running mean 0
    and variance 1."""
    return flax_init_(DenoiseCNN(widths, lateral_features), generator)


@contextlib.contextmanager
def cudnn_tf32(allow: bool):
    """Let cuDNN's convolutions use TF32 or not inside the block; the previous
    setting is restored after it. PyTorch's default allows TF32; the port's
    denoiser runs f32 (``allow=False``), as the f32 reference computes."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
