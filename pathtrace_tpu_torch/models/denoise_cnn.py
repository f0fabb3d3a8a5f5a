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
  ``jax.image.resize``); every resize here enlarges or keeps the size. Its
  backward is a product with the interpolation matrices
  (``_BilinearResize``), deterministic on a card.
- ``BatchNorm`` in training takes Flax's statistics (``batch_stats``:
  E[x^2] - E[x]^2, over every rank of a data-parallel group), and its
  running variance takes that biased variance, as Flax's ``batch_stats``
  do (torch's own takes n/(n-1) of it); momentum 0.01 in torch's sense is
  Flax's 0.99, eps 1e-5 in both.

Input is NHWC ``[N, H, W, 14]``, as in the JAX package: the module permutes
it to an NCHW view with channels-last strides, so no copy is made.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence

import torch
import torch.distributed as dist
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


def batch_stats(x: torch.Tensor, group=None):
    """(mean, biased variance, count) per channel of an NCHW batch, over the
    batch, height and width of every rank of ``group`` (None: this tensor
    alone). Flax's ``_compute_stats`` with ``use_fast_variance``: mean =
    E[x], var = max(E[x^2] - mean^2, 0), in f32. The sums and the count go
    through one all-reduce; the statistics' part of the gradient is
    ``_TrainBatchNorm``'s backward."""
    dims = (0, 2, 3)
    c = x.shape[1]
    count = x.numel() // c
    sums = torch.cat([x.sum(dims), (x * x).sum(dims)])
    if group is not None:
        sums = torch.cat([sums, sums.new_full((1,), count)])
        dist.all_reduce(sums, group=group)
        sums, count = sums[:2 * c], sums[2 * c]
    moments = sums.view(2, c) / count
    mean = moments[0]
    var = torch.addcmul(moments[1], mean, mean, value=-1.0).clamp_(min=0.0)
    return mean, var, count


class _TrainBatchNorm(torch.autograd.Function):
    """(x - mean) * rsqrt(var + eps) * weight + bias with the batch's
    statistics (``batch_stats``, given), and its gradient through those
    statistics too: d var / d x_i = 2 (x_i - mean) / n for either variance
    formula, so dx = w r (dy - S1 / n - xhat S2 / n) with r = rsqrt(var +
    eps), xhat = (x - mean) r, S1 = sum dy, S2 = sum dy xhat. With a
    ``group`` the two sums are all-reduced over its ranks, as JAX's gradient
    of a sharded batch sums them (statistics taken as constants would give
    the same forward and wrong gradients); the weight's and bias's gradients
    stay this rank's own, for the trainer to sum with the rest."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, count, group, eps):
        ctx.save_for_backward(x, weight, mean, var)
        ctx.count, ctx.group, ctx.eps = count, group, eps
        return torch.native_batch_norm(x, weight, bias, mean, var, False, 0.0, eps)[0]

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, var = ctx.saved_tensors
        r = torch.rsqrt(var + ctx.eps)
        # eval mode: dx = dy w r, dw = S2, db = S1, all over this rank's batch
        # (the card's kernel wants the saved statistics given too)
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, mean, var, mean, r, False, ctx.eps, [True, True, True])
        sums = torch.cat([db, dw])
        if ctx.group is not None:
            dist.all_reduce(sums, group=ctx.group)
        coef = sums.view(2, -1) * (weight * r / ctx.count)
        dx = dx - coef[0, :, None, None] - (x - mean[:, None, None]) * (coef[1] * r)[:, None, None]
        return dx, dw, db, None, None, None, None, None


class BatchNorm(nn.BatchNorm2d):
    """Flax's ``nn.BatchNorm`` (momentum 0.99, eps 1e-5): in training the
    batch's statistics (``batch_stats``, over the ranks of ``group`` when one
    is given) normalise (``_TrainBatchNorm``), and their biased variance
    also enters the running variance; out of training the running
    statistics normalise."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            mean, var, count = batch_stats(x, group)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return _TrainBatchNorm.apply(x, self.weight, self.bias, mean, var, count, group,
                                     self.eps)


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

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        residual = self.BatchNorm_0(F.relu(self.Conv_0(x)), group)
        y = self.BatchNorm_1(F.relu(self.Conv_1(x)), group)
        y = self.BatchNorm_2(F.relu(self.Conv_2(y)), group)
        return y + residual


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, device: str) -> torch.Tensor:
    """[n_out, n_in] f32 weights of a bilinear resize along one axis with
    half-pixel centres, as ``F.interpolate(align_corners=False)`` computes
    them: output i reads inputs i0 and i0 + 1 (clamped) of source position
    max((i + 0.5) n_in / n_out - 0.5, 0)."""
    src = torch.clamp((torch.arange(n_out, dtype=torch.float32) + 0.5) * (n_in / n_out) - 0.5,
                      min=0.0)
    i0 = src.long()
    frac = src - i0
    rows = torch.arange(n_out)
    m = torch.zeros(n_out, n_in)
    m.index_put_((rows, i0), 1.0 - frac, accumulate=True)
    m.index_put_((rows, torch.clamp(i0 + 1, max=n_in - 1)), frac, accumulate=True)
    return m.to(device)


class _BilinearResize(torch.autograd.Function):
    """``F.interpolate(mode="bilinear", align_corners=False)`` to ``size``,
    whose backward is the product with the transposed interpolation matrices
    of the two axes. The values are F.interpolate's; the backward is
    deterministic, where F.interpolate's adds with atomics on a card, in an
    order that changes from run to run."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size) -> torch.Tensor:
        ctx.in_size = tuple(x.shape[-2:])
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (h_in, w_in), (n, c, h_out, w_out) = ctx.in_size, grad.shape
        rows = _resize_matrix(h_in, h_out, str(grad.device)).to(grad.dtype)
        cols = _resize_matrix(w_in, w_out, str(grad.device)).to(grad.dtype)
        t = grad.reshape(n * c * h_out, w_out).mm(cols)  # along the width
        t = t.view(n * c, h_out, w_in).transpose(0, 1).reshape(h_out, n * c * w_in)
        out = rows.t().mm(t)  # along the height: [h_in, n c w_in]
        return out.view(h_in, n, c, w_in).permute(1, 2, 0, 3), None


def _upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear-resize NCHW x to y's spatial size and add (model.py:78-80)."""
    return _BilinearResize.apply(x, tuple(y.shape[-2:])) + y


class DenoiseCNN(nn.Module):
    """14-channel AOV buffer -> denoised RGB. Input NHWC [N, H, W, 14],
    output NHWC [N, H, W, 3]. ``group``: in training, the process group
    whose ranks hold the rest of the batch (``BatchNorm``)."""

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

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        n = len(self.widths)
        inp = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        raws, h = [], inp
        for i in range(1, n + 1):
            h = getattr(self, f"block{i}")(h, group)
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
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block (the previous setting
    is restored after it): with ``_BilinearResize`` they make a training
    step on the card give the same bits from run to run."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


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
