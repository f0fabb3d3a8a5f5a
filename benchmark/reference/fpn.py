"""The denoiser, plain and functional: preprocessing, the FPN, the L1 loss.

A frozen transcription of the reference's ``denoise_cnn/model.py:33-119``
and ``load_data.py:21-35`` as the port and the JAX package run them
(``pathtrace_tpu_torch/models/denoise_cnn.py``, ``preprocess.py``): six
stride-2 residual blocks 14 -> 32 ... 1024 (conv, ReLU, BatchNorm; Flax's
"SAME" padding), 1x1 laterals to 32, 3x3 stride-2 "backwards" convs,
bilinear upsample-and-add with half-pixel centres, a 3x3 conv to RGB, then
``clip(rgb * (0.00316 + albedo), 0, 1)``. BatchNorm in training takes the
batch's E[x^2] - E[x]^2 (Flax's statistics), and out of training the
running statistics.

Parameters are a dict by the port's state-dict names, NCHW throughout;
autograd gives the gradients. ``tf32`` lets the convolutions use TF32
(the control). ``counter``, a list, receives each convolution's operations:
2 x (input channels x kernel area) + 1 an output element.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPSILON = 0.00316
BN_EPS = 1e-5
WIDTHS = (32, 64, 128, 256, 512, 1024)
LATERAL = 32
IN_CHANNELS = 14


def shapes(widths=WIDTHS, lateral=LATERAL):
    """{name: shape} of every parameter and BatchNorm statistic, in the
    port's module order."""
    out = {}

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    def bn(name, c):
        for field in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{field}"] = (c,)

    ins = (IN_CHANNELS,) + tuple(widths[:-1])
    for i, (cin, cout) in enumerate(zip(ins, widths), start=1):
        conv(f"block{i}.Conv_0", cin, cout, 3)
        bn(f"block{i}.BatchNorm_0", cout)
        conv(f"block{i}.Conv_1", cin, cout, 3)
        bn(f"block{i}.BatchNorm_1", cout)
        conv(f"block{i}.Conv_2", cout, cout, 3)
        bn(f"block{i}.BatchNorm_2", cout)
    n = len(widths)
    conv(f"lat_{n}", widths[-1], lateral, 1)
    for i in range(n - 1, 0, -1):
        conv(f"backwards_{i + 1}{i}", lateral, lateral, 3)
        conv(f"lat_{i}", widths[i - 1], lateral, 1)
    conv("backwards_10", lateral, lateral, 3)
    conv("lat_0", IN_CHANNELS, lateral, 1)
    conv("rgb_conv", lateral, 3, 3)
    return out


def preprocess(buf: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 14] AOVs -> CNN input: colour / (eps + albedo), depth and
    the four variances each / (eps + its maximum over the image)."""
    color, normal, albedo = buf[..., 0:3], buf[..., 3:6], buf[..., 6:9]
    depth, variances = buf[..., 9:10], buf[..., 10:14]
    spatial = (buf.dim() - 3, buf.dim() - 2)
    depth = depth / (EPSILON + torch.amax(depth, dim=spatial + (-1,), keepdim=True))
    variances = variances / (EPSILON + torch.amax(variances, dim=spatial, keepdim=True))
    return torch.cat([color / (EPSILON + albedo), normal, albedo, depth, variances], dim=-1)


def _conv(p, name, x, stride, counter):
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    y = F.conv2d(x, w, p[f"{name}.bias"], stride=stride)
    if counter is not None:
        counter.append(y.numel() * (2 * w.shape[1] * k * k + 1))
    return y


def _bn(p, name, x, train):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    r = torch.rsqrt(var + BN_EPS)
    return (x - mean[:, None, None]) * (r * w)[:, None, None] + b[:, None, None]


def forward(p, x: torch.Tensor, train: bool = False, counter=None, widths=WIDTHS):
    """NHWC [N, H, W, 14] preprocessed input -> [N, H, W, 3]."""
    inp = x.permute(0, 3, 1, 2)
    raws, h = [], inp
    for i in range(1, len(widths) + 1):
        blk = f"block{i}"
        res = _bn(p, f"{blk}.BatchNorm_0", F.relu(_conv(p, f"{blk}.Conv_0", h, 2, counter)), train)
        y = _bn(p, f"{blk}.BatchNorm_1", F.relu(_conv(p, f"{blk}.Conv_1", h, 2, counter)), train)
        y = _bn(p, f"{blk}.BatchNorm_2", F.relu(_conv(p, f"{blk}.Conv_2", y, 1, counter)), train)
        h = y + res
        raws.append(h)
    n = len(widths)
    rep = F.relu(_conv(p, f"lat_{n}", raws[-1], 1, counter))
    for i in range(n - 1, 0, -1):
        rep = F.relu(_conv(p, f"backwards_{i + 1}{i}", rep, 2, counter))
        lateral = F.relu(_conv(p, f"lat_{i}", raws[i - 1], 1, counter))
        rep = F.interpolate(rep, size=lateral.shape[-2:], mode="bilinear",
                            align_corners=False) + lateral
    rep = F.relu(_conv(p, "backwards_10", rep, 2, counter))
    lat0 = F.relu(_conv(p, "lat_0", inp, 1, counter))
    rep = F.interpolate(rep, size=lat0.shape[-2:], mode="bilinear", align_corners=False) + lat0
    rgb = _conv(p, "rgb_conv", rep, 1, counter).permute(0, 2, 3, 1)
    return torch.clamp(rgb * (EPSILON + x[..., 6:9]), 0.0, 1.0)


def l1(pred, target):
    return torch.mean(torch.abs(pred - target))


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN's convolutions and matmuls in f32 (TF32 off) or in TF32."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
