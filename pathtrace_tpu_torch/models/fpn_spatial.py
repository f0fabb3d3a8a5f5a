"""Row-sharded inference of the FPN ``DenoiseCNN``.

The counterpart of ``pathtrace_tpu.models.fpn_spatial`` on ``torch.
distributed``. ``models/spatial.py`` covers stacks of radius-1 SAME layers;
the FPN reaches a global receptive field through its bottleneck, so it runs
as the hybrid its pyramid's geometry suggests (activations shrink 4x a
stage):

- **Sharded encoder head**: the first K (=2) residual blocks, the
  memory-dominant full- and half-resolution stages, run on row slabs with a
  halo exchange before each conv (``spatial.neighbour_rows``). A stride-2
  SAME conv on an even height pads (0, 1), so a slab takes ONE bottom halo
  row, and the zero row the last rank takes IS that padding; a stride-1
  conv takes one row each way.
- **Replicated core**: the stage-K output (H/4) is gathered over "tiles",
  and blocks K+1..6 and the coarse top-down steps run on the whole (small)
  tensor on every rank.
- **Sharded top-down tail**: the half- and full-resolution laterals, the
  last 'backwards' convs, the x4 bilinear upsample-and-adds, the RGB head
  and the albedo re-multiply run on slabs. A x4 bilinear resize with
  half-pixel centres samples input row j / 4 - 0.375 with weights that are
  exact binary fractions, and the edge clamp of ``F.interpolate`` is a
  clamp of the row index, so the slab's resize (``_lerp4``, one halo row
  each way, clamped at the frame's edges) gives the whole frame's rows.

A slab carries halo rows, so ``SameConv2d``, which pads from the size it is
given, would pad the wrong rows: every conv here takes the module's weights
into ``F.conv2d`` with explicit row padding and SAME column padding
(``_conv``). BatchNorm is the module's own inference op on the running
statistics, ``F.batch_norm``: the JAX package writes the same affine out as
``(x - mean) * rsqrt(var + 1e-5) * scale + bias``, whose rounding differs
from the whole-frame module's, which the sharded output is held to.

Inference only (running statistics: a per-channel affine, spatially
local). H must divide by 8 t, and H and W by 64 (the 6-deep pyramid).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathtrace_tpu_torch.models.denoise_cnn import ALBEDO_SLICE, EPSILON, cudnn_tf32
from pathtrace_tpu_torch.models.spatial import neighbour_rows
from pathtrace_tpu_torch.parallel.mesh import Mesh
from pathtrace_tpu_torch.parallel.shard import gather_rows

SHARDED_STAGES = 2  # K: blocks run on row slabs before the gather
ROWS = 2  # the row dimension of an NCHW activation


def _same(size: int, k: int, stride: int):
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, conv, stride: int, pad_rows) -> torch.Tensor:
    """[1, Cin, h, W] -> [1, Cout, h', W']: ``conv``'s weights, rows padded
    by ``pad_rows`` (halo rows already added by the caller), columns SAME."""
    k = conv.weight.shape[-1]
    x = F.pad(x, _same(x.shape[3], k, stride) + tuple(pad_rows))
    return F.conv2d(x, conv.weight, conv.bias, stride=stride)


def _bn(x: torch.Tensor, bn) -> torch.Tensor:
    """The module's own inference BatchNorm (running statistics): a per-channel
    affine, so a slab's rows are the whole frame's to the bit."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


def _crelu_bn(x, bn):
    return _bn(F.relu(x), bn)


def _conv_s2_full(x, conv):
    return _conv(x, conv, 2, _same(x.shape[ROWS], conv.weight.shape[-1], 2))


def _res_block_full(x, block):
    """``ResidualBlock`` on the whole tensor (the replicated core)."""
    r = _crelu_bn(_conv_s2_full(x, block.Conv_0), block.BatchNorm_0)
    y = _crelu_bn(_conv_s2_full(x, block.Conv_1), block.BatchNorm_1)
    y = _crelu_bn(_conv(y, block.Conv_2, 1, (1, 1)), block.BatchNorm_2)
    return y + r


def _lerp4(ext: torch.Tensor, dim: int, trim: bool) -> torch.Tensor:
    """x4 linear upsample along ``dim`` with half-pixel centres. ``trim``:
    ``ext`` already holds one halo or clamp row on each side; else it is
    clamp-padded here (a whole dimension)."""
    if not trim:
        n = ext.shape[dim]
        ext = torch.cat([ext.narrow(dim, 0, 1), ext, ext.narrow(dim, n - 1, 1)], dim=dim)
    n_out = 4 * (ext.shape[dim] - 2)
    c = torch.arange(n_out, dtype=torch.float32, device=ext.device) * 0.25 - 0.375
    f = torch.floor(c)
    w1 = c - f
    fi = f.to(torch.int64)
    lo = torch.index_select(ext, dim, fi + 1)
    hi = torch.index_select(ext, dim, fi + 2)
    shape = [1] * ext.dim()
    shape[dim] = n_out
    w1 = w1.view(shape)
    return (1.0 - w1) * lo + w1 * hi


class _Halo:
    """The halo convs of a rank's slab over the grid's "tiles" axis (zeros
    beyond the frame: a SAME conv's zero padding)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def conv_s2(self, x, conv):
        """Stride-2 SAME conv: the whole frame pads rows (0, 1) on an even
        height, so one BOTTOM halo row only."""
        _, below = neighbour_rows(x, self.mesh, 1, ROWS)
        return _conv(torch.cat([x, below], dim=ROWS), conv, 2, (0, 0))

    def conv_s1(self, x, conv):
        """Stride-1 SAME 3x3 conv: one halo row each way."""
        above, below = neighbour_rows(x, self.mesh, 1, ROWS)
        return _conv(torch.cat([above, x, below], dim=ROWS), conv, 1, (0, 0))

    def res_block(self, x, block):
        """``ResidualBlock`` (models/denoise_cnn.py) on a slab."""
        r = _crelu_bn(self.conv_s2(x, block.Conv_0), block.BatchNorm_0)
        y = _crelu_bn(self.conv_s2(x, block.Conv_1), block.BatchNorm_1)
        y = _crelu_bn(self.conv_s1(y, block.Conv_2), block.BatchNorm_2)
        return y + r

    def upsample4(self, x):
        """The slab's rows of the whole frame's x4 bilinear resize: output row
        j samples input row j / 4 - 0.375, the index clamped at the frame's
        edges (``F.interpolate(align_corners=False)``)."""
        above, below = neighbour_rows(x, self.mesh, 1, ROWS)
        n = x.shape[ROWS]
        if self.mesh.ti == 0:
            above = x.narrow(ROWS, 0, 1)
        if self.mesh.ti == self.mesh.shape["tiles"] - 1:
            below = x.narrow(ROWS, n - 1, 1)
        ext = torch.cat([above, x, below], dim=ROWS)  # ext[i + 1] == x[i]
        return _lerp4(_lerp4(ext, ROWS, trim=True), 3, trim=False)


def denoise_fpn_sharded(local_channels: torch.Tensor, mesh: Mesh, model) -> torch.Tensor:
    """Row-sharded inference of the port's ``DenoiseCNN`` (its weights on
    this rank's device, used as in eval mode): this rank's rows [H/t, W, 14]
    of the AOV buffer (the model's input) -> its rows [H/t, W, 3] of the
    denoised frame, equal to the whole frame's forward to float tolerance.
    cuDNN runs f32 with TF32 off, as the port's whole-frame inference does."""
    device = next(model.parameters()).device
    n_t = mesh.shape["tiles"]
    height, width = local_channels.shape[0] * n_t, local_channels.shape[1]
    if height % (8 * n_t) or height % 64 or width % 64:
        raise ValueError(f"H={height} needs H % {8 * n_t} == 0 and H, W % 64 == 0 "
                         f"(W={width})")
    n, K = len(model.widths), SHARDED_STAGES
    halo = _Halo(mesh)
    with torch.no_grad(), cudnn_tf32(False):
        x_hwc = local_channels.to(device, torch.float32)
        x = x_hwc.permute(2, 0, 1)[None]  # [1, 14, h, W]

        # Sharded encoder head: blocks 1..K on slabs.
        raws_sh, h = [], x
        for j in range(1, K + 1):
            h = halo.res_block(h, getattr(model, f"block{j}"))
            raws_sh.append(h)

        # Replicated core: gather stage K; blocks K+1..n and the coarse
        # top-down steps on the whole tensor, on every rank.
        full = gather_rows(h[0].permute(1, 0, 2), mesh).permute(1, 0, 2)[None]
        raws_full = {K - 1: full}
        for j in range(K, n):
            full = _res_block_full(full, getattr(model, f"block{j + 1}"))
            raws_full[j] = full
        rep = F.relu(_conv(raws_full[n - 1], getattr(model, f"lat_{n}"), 1, (0, 0)))
        for i in range(n - 1, K, -1):
            rep = F.relu(_conv_s2_full(rep, getattr(model, f"backwards_{i + 1}{i}")))
            lateral = F.relu(_conv(raws_full[i - 1], getattr(model, f"lat_{i}"), 1, (0, 0)))
            rep = F.interpolate(rep, size=tuple(lateral.shape[-2:]), mode="bilinear",
                                align_corners=False) + lateral

        # Transition i = K: the backwards conv and resize on the whole (small)
        # tensor, then this rank's rows, plus the sharded lateral.
        rep = F.relu(_conv_s2_full(rep, getattr(model, f"backwards_{K + 1}{K}")))
        lateral = F.relu(_conv(raws_sh[K - 1], getattr(model, f"lat_{K}"), 1, (0, 0)))
        h_loc = lateral.shape[ROWS]
        rep = F.interpolate(rep, size=(h_loc * n_t, lateral.shape[3]), mode="bilinear",
                            align_corners=False)
        rep = rep.narrow(ROWS, mesh.ti * h_loc, h_loc) + lateral

        # Sharded top-down tail: i = K-1..1, then the full-resolution finish.
        for i in range(K - 1, 0, -1):
            rep = F.relu(halo.conv_s2(rep, getattr(model, f"backwards_{i + 1}{i}")))
            lateral = F.relu(_conv(raws_sh[i - 1], getattr(model, f"lat_{i}"), 1, (0, 0)))
            rep = halo.upsample4(rep) + lateral
        rep = F.relu(halo.conv_s2(rep, model.backwards_10))
        rep = halo.upsample4(rep) + F.relu(_conv(x, model.lat_0, 1, (0, 0)))

        rgb = halo.conv_s1(rep, model.rgb_conv)[0].permute(1, 2, 0)
        return torch.clamp(rgb * (EPSILON + x_hwc[..., ALBEDO_SLICE]), 0.0, 1.0)

