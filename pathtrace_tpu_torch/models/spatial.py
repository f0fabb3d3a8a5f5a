"""Row-sharded CNN inference with a halo exchange before every layer.

The counterpart of ``pathtrace_tpu.models.spatial`` on ``torch.
distributed``: for frames larger than one device holds, activations shard
by image rows over the grid's "tiles" axis. Before each 3x3 conv layer a
rank takes ONE boundary row from each neighbour and crops one row after.

The exchange must be per layer, not a one-shot input halo: SAME padding
zeroes each layer's *activations* beyond the true image boundary, and with
bias + ReLU ``layer(0) != 0``, so a single input-halo pass diverges in the
boundary rows. With the exchange per layer, a rank at the frame's edge
takes zero rows there, which IS that layer's SAME padding, so the sharded
result equals the full frame's to float tolerance for any stack of
radius-1 SAME layers (``SimpleDenoiseCNN``).

The exchange is one ``all_gather`` in the "tiles" group of each rank's
first and last ``halo`` rows; a rank takes its neighbours' and zeros at the
frame's edges. It runs on gloo and NCCL alike, CUDA tensors included.
Every function takes and returns this rank's rows: a slab [H/t, W, C]
(``parallel.shard.render_slab_sharded`` gives one, ``shard.shard_rows``
cuts one from a whole frame, ``shard.gather_rows`` joins them).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pathtrace_tpu_torch.models.denoise_cnn import cudnn_tf32
from pathtrace_tpu_torch.models.preprocess import EPSILON
from pathtrace_tpu_torch.parallel.mesh import Mesh
from pathtrace_tpu_torch.parallel.shard import all_gather_axis, all_reduce


def neighbour_rows(x: torch.Tensor, mesh: Mesh, halo: int = 1, dim: int = 0):
    """(the ``halo`` rows above this rank's slab, the ``halo`` rows below it)
    along ``dim``, from its "tiles" neighbours; zeros beyond the frame."""
    n = x.shape[dim]
    edges = all_gather_axis(torch.cat([x.narrow(dim, 0, halo), x.narrow(dim, n - halo, halo)],
                                      dim=dim), mesh, "tiles")
    ti, n_t = mesh.ti, mesh.shape["tiles"]
    zeros = torch.zeros_like(x.narrow(dim, 0, halo))
    above = edges[ti - 1].narrow(dim, halo, halo) if ti > 0 else zeros
    below = edges[ti + 1].narrow(dim, 0, halo) if ti < n_t - 1 else zeros
    return above, below


def preprocess_channels_sharded(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``models.preprocess.preprocess_channels`` of this rank's rows [h, W,
    14] of the frame: depth and the four variances are divided by the
    frame's maxima, taken over the "tiles" group, so the slab equals the
    whole frame's preprocessed rows to the bit."""
    color, normal, albedo = local[..., 0:3], local[..., 3:6], local[..., 6:9]
    depth, variances = local[..., 9:10], local[..., 10:14]
    maxima = all_reduce(torch.amax(local[..., 9:14], dim=(0, 1)), mesh, ("tiles",),
                        dist.ReduceOp.MAX)
    return torch.cat([color / (EPSILON + albedo), normal, albedo,
                      depth / (EPSILON + maxima[0]), variances / (EPSILON + maxima[1:])], dim=-1)


def conv3x3_layer(weight: torch.Tensor, bias: torch.Tensor, relu: bool) -> Callable:
    """[h, W, Cin] -> [h, W, Cout] SAME 3x3 conv (+ ReLU); ``weight`` OIHW."""

    def fn(x):
        y = F.conv2d(x.permute(2, 0, 1)[None], weight, bias, padding=1)[0].permute(1, 2, 0)
        return F.relu(y) if relu else y

    return fn


def apply_layers_sharded(layer_fns: Sequence[Callable], local: torch.Tensor, mesh: Mesh,
                         halo: int = 1) -> torch.Tensor:
    """Apply a stack of spatially local SAME layers (receptive-field radius
    <= ``halo`` each) to this rank's rows [h, W, C], exchanging a halo
    before each layer -> this rank's rows of the output."""
    x = local
    for fn in layer_fns:
        above, below = neighbour_rows(x, mesh, halo)
        x = fn(torch.cat([above, x, below], dim=0))[halo:-halo]
    return x


def denoise_spatially_sharded(local_channels: torch.Tensor, mesh: Mesh, model) -> torch.Tensor:
    """Row-sharded inference of the port's ``SimpleDenoiseCNN`` (its weights
    on this rank's device): this rank's rows [H/t, W, 14] of the
    preprocessed buffer -> its rows [H/t, W, 3] of the output. cuDNN runs
    f32 with TF32 off, as the port's whole-frame inference does."""
    device = next(model.parameters()).device
    layers = [conv3x3_layer(getattr(model, f"conv{i}").weight,
                            getattr(model, f"conv{i}").bias, True)
              for i in range(1, model.depth + 1)]
    layers.append(conv3x3_layer(model.head.weight, model.head.bias, False))
    with torch.no_grad(), cudnn_tf32(False):
        return apply_layers_sharded(layers, local_channels.to(device, torch.float32), mesh)
