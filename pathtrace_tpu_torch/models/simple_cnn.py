"""Baseline plain-conv denoiser — the reference's TF experiment, kept alive.

The counterpart of ``pathtrace_tpu.models.simple_cnn``. The reference
carries an abandoned TensorFlow-1 alternative denoiser
(``denoise_cnn/tensorflow_experiments/train.py:26-42``): four 3x3 conv
layers of 64 channels with ReLU and a 3-channel linear head, trained with
summed-L1 loss and Adam(1e-4) on 64^2 patches. Here it is a ``torch.nn``
module with Flax's SAME padding and initialisation, and ``torch.optim.Adam``
(the same update as ``optax.adam``: b1 0.9, b2 0.999, eps 1e-8 outside the
square root). Input NHWC [N, H, W, 14], output NHWC [N, H, W, 3].
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from pathtrace_tpu_torch.config import NUM_CHANNELS
from pathtrace_tpu_torch.models.denoise_cnn import SameConv2d, cudnn_tf32, flax_init_
from pathtrace_tpu_torch.render import resolve_device


class SimpleDenoiseCNN(nn.Module):
    """conv3x3(64)+relu x depth, then conv3x3(3). Resolution-preserving.
    Submodules carry the Flax names (``conv1``..``conv<depth>``, ``head``)."""

    def __init__(self, features: int = 64, depth: int = 4):
        super().__init__()
        self.features, self.depth = int(features), int(depth)
        c_in = NUM_CHANNELS
        for i in range(1, self.depth + 1):
            self.add_module(f"conv{i}", SameConv2d(c_in, self.features, 3))
            c_in = self.features
        self.head = SameConv2d(self.features, 3, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        for i in range(1, self.depth + 1):
            h = F.relu(getattr(self, f"conv{i}")(h))
        return self.head(h).permute(0, 2, 3, 1)


def create_simple_state(generator: torch.Generator, learning_rate: float = 1e-4, device=None):
    """(model, optimizer): a ``SimpleDenoiseCNN`` with Flax's initialisation
    drawn from ``generator``, channels-last on ``device`` (default: the
    current CUDA device), and Adam(1e-4) (tensorflow_experiments/
    train.py:42)."""
    device = resolve_device(device)
    model = flax_init_(SimpleDenoiseCNN(), generator)
    model = model.to(device, memory_format=torch.channels_last).train()
    return model, torch.optim.Adam(model.parameters(), lr=learning_rate)


def simple_train_step(model: SimpleDenoiseCNN, optimizer: torch.optim.Optimizer,
                      batch: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """One Adam step on the summed-L1 loss (tensorflow_experiments/
    train.py:41), in f32 with TF32 off; batch and target go to the model's
    device. -> the loss before the step."""
    device = next(model.parameters()).device
    batch, target = batch.to(device), target.to(device)
    with cudnn_tf32(False):
        optimizer.zero_grad(set_to_none=True)
        loss = torch.sum(torch.abs(model(batch) - target))
        loss.backward()
        optimizer.step()
    return loss.detach()
