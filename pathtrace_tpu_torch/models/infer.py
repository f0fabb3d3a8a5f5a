"""Embedded denoiser inference: AOVs -> denoised colour, in-process.

The counterpart of ``pathtrace_tpu.models.infer`` (the reference's C++ <->
boost::python <-> PyTorch bridge, ``src/main.cu:92-122``,
``denoise_cnn/train.py:48-76``): the AOV buffer is already a tensor on the
device, so inference is one forward of the model, under
``torch.inference_mode`` and in ``eval()``. The model's weights are
channels-last, the layout the buffer already has, and cuDNN runs the
convolutions in f32 with TF32 off (``cudnn_tf32``), so the card computes
what the f32 reference computes.

Preprocessing matches ``test()`` (``train.py:50-55``): albedo-divide the
colour, max-normalise depth and the 4 variances (``models/preprocess.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from pathtrace_tpu_torch.models.denoise_cnn import DenoiseCNN, cudnn_tf32
from pathtrace_tpu_torch.models.preprocess import preprocess_channels
from pathtrace_tpu_torch.render import pack_channels, resolve_device
from pathtrace_tpu_torch.train import load_checkpoint

_CACHE: Dict[Tuple[str, str], DenoiseCNN] = {}


def load_pretrained(checkpoint: str, device=None) -> DenoiseCNN:
    """The model of a checkpoint directory (``train.save_checkpoint``'s) on
    ``device`` (default: the current CUDA device), in eval mode, with
    channels-last weights; cached per path and device."""
    device = resolve_device(device)
    key = (os.path.abspath(checkpoint), str(device))
    if key not in _CACHE:
        model = load_checkpoint(checkpoint)
        _CACHE[key] = model.to(device, memory_format=torch.channels_last).eval()
    return _CACHE[key]


def denoise_with(model: DenoiseCNN, channels: torch.Tensor) -> torch.Tensor:
    """Packed [H, W, 14] buffer -> denoised [H, W, 3] colour through
    ``model``, which is in eval mode on the buffer's device."""
    with torch.inference_mode(), cudnn_tf32(False):
        return model(preprocess_channels(channels)[None])[0]


def denoise_channels(channels: torch.Tensor, checkpoint: str) -> torch.Tensor:
    """Packed [H, W, 14] buffer -> denoised [H, W, 3] colour, on the buffer's
    device."""
    return denoise_with(load_pretrained(checkpoint, channels.device), channels)


def denoise_aovs(aovs, checkpoint: str) -> torch.Tensor:
    """AOV dict -> denoised [H, W, 3] colour."""
    return denoise_channels(pack_channels(aovs), checkpoint)
