"""Denoise-CNN checkpoints.

The counterpart of ``pathtrace_tpu.train``'s checkpoint I/O
(``save_checkpoint``, ``load_checkpoint``). A checkpoint directory holds the
JAX package's ``model.json`` (the same keys: ``widths``,
``lateral_features``) and ``<name>.pt``, a ``torch.save`` of the model's
state dict; ``name`` is ``"model_epoch"`` (the latest) or ``"model_best"``,
as there. The JAX package's orbax snapshots are not read here:
``scripts/torch_convert_checkpoint.py`` converts one on a machine with JAX.

The trainer itself (optimiser, ``train_step``, ``fit``, the CLI) is not
ported yet.
"""

from __future__ import annotations

import json
import os

import torch

from pathtrace_tpu_torch.models.denoise_cnn import DenoiseCNN


def checkpoint_file(ckpt_dir: str, name: str = "model_epoch") -> str:
    return os.path.join(ckpt_dir, f"{name}.pt")


def save_checkpoint(ckpt_dir: str, model: DenoiseCNN, name: str = "model_epoch") -> str:
    """Write ``model.json`` and ``<name>.pt`` into ``ckpt_dir`` -> the .pt path.
    The state dict is written from the host, so it loads on any device."""
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "model.json"), "w") as f:
        json.dump({"widths": list(model.widths), "lateral_features": model.lateral_features}, f)
    path = checkpoint_file(ckpt_dir, name)
    state = {k: v.detach().to("cpu") for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(ckpt_dir: str, name: str = "model_epoch") -> DenoiseCNN:
    """The ``DenoiseCNN`` of ``model.json`` (the default widths where there is
    none, as in the JAX package) with the weights of ``<name>.pt``, on the
    CPU, in eval mode. A missing file raises ``FileNotFoundError``."""
    state = torch.load(checkpoint_file(ckpt_dir, name), map_location="cpu", weights_only=True)
    spec_path = os.path.join(ckpt_dir, "model.json")
    if os.path.exists(spec_path):
        with open(spec_path) as f:
            spec = json.load(f)
        model = DenoiseCNN(widths=spec["widths"], lateral_features=spec["lateral_features"])
    else:
        model = DenoiseCNN()
    model.load_state_dict(state)
    return model.eval()
