"""Carry a scene, a camera and the denoiser's weights across from the JAX
package.

The renderer's scene and camera are its whole state. These take the JAX
package's parameters as numpy arrays (``np.asarray(jax_scene.radius)``, ...)
and return the port's objects, so both packages compute on the same values;
``grads_to_numpy`` goes the other way for gradients, so that both packages'
seven gradient blocks can be compared by name. The denoiser's Flax variables,
as a nested dict of numpy arrays, become the port's state dict
(``denoise_state_dict_from_flax``, ``simple_state_dict_from_flax``), and the
JAX trainer's whole state the port's (``train_state_from_flax``). The
frozen-decision oracle's record comes across too (``decisions_from_jax``,
``decisions_from_npz``), so that both packages replay the same decisions.
No JAX import is needed here.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Mapping

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.ops.frozen import Decisions
from pathtrace_tpu_torch.scene import Scene


def scene_from_numpy(radius, position, emission, color, device=None) -> Scene:
    """radius [N], position/emission/color [N, 3] arrays -> ``Scene``."""
    arrays = [np.array(a, np.float32) for a in (radius, position, emission, color)]
    n = arrays[0].shape
    if len(n) != 1 or any(a.shape != (n[0], 3) for a in arrays[1:]):
        raise ValueError(f"expected radius [N] and [N, 3] fields, got "
                         f"{[a.shape for a in arrays]}")
    return Scene(*arrays, device=device)


def camera_from_numpy(position, yaw, pitch, device=None) -> Camera:
    """position [3], yaw, pitch (degrees) -> ``Camera``."""
    position = np.array(position, np.float32)
    if position.shape != (3,):
        raise ValueError(f"camera position must be [3], got {position.shape}")
    return Camera(position, float(np.asarray(yaw, np.float32)),
                  float(np.asarray(pitch, np.float32)), device=device)


def grads_to_numpy(d_scene: Scene, d_cam: Camera) -> dict:
    """The port's gradients (a ``Scene`` and a ``Camera`` holding the gradient
    of each field) -> {name: float32 array} under the JAX package's field
    names: radius, position, emission, color, and the camera's
    cam_position, yaw, pitch."""
    out = {name: getattr(d_scene, name) for name in ("radius", "position", "emission", "color")}
    out.update(cam_position=d_cam.position, yaw=d_cam.yaw, pitch=d_cam.pitch)
    return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in out.items()}


# The lattice-defining fields that stamp an oracle's files
# (scripts/grad_oracle_cpu.py, scripts/torch_grad_oracle.py).
DECISIONS_STAMP = ("size", "spp", "seed", "max_bounces", "brdf", "nee", "light_index",
                   "spp_chunk")


def _decisions_from_numpy(arrays) -> Decisions:
    """{field: array} (any integer or bool dtype; vis 0/1) -> ``Decisions``
    on the CPU: idx int32, the flags bool, vis float32."""
    idx = torch.from_numpy(np.array(arrays["idx"], np.int32))
    flags = [torch.from_numpy(np.array(arrays[k], bool)) for k in ("use_near", "facing", "ortho")]
    vis = torch.from_numpy(np.array(arrays["vis"], np.float32))
    return Decisions(idx, *flags, vis)


def decisions_from_jax(dec) -> Decisions:
    """The JAX package's ``ops.frozen.Decisions`` (fields as numpy arrays,
    ``np.asarray(dec.idx)``, ...) -> the port's ``Decisions`` on the CPU."""
    return _decisions_from_numpy({k: np.asarray(getattr(dec, k)) for k in Decisions._fields})


def decisions_to_npz(path, recs, stamp: dict):
    """Write the decisions of each chunk in the layout of the JAX package's
    ``scripts/grad_oracle_cpu.py``: ``c{i}_idx`` int8, ``c{i}_use_near``,
    ``_facing``, ``_ortho``, ``_vis`` uint8, ``n_chunks`` and ``stamp`` (the
    fields of ``DECISIONS_STAMP``)."""
    out = {"n_chunks": len(recs), **stamp}
    for i, dec in enumerate(recs):
        for k in Decisions._fields:
            out[f"c{i}_{k}"] = getattr(dec, k).to("cpu", torch.int8 if k == "idx"
                                                  else torch.uint8).numpy()
    np.savez_compressed(path, **out)


def decisions_from_npz(path):
    """A ``decisions.npz`` as ``decisions_to_npz`` or the JAX package's
    oracle script writes it -> (list of ``Decisions`` on the CPU, one a
    chunk; {stamp field: value}, the fields of ``DECISIONS_STAMP`` that the
    file holds)."""
    with np.load(path, allow_pickle=False) as f:
        recs = [_decisions_from_numpy({k: f[f"c{i}_{k}"] for k in Decisions._fields})
                for i in range(int(f["n_chunks"]))]
        stamp = {k: f[k].item() for k in DECISIONS_STAMP if k in f.files}
    return recs, stamp


# Flax leaf name -> torch state-dict name, per collection.
_PARAM_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _params_from_flax(params) -> "OrderedDict[str, torch.Tensor]":
    """A Flax ``params`` tree (or a tree of the same shape: an optax
    momentum trace) -> {torch parameter name: tensor}. Conv kernels go HWIO
    -> OIHW; ``scale`` becomes ``weight``."""
    out = OrderedDict()
    for path, value in _flatten(params):
        leaf = path[-1]
        if leaf not in _PARAM_NAMES:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        array = np.asarray(value, np.float32)
        if leaf == "kernel":
            if array.ndim != 4:
                raise ValueError(f"conv kernel {'/'.join(path)} is not 4-D: {array.shape}")
            array = array.transpose(3, 2, 0, 1)
        out[".".join(path[:-1] + (_PARAM_NAMES[leaf],))] = torch.from_numpy(array.copy())
    return out


def denoise_state_dict_from_flax(variables) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``{"params": ..., "batch_stats": ...}`` of ``DenoiseCNN`` (nested
    dicts of numpy arrays) -> the state dict of the port's
    ``models.denoise_cnn.DenoiseCNN``. Conv kernels go HWIO -> OIHW; BatchNorm
    ``scale``/``bias`` become ``weight``/``bias``, ``mean``/``var`` become
    ``running_mean``/``running_var``, and ``num_batches_tracked`` is 0. The
    module paths are the Flax tree's (``block1.Conv_0``, ``lat_0``, ...)."""
    out = _params_from_flax(variables["params"])
    for path, value in _flatten(variables.get("batch_stats", {})):
        if path[-1] not in _STAT_NAMES:
            raise ValueError(f"unexpected batch statistic {'/'.join(path)}")
        module = ".".join(path[:-1])
        out[f"{module}.{_STAT_NAMES[path[-1]]}"] = torch.from_numpy(
            np.array(value, np.float32))
        out[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def simple_state_dict_from_flax(params) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``params`` of ``SimpleDenoiseCNN`` (``conv1``..``conv4``, ``head``;
    no batch statistics) -> the state dict of the port's
    ``models.simple_cnn.SimpleDenoiseCNN``."""
    return _params_from_flax(params)


def train_state_from_flax(tree) -> dict:
    """The JAX package's ``train.TrainState`` as nested dicts of numpy arrays
    -> the layout of the port's ``train.TrainState.state_dict()`` (load it
    with ``TrainState.load_state_dict``). ``tree`` holds ``params`` and
    ``batch_stats`` (the Flax variables), ``trace`` (optax's momentum trace,
    a tree shaped as ``params``: ``opt_state.inner_state[0].trace``), and the
    scalars ``lr``, ``best_loss``, ``plateau_count``, ``epoch``. The trace
    becomes the SGD momentum buffers, by parameter name."""
    return {
        "model": denoise_state_dict_from_flax(
            {"params": tree["params"], "batch_stats": tree["batch_stats"]}),
        "momentum": _params_from_flax(tree["trace"]),
        "lr": float(np.float32(tree["lr"])),
        "best_loss": float(np.float32(tree["best_loss"])),
        "plateau_count": int(tree["plateau_count"]),
        "epoch": int(tree["epoch"]),
    }
