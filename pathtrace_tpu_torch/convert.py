"""Carry a scene and a camera across from the JAX package.

The renderer has no learned weights: its scene and camera are the whole
state. These take the JAX package's parameters as numpy arrays
(``np.asarray(jax_scene.radius)``, ...) and return the port's objects, so
both packages compute on the same values; ``grads_to_numpy`` goes the other
way for gradients, so that both packages' seven gradient blocks can be
compared by name. No JAX import is needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
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
