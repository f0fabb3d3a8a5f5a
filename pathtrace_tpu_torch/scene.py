"""Scene data model: spheres as struct-of-arrays tensors.

The counterpart of ``pathtrace_tpu.scene``: ``radius`` [N] and
``position``/``emission``/``color`` [N, 3], float32 unless given another
floating dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(x, device=None) -> torch.Tensor:
    t = torch.as_tensor(x, device=device)
    if not t.is_floating_point():
        t = t.to(torch.float32)
    return t


class Scene:
    """A scene of spheres: radius [N], position/emission/color [N, 3]."""

    def __init__(self, radius, position, emission, color, device=None):
        self.radius = _as_tensor(radius, device)
        self.position = _as_tensor(position, device)
        self.emission = _as_tensor(emission, device)
        self.color = _as_tensor(color, device)

    @property
    def num_objects(self) -> int:
        return self.radius.shape[0]

    @property
    def device(self) -> torch.device:
        return self.radius.device

    def replace(self, **fields) -> "Scene":
        """A new ``Scene`` with the given fields (radius, position, emission,
        color) in place of this one's."""
        current = dict(radius=self.radius, position=self.position, emission=self.emission,
                       color=self.color)
        current.update(fields)
        return Scene(**current)

    def to(self, device) -> "Scene":
        return Scene(self.radius, self.position, self.emission, self.color, device=device)

    def packed(self) -> torch.Tensor:
        """[N, 10] float32 rows of (radius, pos xyz, emission rgb, color rgb):
        the kernel's scene block."""
        return torch.cat(
            [self.radius[:, None], self.position, self.emission, self.color], dim=1
        ).to(torch.float32).contiguous()

    def __repr__(self):
        return f"Scene(num_objects={self.num_objects}, device={self.device})"


def cornell_box(device=None) -> Scene:
    """The 9-sphere smallpt Cornell box, values identical to the reference
    (``include/Scene.h:25-35``) and to ``pathtrace_tpu.scene.cornell_box``."""
    big = 1e5
    spheres = [
        # radius, position,                    emission,        color
        (big, (big + 1.0, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25)),   # left
        (big, (-big + 99.0, 40.8, 81.6), (0, 0, 0), (0.25, 0.25, 0.75)),  # right
        (big, (50.0, 40.8, big), (0, 0, 0), (0.75, 0.75, 0.75)),          # back
        (big, (50.0, 40.8, -big + 600.0), (0, 0, 0), (1.0, 1.0, 1.0)),    # front
        (big, (50.0, big, 81.6), (0, 0, 0), (0.75, 0.75, 0.75)),          # bottom
        (big, (50.0, -big + 81.6, 81.6), (0, 0, 0), (0.75, 0.75, 0.75)),  # top
        (16.5, (27.0, 16.5, 47.0), (0, 0, 0), (1.0, 1.0, 1.0)),           # ball 1
        (16.5, (73.0, 16.5, 78.0), (0, 0, 0), (1.0, 1.0, 1.0)),           # ball 2
        (600.0, (50.0, 681.6 - 0.78, 81.6), (4.0, 3.6, 3.2), (0, 0, 0)),  # light
    ]
    radius = np.array([s[0] for s in spheres], np.float32)
    position = np.array([s[1] for s in spheres], np.float32)
    emission = np.array([s[2] for s in spheres], np.float32)
    color = np.array([s[3] for s in spheres], np.float32)
    return Scene(radius, position, emission, color, device=device)
