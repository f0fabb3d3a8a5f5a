"""The camera, frozen: a pose -> the eye and its four corner rays.

A frozen copy of ``pathtrace_tpu_torch/camera.py`` (the reference's
``Camera.h``): yaw and pitch in degrees, world up +Y, a 45 degree vertical
field of view, and the corner rays ``R_view^-1 @ unproject_view(corner)``
in f32 on the host, the way the program builds them, so that a replayed
walk of moves and looks gives the program's rays.
"""

from __future__ import annotations

import torch

SPEED = 50.0
SENSITIVITY = 1.25
ZOOM = 45.0
NEAR = 0.01
FAR = 1000.0


def _norm(v):
    return torch.sqrt(torch.sum(v * v))


class Pose:
    """position [3], yaw, pitch: f32 tensors on the host."""

    def __init__(self, position, yaw, pitch):
        self.position = torch.as_tensor(position, dtype=torch.float32)
        self.yaw = torch.as_tensor(yaw, dtype=torch.float32)
        self.pitch = torch.as_tensor(pitch, dtype=torch.float32)

    def basis_vectors(self):
        yaw, pitch = torch.deg2rad(self.yaw), torch.deg2rad(self.pitch)
        front = torch.stack([torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch),
                             torch.sin(yaw) * torch.cos(pitch)])
        front = front / _norm(front)
        right = torch.linalg.cross(front, torch.tensor([0.0, 1.0, 0.0]))
        right = right / _norm(right)
        up = torch.linalg.cross(right, front)
        return front, right, up / _norm(up)

    def move(self, direction: str, delta_time: float) -> "Pose":
        front, right, _ = self.basis_vectors()
        v = SPEED * delta_time
        step = {"forward": front * v, "backward": -front * v, "left": -right * v,
                "right": right * v}[direction]
        return Pose(self.position + step, self.yaw, self.pitch)

    def look(self, dx: float, dy: float) -> "Pose":
        return Pose(self.position, self.yaw + dx * SENSITIVITY,
                    torch.clamp(self.pitch + dy * SENSITIVITY, -89.0, 89.0))

    def corner_rays(self, width: int, height: int) -> torch.Tensor:
        """[4, 3]: the rays through NDC (-1,-1), (1,-1), (-1,1), (1,1)."""
        f = 1.0 / torch.tan(torch.deg2rad(torch.tensor(ZOOM, dtype=torch.float32)) / 2.0)
        aspect = width / float(height)
        c = -(FAR + NEAR) / (FAR - NEAR)
        d = -2.0 * FAR * NEAR / (FAR - NEAR)
        inv_proj = torch.zeros((4, 4), dtype=torch.float32)
        inv_proj[0, 0] = aspect / f
        inv_proj[1, 1] = 1.0 / f
        inv_proj[2, 3] = -1.0
        inv_proj[3, 2] = 1.0 / d
        inv_proj[3, 3] = c / d
        corners = torch.tensor([[-1.0, -1.0, 0.0, 1.0], [1.0, -1.0, 0.0, 1.0],
                                [-1.0, 1.0, 0.0, 1.0], [1.0, 1.0, 0.0, 1.0]])
        view = corners @ inv_proj.T
        view3 = view[:, :3] / view[:, 3:4]
        front, right, up = self.basis_vectors()
        inv_view = torch.eye(4, dtype=torch.float32)
        inv_view[:3, 0], inv_view[:3, 1], inv_view[:3, 2] = right, up, -front
        inv_view[:3, 3] = self.position
        return view3 @ inv_view[:3, :3].T
