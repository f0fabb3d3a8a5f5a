"""FPS camera: pose -> eye-ray basis, plus movement semantics.

The counterpart of ``pathtrace_tpu.camera`` (the reference's
``include/Camera.h``): a yaw/pitch camera whose eye-ray basis is the four
NDC corners at clip z=0 unprojected through the analytic inverses of
``perspective(45deg)`` and ``lookAt``. For image pixel (row r, col c),
``ndc_x = 2*c/W - 1`` and ``ndc_y = 1 - 2*r/H``.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.utils.transfer import to_device

# Defaults from reference include/Camera.h:28-32.
DEFAULT_YAW = -90.0
DEFAULT_PITCH = 0.0
SPEED = 50.0
SENSITIVITY = 1.25
ZOOM = 45.0  # vertical fov in degrees
NEAR = 0.01
FAR = 1000.0


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v))


class Camera:
    """Camera pose: ``position`` [3]; ``yaw``/``pitch`` 0-d, in degrees;
    float32 unless ``dtype`` says otherwise (the f64 gradient oracle,
    ``ops/frozen.py``, runs the pose -> basis chain in float64)."""

    def __init__(self, position, yaw, pitch, device=None, dtype=torch.float32):
        self.position = torch.as_tensor(position, dtype=dtype, device=device)
        self.yaw = torch.as_tensor(yaw, dtype=dtype, device=device)
        self.pitch = torch.as_tensor(pitch, dtype=dtype, device=device)

    @staticmethod
    def create(position=(50.0, 52.0, 295.6), yaw=DEFAULT_YAW, pitch=DEFAULT_PITCH,
               device=None) -> "Camera":
        """Defaults are the reference CLI defaults (src/main.cu:24-25)."""
        return Camera(position, yaw, pitch, device=device)

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "Camera":
        return Camera(self.position, self.yaw, self.pitch, device=device,
                      dtype=self.position.dtype)

    def astype(self, dtype) -> "Camera":
        """The same pose held in ``dtype``."""
        return Camera(self.position, self.yaw, self.pitch, device=self.device, dtype=dtype)

    # -- basis vectors (Camera.h:153-164) -----------------------------------
    def basis_vectors(self):
        """Returns (front, right, up), world-up = +Y."""
        yaw = torch.deg2rad(self.yaw)
        pitch = torch.deg2rad(self.pitch)
        front = torch.stack([
            torch.cos(yaw) * torch.cos(pitch),
            torch.sin(pitch),
            torch.sin(yaw) * torch.cos(pitch),
        ])
        front = front / _norm(front)
        world_up = to_device(torch.tensor([0.0, 1.0, 0.0], dtype=self.position.dtype),
                             self.device)
        right = torch.linalg.cross(front, world_up)
        right = right / _norm(right)
        up = torch.linalg.cross(right, front)
        up = up / _norm(up)
        return front, right, up

    def view_matrix(self) -> torch.Tensor:
        """glm::lookAt(position, position + front, up) (Camera.h:74), f32."""
        front, right, up = self.basis_vectors()
        eye = self.position
        m = torch.eye(4, dtype=torch.float32, device=self.device)
        m[0, :3], m[1, :3], m[2, :3] = right, up, -front
        m[0, 3] = -torch.dot(right, eye)
        m[1, 3] = -torch.dot(up, eye)
        m[2, 3] = torch.dot(front, eye)
        return m

    @staticmethod
    def projection_matrix(width: int, height: int, device=None) -> torch.Tensor:
        """glm::perspective(radians(45), w/h, 0.01, 1000) (Camera.h:130), f32."""
        f = 1.0 / torch.tan(torch.deg2rad(torch.tensor(ZOOM, dtype=torch.float32)) / 2.0)
        aspect = width / float(height)
        m = torch.zeros((4, 4), dtype=torch.float32)
        m[0, 0] = f / aspect
        m[1, 1] = f
        m[2, 2] = -(FAR + NEAR) / (FAR - NEAR)
        m[2, 3] = -2.0 * FAR * NEAR / (FAR - NEAR)
        m[3, 2] = -1.0
        return m.to(device)

    def inverse_view_matrix(self) -> torch.Tensor:
        """Analytic inverse of lookAt: [[R^T, eye], [0, 1]]."""
        front, right, up = self.basis_vectors()
        m = torch.eye(4, dtype=self.position.dtype, device=self.device)
        m[:3, 0] = right
        m[:3, 1] = up
        m[:3, 2] = -front
        m[:3, 3] = self.position
        return m

    @staticmethod
    def inverse_projection_matrix(width: int, height: int, dtype=torch.float32,
                                  device=None) -> torch.Tensor:
        """Analytic inverse of the perspective matrix."""
        f = 1.0 / torch.tan(torch.deg2rad(torch.tensor(ZOOM, dtype=dtype)) / 2.0)
        aspect = width / float(height)
        c = -(FAR + NEAR) / (FAR - NEAR)
        d = -2.0 * FAR * NEAR / (FAR - NEAR)
        m = torch.zeros((4, 4), dtype=dtype)
        m[0, 0] = aspect / f
        m[1, 1] = 1.0 / f
        m[2, 3] = -1.0
        m[3, 2] = 1.0 / d
        m[3, 3] = c / d
        return to_device(m, device)

    def eye_ray_basis(self, width: int, height: int) -> torch.Tensor:
        """Four corner ray directions, [4, 3]: NDC corners (-1,-1), (+1,-1),
        (-1,+1), (+1,+1) (reference ``Camera.h:131-148``: ray00, ray10,
        ray01, ray11). Not normalized: depth is measured in units of this
        basis. Formed as ``R_view^-1 @ unproject_view(corner)``, which keeps
        f32 accuracy that ``unproject_world(corner) - eye`` loses. Its
        constants reach a camera on the card without a wait for it
        (``utils/transfer.py``), so the basis of such a camera is built on
        the card without one."""
        dt = self.position.dtype
        corners = to_device(torch.tensor(
            [[-1.0, -1.0, 0.0, 1.0], [1.0, -1.0, 0.0, 1.0],
             [-1.0, 1.0, 0.0, 1.0], [1.0, 1.0, 0.0, 1.0]], dtype=dt), self.device
        )  # clip z = 0 as in the reference
        view = corners @ self.inverse_projection_matrix(width, height, dt, self.device).T
        view3 = view[:, :3] / view[:, 3:4]
        rot = self.inverse_view_matrix()[:3, :3]  # world <- view rotation
        return view3 @ rot.T

    # -- interactive-mode semantics (Window.h:133-147, Camera.h:79-112) -----
    def move(self, direction: str, delta_time: float) -> "Camera":
        """WASD movement: direction in {forward, backward, left, right}."""
        front, right, _ = self.basis_vectors()
        v = SPEED * delta_time
        step = {
            "forward": front * v,
            "backward": -front * v,
            "left": -right * v,
            "right": right * v,
        }[direction]
        return Camera(self.position + step, self.yaw, self.pitch)

    def look(self, dx: float, dy: float, constrain_pitch: bool = True) -> "Camera":
        """Mouse look; offsets scaled by SENSITIVITY, pitch clamped to
        [-89, 89] (Camera.h:93-112)."""
        yaw = self.yaw + dx * SENSITIVITY
        pitch = self.pitch + dy * SENSITIVITY
        if constrain_pitch:
            pitch = torch.clamp(pitch, -89.0, 89.0)
        return Camera(self.position, yaw, pitch)

    @staticmethod
    def scroll_zoom(zoom: float, y_offset: float) -> float:
        """Mouse-wheel zoom clamped to [1, 45] (Camera.h:116-123); the ray
        basis never reads it, as in the reference."""
        if 1.0 <= zoom <= 45.0:
            zoom -= y_offset
        return min(max(zoom, 1.0), 45.0)

    def pose_string(self) -> str:
        """The SPACE-key camera dump (Window.h:155-158): x y z yaw pitch."""
        p = [float(v) for v in self.position]
        return f"{p[0]} {p[1]} {p[2]} {float(self.yaw)} {float(self.pitch)}"


def pixel_ndc(rows, cols, width: int, height: int):
    """Image pixel coordinates (possibly jittered) -> NDC. Pixel (r, c)
    maps to the corner-anchored position (c/W, r/H), no +0.5 offset."""
    ndc_x = 2.0 * cols / width - 1.0
    ndc_y = 1.0 - 2.0 * rows / height
    return ndc_x, ndc_y


def ray_directions(basis: torch.Tensor, ndc_x, ndc_y) -> torch.Tensor:
    """Bilinearly interpolate the 4-corner basis at NDC positions -> [..., 3]."""
    u = ((ndc_x + 1.0) * 0.5)[..., None]
    v = ((ndc_y + 1.0) * 0.5)[..., None]
    bottom = basis[0] * (1.0 - u) + basis[1] * u
    top = basis[2] * (1.0 - u) + basis[3] * u
    return bottom * (1.0 - v) + top * v
