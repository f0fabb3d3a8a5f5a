"""Moving small host tensors to the card without waiting for it.

``tensor.to("cuda")`` of a tensor in pageable host memory, and
``torch.tensor(values, device="cuda")``, copy through PyTorch's
``memcpy_and_sync``: the host waits until the card has run everything
queued before the copy. The entry points and the kernel wrappers move their
small host inputs (the scene, camera and seed blocks, a target, the camera
Jacobian) through pinned memory instead: the copy is queued on the current
stream like a kernel, and PyTorch's caching host allocator keeps the pinned
buffer until the copy has run.
"""

from __future__ import annotations

import torch


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` (None: where it is). Host to card through pinned
    memory and a copy that does not wait; card to card without a wait; to
    the host it waits for the card, as it must to read the values."""
    if device is None:
        return t
    device = torch.device(device)
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, non_blocking=t.device.type == "cuda" and device.type == "cuda")
