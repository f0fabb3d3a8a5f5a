"""Debug / sanitizer mode.

The counterpart of ``pathtrace_tpu.utils.debug`` (the reference has only its
``gpuErrchk`` exit-on-error macro, ``include/CudaErrorCheck.h:6-14``).
``debug_mode`` turns on ``torch.autograd``'s anomaly detection, which raises
at the first backward operation that produces a NaN and names the forward
operation behind it. ``checked_render`` renders and checks the renderer's
invariants on the AOVs, as ``checkify`` does there: finite colour, normal
and albedo; non-negative variances; mean normals no longer than 1.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Context: autograd anomaly detection on (``nans``) or off inside the
    block; the previous state is restored after it."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(nans)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


class CheckError:
    """The violated invariants of one checked render, in the order checked
    (empty: none); ``throw`` raises on the first."""

    def __init__(self, messages: List[str]):
        self.messages = messages

    def get(self) -> Optional[str]:
        return self.messages[0] if self.messages else None

    def throw(self) -> None:
        if self.messages:
            raise RuntimeError(self.messages[0])


def checked_render(scene, cam, cfg, frame=0, device=None):
    """Render on ``device`` (default: the current CUDA device) and check
    finite channels, non-negative variances and unit-or-zero mean normals.
    Returns (error, aovs); ``error.throw()`` raises on a violation."""
    from pathtrace_tpu_torch.render import render_aovs

    aovs = render_aovs(scene, cam, cfg, frame, device)
    checks = [(f"non-finite values in {k}", torch.isfinite(aovs[k]).all())
              for k in ("color", "normal", "albedo")]
    checks += [(f"negative variance in {k}", (aovs[k] >= 0.0).all())
               for k in ("color_var", "normal_var", "albedo_var", "depth_var")]
    norms = torch.linalg.vector_norm(aovs["normal"], dim=-1)
    checks.append(("mean normal norm exceeds 1", (norms <= 1.0 + 1e-3).all()))
    # One copy to the host for all seven checks.
    ok = torch.stack([passed for _, passed in checks]).cpu().tolist()
    return CheckError([msg for (msg, _), good in zip(checks, ok) if not good]), aovs
