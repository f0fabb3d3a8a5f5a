"""pathtrace_tpu_torch: the path tracer in PyTorch and CUDA for NVIDIA Hopper.

The port of ``pathtrace_tpu`` (JAX/Pallas on a TPU), which stays the
reference. It renders the 14-channel AOV buffer of sphere scenes (colour,
normal, albedo, depth means and four luminance variances) with a
hand-written CUDA kernel (``csrc/trace_kernel.cu``) or a plain PyTorch
wavefront, and writes EXR and bitmaps. It differentiates the render with
respect to the scene and the camera (``grad.py``: hand-written CUDA
gradient kernels for the diffuse estimators, ``csrc/grad_kernel.cu``
without NEE and ``csrc/nee_grad_kernel.cu`` with it, geometry and camera
gradients included; autograd through the wavefront otherwise) and recovers
scene parameters from a target image (``inverse.py``). It denoises the
frame with the FPN CNN (``models/``: ``torch.nn``, cuDNN on the card),
accumulates frames progressively (``progressive.py``) and runs the
interactive loop and the browser viewer (``interactive.py``, ``viewer.py``).
It renders training pairs and cuts importance-sampled patches (``data/``),
trains the denoiser (``train.py``: Nesterov SGD, the reference's plateau
schedule, checkpoints with the optimiser's state, the training CLI) and
reads and writes EXR and BMP through a small C++ library where g++ and zlib
build it (``io/native.py``), in Python otherwise. ``utils/roofline.py``
measures the card's f32 peak and latencies (``csrc/probe_kernel.cu``). It
imports torch and numpy, never jax.

Every entry point runs on the current CUDA device unless it is given
``device="cpu"`` (``render.resolve_device``); with no CUDA device and no
device given it raises.
"""

__version__ = "0.1.0"

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.grad import (
    render_color,
    render_geometry_grads,
    render_loss_grads,
    render_scalar_grads,
)
from pathtrace_tpu_torch.inverse import make_inverse_step, recover_scene
from pathtrace_tpu_torch.render import render_aovs, render_channels
from pathtrace_tpu_torch.scene import Scene, cornell_box

__all__ = [
    "RenderConfig",
    "Scene",
    "cornell_box",
    "Camera",
    "render_aovs",
    "render_channels",
    "render_color",
    "render_loss_grads",
    "render_scalar_grads",
    "render_geometry_grads",
    "make_inverse_step",
    "recover_scene",
]
