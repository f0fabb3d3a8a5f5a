"""The card's f32 speed of light for scalar code, and bounds from it.

The counterpart of ``pathtrace_tpu/utils/roofline.py``'s peak probe and of
``scripts/fma_probe.py``'s latency probe. The path tracer never touches the
tensor cores: every operation is a scalar f32 (or int32) instruction, so
the peak that bounds its kernels is the rate at which the card retires those,
measured on the card itself by ``csrc/probe_kernel.cu``:

- ``measure_f32_peak`` (K6, ``_chain_kernel``/``measure_vpu_peak``): 8
  independent register chains a thread, FMA and multiply only ->
  ``peak_fma_flops`` (2 FLOPs a step: the card's f32 peak, the denominator
  of a bound) and ``peak_mul_flops`` (1 a step: the rate of single
  operations, the most a kernel built without FMA contraction can reach);
- ``latency_probe`` (K7, ``pallas_latency_probe``): one dependent chain a
  thread in six modes -> nanoseconds a chain step.

``peak_chain`` and ``latency_chain`` are the kernel wrappers, each with a
launch counter. On the CPU they run ``chain_plain``, the same chain as a
torch loop; on a CUDA device they launch the kernel, or raise.

``bound_ms`` turns traced path segments and counted operations a segment
into the least time a kernel could take at a given peak. The JAX package
counts operations by walking the jaxpr of its kernels (``count_jaxpr_ops``);
that cannot exist without JAX, so the counts it recorded are kept here as
constants with their source, beside the counts that
``scripts/torch_count_ops.py`` takes from the plain versions of the
hand-derived sweeps. They are operation counts of the algorithm,
not timings of any device, and they count a multiply and an add as two
operations, as a peak in FLOP/s credits a fused multiply-add with two: so
the peak to divide them by is the FMA peak (``peak_fma_flops``, or the
card's published f32 FLOP/s), not the rate of single instructions.
``count_segments`` counts the segments a frame really traces: the kernels
stop a path at its first escape.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.ops.build import CSRC, load_function
from pathtrace_tpu_torch.utils.timing import best_seconds

SOURCE = CSRC / "probe_kernel.cu"
INNER = 32  # chain steps a trip (the kernel's kInner)
PEAK_CHAINS = 8
# The shapes of the two measurements: [grid * 64, 128] elements for
# ``iters`` trips (peak), [grid * 8, 128] for ``iters`` trips (latency).
PEAK_GRID, PEAK_ITERS = 2048, 256
LATENCY_GRID, LATENCY_ITERS = 8, 32768
LATENCY_MODES = ("mul", "add", "fma", "mul_then_add", "add_add", "fma_fma")
# Counted operations (f32 + int32 + transcendental) a path segment, from the
# jaxprs of the JAX package's kernels (docs/ROOFLINE.md sections 1 and 6,
# ``roofline.megakernel_ops`` and ``nee_kernel_ops``; 9 spheres, 5 bounces).
OPS_PER_SEGMENT = {
    "forward_diffuse": 568.0,  # the forward kernel, 14 channels
    "forward_nee": 898.0,  # the same with the shadow ray
    "color_nee": 877.8,  # colour-only forward under NEE
    # The glossy colour pass (K1, 3 channels), which no jaxpr counts: the
    # untaped forward of the plain version, by scripts/torch_count_ops.py.
    "color_glossy": 633.0,
    # The TPU's in-kernel-AD replay under NEE diffuse (docs/ROOFLINE.md section
    # 5): the code jax.vjp generates, not the hand-derived sweep.
    "ad_replay_nee_jaxpr": 1988.6,
    # The TPU's one-pass fused form of K3 (docs/ROOFLINE.md section 5a).
    "nee_grad_one_pass_jaxpr": 1973.6,
    # The port's gradient kernels, counted on their plain versions by
    # scripts/torch_count_ops.py with the same rules (9 spheres, 5 bounces):
    # a taped forward sample plus the sweep, each as the kernels do it: the
    # winner kept by its index and the sums indexed at run time (the plain
    # versions' masked select or add for each sphere is counted for one
    # sphere), each add into a lane group's sums a select, an add and, into
    # a double, a conversion.
    # The all-parameter backward (K4) against a colour + AOV cotangent:
    "ad_diffuse": 800.6,  # forward 566.8 + sweep 233.8
    "ad_nee": 1213.6,  # 900.8 + 312.8
    "ad_glossy": 918.2,  # 638.0 + 280.2
    "ad_nee_glossy": 1331.2,  # 972.0 + 359.2
    # ... against a colour cotangent alone: without NEE the shading-only
    # instance, whose tape is the index and the throughput; on NEE diffuse
    # also K3's replay, the same instance.
    "ad_diffuse_color": 607.4,  # 562.8 + 44.6
    "ad_nee_color": 1211.6,  # 900.8 + 310.8
    "ad_glossy_color": 678.6,  # 634.0 + 44.6
    "ad_nee_glossy_color": 1329.2,  # 972.0 + 357.2
    # K3 fused as the kernel runs it: a colour pass over the pixel's samples
    # (890.8), then the replay ...
    "nee_grad_two_pass": 2102.4,
    # ... and what its bound is taken from: the loss and its gradients need
    # one pass, so the smaller of the two-pass and the one-pass count.
    "nee_grad_fused": 1973.6,
    # The product-chain kernel: K2 fused and dump (cotangent-free
    # accumulators), K5 replay.
    "grad_fused": 605.6,  # 562.8 + 42.8
    "grad_replay": 608.0,  # 562.8 + 45.2
}


def bound_ms(segments: float, ops_per_segment: float, peak_ops_per_s: float) -> float:
    """The least milliseconds for ``segments`` path segments of
    ``ops_per_segment`` operations each at ``peak_ops_per_s``."""
    if peak_ops_per_s <= 0:
        raise ValueError(f"peak must be positive, got {peak_ops_per_s}")
    return 1e3 * segments * ops_per_segment / peak_ops_per_s


def count_segments(scene, cam, cfg: RenderConfig, frame=0, device=None) -> int:
    """Path segments the kernels trace for this frame: every sample's primary
    ray, and one more for each bounce that hit and is not the last. Counted
    with the kernels' plain trajectory (``trace_kernel.PlainLattice``)."""
    sb, cb, device = tk.host_blocks(scene, cam, cfg, device)
    lat = tk.PlainLattice(sb, cb, tk.make_seed_block(cfg, frame), cfg, cfg.height, device)
    if cfg.max_bounces < 1:
        return 0
    total = torch.zeros((), dtype=torch.int64, device=lat.rows.device)
    for s in range(cfg.spp):
        tape = []
        lat.sample(s, cfg, tape)
        total += lat.rows.numel()
        for hit, *_ in tape[:-1]:
            total += hit.sum()
    return int(total)


# -- the plain version -------------------------------------------------------------

def _step_plain(mode: str, x, a, b, c, b64, c64):
    """One chain step of ``mode``. ``b64``, ``c64``: b and c in double, where
    the fused modes add; ``chain_plain`` converts them once, not at each step."""
    def fma(p, q, r64):  # one rounding: the product is exact in double
        return torch.addcmul(r64, p.double(), q).float()

    if mode == "mul":
        return x * a
    if mode == "add":
        return x + b
    if mode == "fma":
        return fma(x, a, b64)
    if mode == "mul_then_add":
        return x * a + b
    if mode == "add_add":
        return (x + b) + c
    if mode == "fma_fma":
        return fma(fma(x, a, b64), a, c64)
    raise ValueError(f"mode must be one of {LATENCY_MODES}, got {mode!r}")


def chain_plain(x: torch.Tensor, a: torch.Tensor, mode: str, iters: int, chains: int):
    """The kernel's chains as a torch loop -> the sum of the ``chains`` chains
    after ``iters * INNER`` steps each. The fused steps round once, through
    double (off from a true FMA only where the double sum itself ties)."""
    b, c = x * np.float32(1e-7), x * np.float32(1e-9)
    scale = [np.float32(1.0) + np.float32(0.001) * np.float32(j) for j in range(chains)]
    xs = [x * float(s) for s in scale]
    b64, c64 = b.double(), c.double()
    for _ in range(iters * INNER):
        xs = [_step_plain(mode, xc, a, b, c, b64, c64) for xc in xs]
    acc = xs[0]
    for xc in xs[1:]:
        acc = acc + xc
    return acc


# -- the CUDA kernel ---------------------------------------------------------------

class CudaProbeKernel:
    """ctypes binding of ``pt_probe_launch``. ``launches`` counts the kernel
    launches by probe: ``"peak"`` (8 chains) and ``"latency"`` (1 chain)."""

    def __init__(self):
        self._lib = None  # keeps the library loaded while _fn is in use
        self._fn = None
        self.launches = {"peak": 0, "latency": 0}

    def _function(self):
        if self._fn is None:
            self._lib, self._fn = load_function(SOURCE, "pt_probe_launch", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ])
        return self._fn

    def launch(self, x, a, mode: str, iters: int, chains: int) -> torch.Tensor:
        fn = self._function()
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), a.data_ptr(), out.data_ptr(), x.numel(), iters,
                     LATENCY_MODES.index(mode), chains, stream)
        if err != 0:
            raise RuntimeError(f"probe kernel ({mode}, {chains} chains) launch failed: "
                               f"cudaError {err}")
        self.launches["latency" if chains == 1 else "peak"] += 1
        return out


CUDA_KERNEL = CudaProbeKernel()


def _chain(x, a, mode, iters, chains):
    if mode not in LATENCY_MODES:
        raise ValueError(f"mode must be one of {LATENCY_MODES}, got {mode!r}")
    for name, t in (("x", x), ("a", a)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if x.shape != a.shape or x.device != a.device or x.numel() < 1:
        raise ValueError("x and a must be non-empty, of one shape, on one device")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return chain_plain(x, a, mode, iters, chains)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    return CUDA_KERNEL.launch(x, a, mode, iters, chains)


def peak_chain(x: torch.Tensor, a: torch.Tensor, fma: bool, iters: int) -> torch.Tensor:
    """K6's wrapper: ``PEAK_CHAINS`` independent chains an element, FMA or
    multiply only. CPU: the plain version. CUDA: the kernel, or an exception."""
    return _chain(x, a, "fma" if fma else "mul", iters, PEAK_CHAINS)


def latency_chain(x: torch.Tensor, a: torch.Tensor, mode: str, iters: int) -> torch.Tensor:
    """K7's wrapper: one dependent chain an element in ``mode``."""
    return _chain(x, a, mode, iters, 1)


# -- the measurements ----------------------------------------------------------------

def probe_inputs(rows: int, device):
    """x of ones and a just below one, [rows, 128]: the chains neither grow
    nor vanish over the probes' step counts."""
    x = torch.ones((rows, 128), dtype=torch.float32, device=device)
    return x, torch.full_like(x, 0.9999999)


def measure_f32_peak(iters: int = PEAK_ITERS, grid: int = PEAK_GRID, reps: int = 3,
                     device=None) -> Dict[str, float]:
    """The card's f32 speed of light for elementwise chains: FLOP/s of pure
    FMA chains (2 FLOPs a step) and of multiply-only chains (1 a step: the
    rate of single operations). ``grid * 64 * 128`` elements, a thread each, best of
    ``reps`` CUDA-event-timed launches. With ``device="cpu"`` the plain
    version, by the host clock (``timing.best_seconds``)."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    x, a = probe_inputs(grid * 64, device)
    out = {}
    for fma in (True, False):
        best = best_seconds(lambda: peak_chain(x, a, fma, iters), reps, device)
        steps = x.numel() * iters * INNER * PEAK_CHAINS
        out["peak_fma_flops" if fma else "peak_mul_flops"] = steps * (2 if fma else 1) / best
    return out


def latency_probe(iters: int = LATENCY_ITERS, grid: int = LATENCY_GRID, reps: int = 3,
                  device=None) -> Dict[str, float]:
    """Nanoseconds a dependent chain step, by mode: one chain a thread,
    ``grid * 8 * 128`` threads (few warps an SM, all resident at once, so a
    thread's own ``iters * INNER`` steps divide the time). If the card fuses
    ``x * a + b`` its step costs one instruction's latency; written as a
    multiply then an add, the sum of two."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    x, a = probe_inputs(grid * 8, device)
    return {mode: best_seconds(lambda: latency_chain(x, a, mode, iters), reps, device)
            / (iters * INNER) * 1e9 for mode in LATENCY_MODES}
