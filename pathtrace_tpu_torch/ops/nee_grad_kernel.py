"""The NEE diffuse gradient kernel and its plain PyTorch versions.

The counterpart of ``pathtrace_tpu/ops/pallas_nee_grad.py``. ``csrc/
nee_grad_kernel.cu`` replaces its TPU kernel ``_nee_grad_kernel`` (K3): a
thread per pixel retraces its samples' NEE paths with the forward kernel's
own segment, tapes what cannot be recomputed, and runs the hand-derived
reverse sweep for ALL parameters: each sphere's radius, position, emission
and albedo, the eye and the four corner rays. Two modes:

- ``"fused"``: loss and gradients of the squared pixel error against a
  target, and the mean colour, in one launch: each thread loops over its
  pixel's samples twice, colour first, then the replay sweep against the
  pixel's own cotangent.
- ``"replay"``: gradients of ``sum(cotangent * colour sum)`` for a given
  per-pixel cotangent [h, W, 3]. Given a ``sweep.PathTape`` that K1's taped
  colour pass filled for the same slab, the replay sweeps the paths stored
  there instead of tracing them again (the kernel's REPLAY_TAPED instance),
  with the same bits: the inverse step's route (``grad_kernel.cross_grads``).

``fused`` and ``replay`` are the wrappers. On the CPU they run
``fused_plain`` and ``replay_plain`` (the shared plain sweep of
``ops/sweep.py``, which also holds their sums' layout, the agreement rules
and the path tape); on a CUDA device they launch the kernel, or raise.
``replay_color`` takes the cotangent of the spp-mean colour and folds 1/spp
in: ``grad_kernel``'s replay of NEE diffuse configurations.

Entry points (the JAX package's names, plus ``device=``):
``nee_loss_and_grads`` and ``nee_grads_block_slab`` (rows and samples at an
offset: the sharding hook).
"""

from __future__ import annotations

import ctypes

import torch

from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import sweep
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.ops.build import CSRC, load_function
from pathtrace_tpu_torch.utils import timing

SOURCE = CSRC / "nee_grad_kernel.cu"
MODES = ("fused", "replay")


def require_nee_diffuse(cfg: RenderConfig, what: str):
    if not cfg.nee or cfg.brdf != "diffuse":
        raise ValueError(f"{what} needs nee=True and brdf='diffuse', got nee={cfg.nee}, "
                         f"brdf={cfg.brdf!r}")



# -- the plain versions ----------------------------------------------------------

def fused_plain(scene_block, cam_block, seed, cfg: RenderConfig, target, *, local_h: int,
                spp: int, device=None):
    """Plain fused mode -> (sums [10N + 16], colour [local_h, W, 3]): the
    gradient of sum((mean - target)^2) and, last, that loss; no 1/denom."""
    require_nee_diffuse(cfg, "fused_plain")
    lat = tk.PlainLattice(scene_block, cam_block, seed, cfg, local_h, device)
    inv_spp = tk._f32(1.0 / spp)
    col_sum = [torch.zeros_like(lat.rows)] * 3
    for s in range(spp):
        col, *_ = lat.sample(s, cfg)
        col_sum = [a + b for a, b in zip(col_sum, col)]
    mean = [x * inv_spp for x in col_sum]
    res = [m - t for m, t in zip(mean, target.unbind(-1))]
    shade, geom = sweep._sweep_plain(lat, cfg, spp, [2.0 * r * inv_spp for r in res])
    loss = res[0] * res[0] + res[1] * res[1] + res[2] * res[2]
    return sweep._flat_sums(len(lat.sc), shade, geom, loss), torch.stack(mean, dim=-1)


def replay_plain(scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *, local_h: int,
                 spp: int, device=None):
    """Plain replay mode -> sums [10N + 16] (0 in the loss slot): the gradient
    of sum(cotangent * colour sum), ``cotangent`` [local_h, W, 3] with 1/spp
    folded in by the caller."""
    require_nee_diffuse(cfg, "replay_plain")
    lat = tk.PlainLattice(scene_block, cam_block, seed, cfg, local_h, device)
    shade, geom = sweep._sweep_plain(lat, cfg, spp, list(cotangent.unbind(-1)))
    return sweep._flat_sums(len(lat.sc), shade, geom, torch.zeros_like(lat.rows))


# -- the CUDA kernel -------------------------------------------------------------

class CudaNeeGradKernel:
    """ctypes binding of ``pt_nee_grad_launch``; each ``launch`` counts as
    ``"k3.<mode>"`` in ``timing``'s launch counts, a replay that reads a path
    tape also as ``"k3.replay_taped"``."""

    def __init__(self):
        self._lib = None  # keeps the library loaded while _fn is in use
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._lib, self._fn = load_function(SOURCE, "pt_nee_grad_launch_padded", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ])
        return self._fn

    def occupancy(self, mode: str, block: int, num_spheres: int, pad_shared: int = 0,
                  taped: bool = False) -> dict:
        """What the card gives a ``block`` x ``block`` launch of ``mode`` (the
        replay: taped or not) that asks for ``pad_shared`` dynamic shared
        bytes beyond its own: resident blocks an SM, registers a thread,
        dynamic shared bytes a block, local bytes a thread."""
        self._function()
        out = (ctypes.c_int * 4)()
        err = self._lib.pt_nee_grad_occupancy(_c_mode(mode, taped), block, num_spheres,
                                              pad_shared, out)
        if err != 0:
            raise RuntimeError(f"NEE grad kernel occupancy query failed: cudaError {err}")
        return dict(zip(("blocks_per_sm", "registers", "shared_bytes", "local_bytes"), out))

    def launch(self, mode: str, scene_block, cam_block, seed, cfg: RenderConfig, pixels, *,
               local_h: int, spp: int, device: torch.device, pad_shared: int = 0, tape=None):
        """Launch ``mode`` on the current stream of ``device`` (asynchronous).
        fused -> (sums, colour); replay -> sums. ``pad_shared``: dynamic
        shared bytes to ask for beyond the block's own, so that fewer blocks
        fit an SM; only the occupancy curve of ``scripts/
        torch_sweep_occupancy.py`` and ``chip_smoke.py`` passes it. ``tape``:
        the replay's ``PathTape``, checked by ``replay``."""
        t0 = timing.launch_clock()
        fn = self._function()
        held, scene_at, cam_at, seed_at = tk.launch_operands(scene_block, cam_block, seed,
                                                              device)
        n_out = 10 * scene_block.shape[0] + 16
        w, block = cfg.width, cfg.block
        color = None
        if mode == "fused":
            color = torch.empty((local_h, w, 3), dtype=torch.float32, device=device)
        n_blocks = -(-w // block) * -(-local_h // block)
        partial = torch.empty((n_blocks, n_out), dtype=torch.float64, device=device)
        sums = torch.empty((n_out,), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(
                scene_at, scene_block.shape[0], cam_at, seed_at, local_h, w,
                tk._f32(1.0 / w), tk._f32(1.0 / cfg.height),
                spp, tk._f32(1.0 / spp), cfg.max_bounces, int(cfg.resolved_jitter),
                cfg.push_ray_origin, cfg.light_index, _c_mode(mode, tape is not None), block,
                pixels.data_ptr(),
                None if color is None else color.data_ptr(), partial.data_ptr(),
                sums.data_ptr(), stream, pad_shared,
                None if tape is None else tape.words.data_ptr(),
            )
        if err != 0:
            raise RuntimeError(f"NEE grad kernel ({mode}) launch failed: cudaError {err}")
        timing.count_launch(f"k3.{mode}", t0, taped=tape is not None)
        return (sums, color) if mode == "fused" else sums


def _c_mode(mode: str, taped: bool) -> int:
    """The C entry's mode: 0 fused, 1 replay, 2 the taped replay."""
    if taped and mode != "replay":
        raise ValueError(f"only the replay reads a path tape, not {mode!r}")
    return 2 if taped else MODES.index(mode)


CUDA_KERNEL = CudaNeeGradKernel()


def _check(scene_block, cam_block, seed, cfg: RenderConfig, local_h, spp, pixels, dev, what):
    require_nee_diffuse(cfg, what)
    tk.check_blocks(scene_block, cam_block, seed, cfg, local_h, spp)
    if cfg.max_bounces > sweep.MAX_BOUNCES:
        raise ValueError(f"the NEE gradient kernel takes at most {sweep.MAX_BOUNCES} bounces, "
                         f"got {cfg.max_bounces}")
    shape = (local_h, cfg.width, 3)
    if pixels.dtype != torch.float32 or tuple(pixels.shape) != shape:
        raise ValueError(f"per-pixel input must be float32 {shape}, got "
                         f"{pixels.dtype} {tuple(pixels.shape)}")
    if not pixels.is_contiguous():
        raise ValueError("per-pixel input must be contiguous")
    if pixels.device != dev:
        raise ValueError(f"per-pixel input is on {pixels.device}, the launch on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no NEE gradient kernel for device {dev}")


def fused(scene_block, cam_block, seed, cfg: RenderConfig, target, *, local_h: int, spp: int,
          device=None):
    """The fused-mode wrapper -> (sums [10N + 16], colour [local_h, W, 3]) on
    ``device`` (default: the blocks'). CPU: the plain version. CUDA: the
    kernel, or an exception."""
    dev = tk.launch_device(scene_block, device)
    _check(scene_block, cam_block, seed, cfg, local_h, spp, target, dev, "fused")
    kw = dict(local_h=local_h, spp=spp, device=dev)
    if dev.type == "cpu":
        return fused_plain(scene_block, cam_block, seed, cfg, target, **kw)
    return CUDA_KERNEL.launch("fused", scene_block, cam_block, seed, cfg, target, **kw)


def replay(scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *, local_h: int,
           spp: int, device=None, tape: sweep.PathTape | None = None):
    """The replay-mode wrapper -> sums [10N + 16] (0 in the loss slot).
    ``tape``: the ``sweep.PathTape`` that K1's taped colour pass wrote with the same
    blocks, seed and sizes, whose paths the kernel sweeps instead of tracing
    them again (on the card only; the same bits)."""
    dev = tk.launch_device(scene_block, device)
    _check(scene_block, cam_block, seed, cfg, local_h, spp, cotangent, dev, "replay")
    kw = dict(local_h=local_h, spp=spp, device=dev)
    if tape is not None:
        tape.check(cfg, local_h, spp, dev, written=True)
        return CUDA_KERNEL.launch("replay", scene_block, cam_block, seed, cfg, cotangent,
                                  tape=tape, **kw)
    if dev.type == "cpu":
        return replay_plain(scene_block, cam_block, seed, cfg, cotangent, **kw)
    return CUDA_KERNEL.launch("replay", scene_block, cam_block, seed, cfg, cotangent, **kw)


def replay_color(scene_block, cam_block, seed, cfg: RenderConfig, ct, *, local_h: int,
                 spp: int, device=None, tape: sweep.PathTape | None = None):
    """``replay`` against ``ct`` [local_h, W, 3], the cotangent of the
    cfg.spp-sample MEAN colour, which the kernel takes per sample: 1/cfg.spp
    is folded in here -> sums [10N + 16]."""
    return replay(scene_block, cam_block, seed, cfg, tk._per_pixel(ct, device) / cfg.spp,
                  local_h=local_h, spp=spp, device=device, tape=tape)


# -- entry points (the JAX package's signatures, plus a device) ---------------------

def nee_loss_and_grads(scene, cam, cfg: RenderConfig, frame, target, device=None):
    """(loss, (d_scene, d_camera)) of the mean-squared pixel colour loss for an
    NEE diffuse config, all parameters: one fused launch."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    sums, _ = fused(sb, cb, tk.make_seed_block(cfg, frame), cfg, tk._per_pixel(target, device),
                    local_h=cfg.height, spp=cfg.spp, device=device)
    block = sweep.block_from_sums(sums) / (cfg.height * cfg.width * 3)
    loss = block[scene.num_objects, sweep.LOSS_COL]
    return loss, sweep.grads_from_block(scene, cam, cfg, block)


def nee_grads_block_slab(scene, cam, cfg: RenderConfig, frame, ct_block, row_offset=0,
                         local_h=None, spp=None, sample_offset=0, device=None):
    """Gradient block [N + 5, 11] of rows [row_offset, row_offset + local_h)
    and samples [sample_offset, sample_offset + spp) against a known
    per-SAMPLE colour cotangent ``ct_block`` [3, local_h, W] (1/global-spp
    folded in by the caller): one replay launch. Blocks of different slabs
    and sample ranges add up to the frame's."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    local_h = cfg.height if local_h is None else local_h
    ct = tk._per_pixel(ct_block, device).permute(1, 2, 0).contiguous()
    sums = replay(sb, cb, tk.make_seed_block(cfg, frame, sample_offset, row_offset), cfg, ct,
                  local_h=local_h, spp=cfg.spp if spp is None else spp, device=device)
    return sweep.block_from_sums(sums)

