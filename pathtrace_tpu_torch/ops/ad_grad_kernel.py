"""The all-parameter backward kernel for any configuration, and its plain
PyTorch version.

The counterpart of ``pathtrace_tpu/ops/pallas_ad.py``. ``csrc/
ad_grad_kernel.cu`` replaces its TPU kernel ``_ad_grad_kernel`` (K4), which
is ``jax.vjp`` of the forward trajectory inside the kernel body. CUDA has no
in-kernel AD, so the CUDA kernel is that vjp derived by hand: the reverse
sweep of ``csrc/sweep.cuh`` (shared with the NEE diffuse kernel,
``ops/nee_grad_kernel.py``; its Python side is ``ops/sweep.py``),
instantiated for diffuse and glossy, with and without NEE. For a slab of
rows and a range of samples it gives the gradient, with respect to every
sphere's radius, position, emission and albedo, the eye and the four corner
rays, of

    sum over pixels and samples of
        ct[0:3] . colour + ct[3:6] . normal0 + ct[6:9] . albedo0 + ct[9] * depth0

for a 10-channel per-pixel cotangent ``ct`` [10, h, W] (1/spp folded in by
the caller); normal0, albedo0 and depth0 are a sample's bounce-0 AOVs, zero
where the primary ray escapes. A colour-only cotangent is ``ct`` [3, h, W].
Hit selection, near or far root, normal flip, shadow visibility and every
random draw are detached, as under jnp AD. Without NEE and with a
colour-only cotangent the geometry and camera sums are exact zeros:
``instance`` then picks the kernel's shading-only instance, which runs the
shading chain alone and gives the full instance's shading sums bit for bit.

``replay`` is the wrapper. On the CPU it runs ``replay_plain``, the kernel's
formulas in the kernel's order over [h, W] tensors on ``trace_kernel``'s
plain trajectory (no autograd), summing over pixels in double as the kernel
does; on a CUDA device it launches the kernel, or raises. Under NEE glossy
with a colour cotangent it takes a ``sweep.PathTape`` that K1's taped colour
pass wrote for the same slab, whose paths the kernel sweeps instead of
tracing them again (its REPLAY_TAPED instance, the same bits): the glossy
inverse step's route (``grad_kernel.cross_grads``). Both give the flat sums
[10N + 16] of ``ops/sweep.py`` (0 in the loss slot), and ``block_from_sums``
/ ``grads_from_block`` there turn them into the JAX package's gradient
block and into (d_scene, d_camera). ``replay_color`` takes the cotangent of
the spp-mean colour [h, W, 3] and lays it out as the kernel's
(``pack_cotangents``): ``grad_kernel``'s replay of glossy configurations.

Entry points (the JAX package's names, plus ``device=``):
``pack_cotangents``, ``ad_grads_block_slab`` (rows and samples at an offset:
the sharding hook), ``ad_aov_grads``, ``ad_loss_and_grads``.
"""

from __future__ import annotations

import ctypes

import torch

from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import sweep
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.ops.build import CSRC, load_function
from pathtrace_tpu_torch.render import resolve_device
from pathtrace_tpu_torch.utils import timing

SOURCE = CSRC / "ad_grad_kernel.cu"
NUM_CT = 10  # cotangent channels: colour 3, normal 3, albedo 3, depth 1
NUM_CT_COLOR = 3  # a colour-only cotangent
# The JAX package's gradient block has 16 rows for N + 5 of them. With 11
# spheres the sums and sphere table of the largest block (16 x 16 threads:
# 95,672 bytes) fit a block's shared memory, so no launch is refused for
# that.
MAX_SPHERES = 11


def instance(cfg: RenderConfig, num_ct: int) -> dict:
    """The kernel instance of a configuration and a cotangent of ``num_ct``
    channels: ``glossy``, ``nee``, ``aov`` (the bounce-0 AOV cotangents are
    read) and ``geom`` (the geometry chain runs: under NEE or with AOV
    cotangents; else the shading-only instance)."""
    if num_ct not in (NUM_CT_COLOR, NUM_CT):
        raise ValueError(f"a cotangent has {NUM_CT_COLOR} or {NUM_CT} channels, got {num_ct}")
    aov = num_ct == NUM_CT
    return dict(glossy=cfg.brdf == "glossy", nee=cfg.nee, aov=aov, geom=cfg.nee or aov)


# -- the plain version ---------------------------------------------------------

def replay_plain(scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *, local_h: int,
                 spp: int, device=None):
    """The plain version -> sums [10N + 16] (0 in the loss slot): the gradient
    of sum over pixels and samples of ``cotangent`` [10, local_h, W] against
    a sample's (colour, normal0, albedo0, depth0), or of ``cotangent``
    [3, local_h, W] against its colour."""
    lat = tk.PlainLattice(scene_block, cam_block, seed, cfg, local_h, device)
    planes = list(cotangent.unbind(0))
    shade, geom = sweep._sweep_plain(lat, cfg, spp, planes[:3], planes[3:] or None)
    return sweep._flat_sums(len(lat.sc), shade, geom, torch.zeros_like(lat.rows))


# -- the CUDA kernel -----------------------------------------------------------

class CudaAdGradKernel:
    """ctypes binding of ``pt_ad_grad_launch``; each ``launch`` counts as
    ``"k4.replay"`` in ``timing``'s launch counts, one that reads a path tape
    also as ``"k4.replay_taped"``."""

    def __init__(self):
        self._lib = None  # keeps the library loaded while _fn is in use
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._lib, self._fn = load_function(SOURCE, "pt_ad_grad_launch", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ])
        return self._fn

    def occupancy(self, glossy: bool, nee: bool, aov: bool, block: int,
                  num_spheres: int, taped: bool = False) -> dict:
        """What the card gives a ``block`` x ``block`` launch of the instance
        (taped: the NEE glossy colour one that reads a path tape): resident
        blocks an SM, registers a thread, dynamic shared bytes a block, local
        bytes a thread."""
        self._function()
        out = (ctypes.c_int * 4)()
        err = self._lib.pt_ad_grad_occupancy(int(glossy), int(nee), int(aov), int(taped), block,
                                             num_spheres, out)
        if err != 0:
            raise RuntimeError(f"AD grad kernel occupancy query failed: cudaError {err}")
        return dict(zip(("blocks_per_sm", "registers", "shared_bytes", "local_bytes"), out))

    def instances(self, block: int, num_spheres: int) -> dict:
        """``occupancy`` of all eight instances, by name."""
        out = {}
        for glossy in (False, True):
            for nee in (False, True):
                for aov in (False, True):
                    name = (f"K4 {'nee_' if nee else ''}{'glossy' if glossy else 'diffuse'} "
                            f"{'colour+aov' if aov else 'colour'}"
                            f"{'' if nee or aov else ' (shading only)'}")
                    out[name] = self.occupancy(glossy, nee, aov, block, num_spheres)
        return out

    def launch(self, scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *,
               local_h: int, spp: int, device: torch.device, tape=None) -> torch.Tensor:
        """Launch on the current stream of ``device`` (asynchronous) -> sums.
        ``tape``: the ``PathTape`` to sweep, checked by ``replay``."""
        t0 = timing.launch_clock()
        fn = self._function()
        held, scene_at, cam_at, seed_at = tk.launch_operands(scene_block, cam_block, seed,
                                                              device)
        n_out = 10 * scene_block.shape[0] + 16
        w, block = cfg.width, cfg.block
        n_blocks = -(-w // block) * -(-local_h // block)
        partial = torch.empty((n_blocks, n_out), dtype=torch.float64, device=device)
        sums = torch.empty((n_out,), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(
                scene_at, scene_block.shape[0], cam_at, seed_at, local_h, w,
                tk._f32(1.0 / w), tk._f32(1.0 / cfg.height),
                spp, tk._f32(1.0 / spp), cfg.max_bounces, int(cfg.resolved_jitter),
                cfg.push_ray_origin, cfg.light_index if cfg.nee else -1,
                int(cfg.brdf == "glossy"), cotangent.shape[0], block, cotangent.data_ptr(),
                partial.data_ptr(),
                sums.data_ptr(), stream, None if tape is None else tape.words.data_ptr(),
            )
        if err != 0:
            raise RuntimeError(f"AD grad kernel launch failed: cudaError {err}")
        timing.count_launch("k4.replay", t0, taped=tape is not None)
        return sums


CUDA_KERNEL = CudaAdGradKernel()


def _check(scene_block, cam_block, seed, cfg: RenderConfig, local_h, spp, cotangent, dev):
    tk.check_blocks(scene_block, cam_block, seed, cfg, local_h, spp)
    n = scene_block.shape[0]
    if n > MAX_SPHERES:
        raise ValueError(f"the AD gradient kernel takes at most {MAX_SPHERES} spheres, got {n}")
    if cfg.max_bounces > sweep.MAX_BOUNCES:
        raise ValueError(f"the AD gradient kernel takes at most {sweep.MAX_BOUNCES} bounces, "
                         f"got {cfg.max_bounces}")
    shape = (NUM_CT, local_h, cfg.width)
    if cotangent.dtype != torch.float32 or tuple(cotangent.shape) not in (
            shape, (NUM_CT_COLOR, *shape[1:])):
        raise ValueError(f"cotangent must be float32 {shape} or, colour only, "
                         f"{(NUM_CT_COLOR, *shape[1:])}, got "
                         f"{cotangent.dtype} {tuple(cotangent.shape)}")
    if not cotangent.is_contiguous():
        raise ValueError("cotangent must be contiguous")
    if cotangent.device != dev:
        raise ValueError(f"cotangent is on {cotangent.device}, the launch on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no AD gradient kernel for device {dev}")


def replay(scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *, local_h: int,
           spp: int, device=None, tape=None):
    """The kernel wrapper -> sums [10N + 16] (0 in the loss slot) on ``device``
    (default: the blocks'). CPU: the plain version. CUDA: the kernel, or an
    exception. ``tape``: under NEE glossy with a colour cotangent, the
    ``PathTape`` that K1's taped colour pass wrote with the same blocks, seed
    and sizes, whose paths the kernel sweeps instead of tracing them again
    (on the card only; the same bits)."""
    dev = tk.launch_device(scene_block, device)
    _check(scene_block, cam_block, seed, cfg, local_h, spp, cotangent, dev)
    kw = dict(local_h=local_h, spp=spp, device=dev)
    if tape is not None:
        if not (cfg.nee and cfg.brdf == "glossy" and cotangent.shape[0] == NUM_CT_COLOR):
            raise ValueError(f"K4 reads a path tape under NEE glossy with a colour cotangent, "
                             f"got nee={cfg.nee}, brdf={cfg.brdf!r}, "
                             f"{cotangent.shape[0]} cotangent channels")
        tape.check(cfg, local_h, spp, dev, written=True)
        return CUDA_KERNEL.launch(scene_block, cam_block, seed, cfg, cotangent, tape=tape, **kw)
    if dev.type == "cpu":
        return replay_plain(scene_block, cam_block, seed, cfg, cotangent, **kw)
    return CUDA_KERNEL.launch(scene_block, cam_block, seed, cfg, cotangent, **kw)


def replay_color(scene_block, cam_block, seed, cfg: RenderConfig, ct, *, local_h: int,
                 spp: int, device=None, tape=None):
    """``replay`` against ``ct`` [local_h, W, 3], the cotangent of the
    cfg.spp-sample MEAN colour, laid out as the kernel's colour-only
    per-sample block [3, local_h, W] (``pack_cotangents``) -> sums
    [10N + 16]."""
    return replay(scene_block, cam_block, seed, cfg,
                  pack_cotangents(cfg, ct, local_h=local_h, device=device),
                  local_h=local_h, spp=spp, device=device, tape=tape)


# -- entry points (the JAX package's signatures, plus a device) -------------------

def pack_cotangents(cfg: RenderConfig, ct_color=None, ct_normal=None, ct_albedo=None,
                    ct_depth=None, local_h=None, spp=None, device=None) -> torch.Tensor:
    """Per-pixel cotangents of the spp-MEAN AOVs (colour, normal, albedo
    [h, W, 3], depth [h, W]; None is zero) -> the kernel's per-sample block
    [10, h, W], 1/spp folded in; with no normal, albedo or depth cotangent
    the colour-only block [3, h, W], and no planes of zeros are built."""
    h = cfg.height if local_h is None else local_h
    spp = cfg.spp if spp is None else spp
    if ct_normal is None and ct_albedo is None and ct_depth is None:
        if ct_color is None:
            return torch.zeros((NUM_CT_COLOR, h, cfg.width), dtype=torch.float32, device=device)
        return (tk._per_pixel(ct_color, device).permute(2, 0, 1) / spp).contiguous()
    block = torch.zeros((NUM_CT, h, cfg.width), dtype=torch.float32, device=device)
    for first, x in ((0, ct_color), (3, ct_normal), (6, ct_albedo)):
        if x is not None:
            block[first: first + 3] = tk._per_pixel(x, device).permute(2, 0, 1)
    if ct_depth is not None:
        block[9] = tk._per_pixel(ct_depth, device)
    return block / spp


def ad_grads_block_slab(scene, cam, cfg: RenderConfig, frame, ct_block, row_offset=0,
                        local_h=None, spp=None, sample_offset=0, device=None):
    """Gradient block [N + 5, 11] of rows [row_offset, row_offset + local_h)
    and samples [sample_offset, sample_offset + spp) against the per-SAMPLE
    cotangents ``ct_block`` [10, local_h, W], or [3, local_h, W] for colour
    only (1/global-spp folded in by the caller): one launch. Blocks of
    different slabs and sample ranges add up to the frame's."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    sums = replay(sb, cb, tk.make_seed_block(cfg, frame, sample_offset, row_offset), cfg,
                  tk._per_pixel(ct_block, device),
                  local_h=cfg.height if local_h is None else local_h,
                  spp=cfg.spp if spp is None else spp, device=device)
    return sweep.block_from_sums(sums)


def ad_aov_grads(scene, cam, cfg: RenderConfig, frame, ct_color=None, ct_normal=None,
                 ct_albedo=None, ct_depth=None, device=None):
    """(d_scene, d_camera) of sum over pixels of ct_color . colour + ct_normal .
    normal + ct_albedo . albedo + ct_depth * depth, the AOVs being the
    spp-mean channels: all parameters, any configuration, one launch."""
    device = resolve_device(device)
    ct = pack_cotangents(cfg, ct_color, ct_normal, ct_albedo, ct_depth, device=device)
    block = ad_grads_block_slab(scene, cam, cfg, frame, ct, device=device)
    return sweep.grads_from_block(scene, cam, cfg, block)


def ad_loss_and_grads(scene, cam, cfg: RenderConfig, frame, target, device=None):
    """(loss, (d_scene, d_camera)) of the mean-squared pixel colour loss for
    any configuration: one colour-sum launch of the forward kernel, then one
    replay launch against the loss's cotangent (``sweep.color_loss_replay``)."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    _, diff, sums = sweep.color_loss_replay(
        sb, cb, tk.make_seed_block(cfg, frame), cfg, tk._per_pixel(target, device),
        replay_color, local_h=cfg.height, spp=cfg.spp, device=device)
    block = sweep.block_from_sums(sums)
    loss = torch.sum(diff * diff) / (cfg.height * cfg.width * 3)
    return loss, sweep.grads_from_block(scene, cam, cfg, block)
