"""The diffuse gradient kernels and their plain PyTorch versions.

The counterpart of ``pathtrace_tpu/ops/pallas_grad.py``. ``csrc/
grad_kernel.cu`` replaces its two TPU kernels with one CUDA kernel in three
modes, each a thread per pixel that retraces its samples' paths with the
forward kernel's own code and runs the reverse product-chain sweep:

- ``"fused"`` (``_fused_loss_grad_kernel``, K2): loss, d emission and d
  albedo of the mean-squared pixel loss against a target, and the mean
  colour, in one trajectory pass;
- ``"dump"`` (the same kernel's dump mode): the mean colour [h, W, 3] and
  the per-pixel, cotangent-free accumulators [h, W, 6N], which ``contract``
  turns into the gradient of ``sum(ct * colour)`` for any cotangent;
- ``"replay"`` (``_color_grad_kernel``, K5): d emission and d albedo of
  ``sum(ct * colour)`` for a given per-pixel cotangent.

``fused``, ``dump`` and ``replay`` are the wrappers. On the CPU they run
``fused_plain``, ``dump_plain`` and ``replay_plain``, a direct transcription
of the kernel over [h, W] tensors on top of ``trace_kernel``'s plain
trajectory; on a CUDA device they launch the kernel, or raise. The kernel
sums over pixels with per-block partials and a fixed-order second pass, so
two runs give the same bits. ``agreement`` holds two outputs of one mode
against each other under the tolerances stated with it.

The estimator of these three modes is diffuse without NEE: a sample's
colour is then a product chain in the hit spheres' emission and albedo, and
its gradient with respect to positions, radii and the camera is exactly
zero. NEE diffuse has its own kernel, ``ops/nee_grad_kernel.py`` (K3: all
parameters, geometry and camera included), and glossy, with or without
NEE, goes to the all-parameter backward of ``ops/ad_grad_kernel.py`` (K4).
This module is the one seam between a configuration and those kernels
(``route``), as ``pallas_grad.py`` dispatches; none of its entry points
raises for a configuration. Two choices are made here, each in one
function:

- the replay against a colour cotangent, ``_replay_sums``: K3's replay for
  NEE diffuse, K4's for glossy, each through its wrapper's ``replay_color``,
  which takes the cotangent of the spp-mean colour [h, W, 3] and puts it in
  its kernel's layout;
- the loss and its gradients, ``_loss_grads``: one K2 fused launch
  (diffuse), one K3 fused launch (NEE diffuse), or K1's colour pass and
  the replay (glossy, ``sweep.color_loss_replay``).

Entry points (the JAX package's names, plus ``device=``): ``grad_acc_slab``
and ``render_grad_acc`` (diffuse without NEE only: the accumulators exist
for the product chain alone); ``fused_loss_grads``, ``render_color_grads``,
``cross_grads`` (with ``cross_contract``, its arithmetic after two dumps),
``loss_and_grads`` and ``render_color``, a differentiable colour render,
each with one branch between the product chain (``on_chain``) and the
replay.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import sweep
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.ops.build import CSRC, load_function
from pathtrace_tpu_torch.ops.sampling import clip01_grad
from pathtrace_tpu_torch.render import resolve_device
from pathtrace_tpu_torch.scene import Scene
from pathtrace_tpu_torch.utils import timing

SOURCE = CSRC / "grad_kernel.cu"
MODES = ("fused", "dump", "replay")
MAX_BOUNCES = 16  # the kernel's tape holds 4 bits a bounce in 64 bits
# Sample lanes a pixel at most: the lanes' reverse sweeps take turns, so
# four lanes serialise more than they fill (PERF.md, PR 6).
MAX_LANES = 2


def require_diffuse(cfg: RenderConfig, what: str):
    """Raise for what the product-chain kernels of this module do not cover."""
    if cfg.nee or cfg.brdf != "diffuse":
        raise ValueError(f"{what}: the product-chain kernels cover diffuse without NEE, got "
                         f"nee={cfg.nee}, brdf={cfg.brdf!r}; NEE diffuse goes through "
                         "ops/nee_grad_kernel.py, glossy through ops/ad_grad_kernel.py")


def route(cfg: RenderConfig) -> str:
    """The gradient kernel of a configuration: ``"chain"`` (K2/K5, diffuse),
    ``"nee"`` (K3, NEE diffuse) or ``"ad"`` (K4, glossy with or without
    NEE)."""
    if cfg.brdf != "diffuse":
        return "ad"
    return "nee" if cfg.nee else "chain"


def on_chain(cfg: RenderConfig) -> bool:
    """Whether the product-chain modes of this module serve ``cfg``'s
    gradients (diffuse without NEE); else a replay of K3 or K4 does."""
    return route(cfg) == "chain"


# -- the plain versions ----------------------------------------------------------

def _sweep_plain(scene_block, cam_block, seed, cfg: RenderConfig, local_h: int, spp: int,
                 device, ct=None):
    """The kernel's per-pixel loop over [local_h, W] tensors -> (colour sums
    [3], accumulators [6N]). ``ct`` None: the cotangent-free accumulators of
    the fused and dump modes; else the replay against ``ct`` [3]."""
    lat = tk.PlainLattice(scene_block, cam_block, seed, cfg, local_h, device)
    n = len(lat.sc)
    zeros = torch.zeros_like(lat.rows)
    col_sum = [zeros] * 3
    acc = [zeros] * (6 * n)
    ones = [1.0] * 3  # the kernel's factors of 1, exact in f32
    g = ones if ct is None else ct
    for s in range(spp):
        tape = []
        col, *_ = lat.sample(s, cfg, tape)
        col_sum = [a + b for a, b in zip(col_sum, col)]
        h = [zeros] * 3  # h (cotangent-free) or gbar (replay)
        for bounce in range(len(tape) - 1, -1, -1):
            hit, idx, m, e, c, _ = tape[bounce]
            cm = [clip01_grad(mm * ee) for mm, ee in zip(m, e)] if bounce == 0 else ones
            ae = [mm * gg * cc for mm, gg, cc in zip(m, g, cm)]
            h_new = [gg * cc * ee for gg, cc, ee in zip(g, cm, e)]
            ac = [mm * hh for mm, hh in zip(m, h)]
            for i in range(n):
                sel = hit & (idx == i)
                for ch, v in enumerate(ae + ac):
                    acc[6 * i + ch] = acc[6 * i + ch] + torch.where(sel, v, zeros)
            h = [torch.where(hit, hn + cc * hh, hh) for hn, cc, hh in zip(h_new, c, h)]
    return col_sum, acc


def fused_plain(scene_block, cam_block, seed, cfg: RenderConfig, target, *, local_h: int,
                spp: int, device=None):
    """Plain fused mode -> (sums [6N + 1], colour [local_h, W, 3]): sums[6i + ch]
    is the gradient of sum((mean - target)^2) with respect to emission (ch
    0-2) and albedo (3-5) of sphere i, sums[6N] that loss; no 1/denom."""
    require_diffuse(cfg, "fused_plain")
    col_sum, acc = _sweep_plain(scene_block, cam_block, seed, cfg, local_h, spp, device)
    inv_spp = tk._f32(1.0 / spp)
    mean = [x * inv_spp for x in col_sum]
    res = [m - t for m, t in zip(mean, target.unbind(-1))]
    g = [2.0 * r * inv_spp for r in res]
    sums = [torch.sum(g[k % 3] * a) for k, a in enumerate(acc)]
    sums.append(torch.sum(res[0] * res[0] + res[1] * res[1] + res[2] * res[2]))
    return torch.stack(sums), torch.stack(mean, dim=-1)


def dump_plain(scene_block, cam_block, seed, cfg: RenderConfig, *, local_h: int, spp: int,
               device=None):
    """Plain dump mode -> (colour [local_h, W, 3], accumulators [local_h, W, 6N]),
    both averaged over the spp samples."""
    require_diffuse(cfg, "dump_plain")
    col_sum, acc = _sweep_plain(scene_block, cam_block, seed, cfg, local_h, spp, device)
    inv_spp = tk._f32(1.0 / spp)
    return (torch.stack([x * inv_spp for x in col_sum], dim=-1),
            torch.stack([a * inv_spp for a in acc], dim=-1))


def replay_plain(scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *, local_h: int,
                 spp: int, device=None):
    """Plain replay mode -> sums [6N + 1]: the gradient of sum(cotangent *
    colour sum) (``cotangent`` [local_h, W, 3], 1/spp folded in by the
    caller), laid out as ``fused_plain``'s, with 0 in the loss slot."""
    require_diffuse(cfg, "replay_plain")
    ct = list(cotangent.unbind(-1))
    _, acc = _sweep_plain(scene_block, cam_block, seed, cfg, local_h, spp, device, ct)
    sums = [torch.sum(a) for a in acc] + [torch.zeros((), device=acc[0].device)]
    return torch.stack(sums)


# -- the dump's stores (csrc/grad_kernel.cu) ------------------------------------

def dump_store_plan(width: int, local_h: int, block: int, num_spheres: int, lanes: int):
    """The dump's stores of the accumulators as the kernel makes them: the
    ``lanes`` sample lanes of a pixel split its row of [local_h, W, 6N], lane
    j storing k = j, j + L, ... from the block's shared accumulators
    [6N + 1][pixels] (pixel q's k at word k * pixels + q) -> arrays
    ``address`` (the float written), ``row``, ``col``, ``k``, ``thread``,
    ``lane`` and ``shared`` (the word read), one entry a store."""
    n6, pixels = 6 * num_spheres, block * block
    bx, by, t, k = np.meshgrid(np.arange(-(-width // block)), np.arange(-(-local_h // block)),
                               np.arange(pixels * lanes), np.arange(n6), indexing="ij")
    lane, q = t % lanes, t // lanes
    row, col = by * block + q // block, bx * block + q % block
    keep = (row < local_h) & (col < width) & (k % lanes == lane)
    out = dict(address=(row * width + col) * n6 + k, row=row, col=col, k=k, thread=t,
               lane=lane, shared=k * pixels + q)
    return {name: v[keep] for name, v in out.items()}


# -- the CUDA kernel -------------------------------------------------------------

class CudaGradKernel:
    """ctypes binding of ``pt_grad_launch_padded``; each ``launch`` counts as
    ``"k2.<mode>"`` in ``timing``'s launch counts."""

    def __init__(self):
        self._lib = None  # keeps the library loaded while _fn is in use
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._lib, self._fn = load_function(SOURCE, "pt_grad_launch_padded", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ])
        return self._fn

    def occupancy(self, mode: str, cfg: RenderConfig, num_spheres: int,
                  pad_shared: int = 0, lanes: int | None = None) -> dict:
        """What the card gives a launch of ``mode`` with ``cfg``'s block edge
        and spp that asks for ``pad_shared`` dynamic shared bytes beyond its
        own: resident blocks an SM, registers a thread, dynamic shared bytes
        a block, local bytes a thread."""
        self._function()
        if lanes is None:
            lanes = tk.sample_lanes(cfg.spp, cfg.block, cfg.width * cfg.height,
                                    tk.device_sm_count(torch.cuda.current_device()), MAX_LANES)
        out = (ctypes.c_int * 4)()
        err = self._lib.pt_grad_occupancy(MODES.index(mode), cfg.block, lanes, num_spheres,
                                          pad_shared, out)
        if err != 0:
            raise RuntimeError(f"grad kernel occupancy query failed: cudaError {err}")
        return dict(zip(("blocks_per_sm", "registers", "shared_bytes", "local_bytes"), out))

    def launch(self, mode: str, scene_block, cam_block, seed, cfg: RenderConfig, pixels, *,
               local_h: int, spp: int, device: torch.device, pad_shared: int = 0,
               lanes: int | None = None):
        """Launch ``mode`` on the current stream of ``device`` (asynchronous).
        fused -> (sums, colour); dump -> (colour, accumulators); replay ->
        sums. ``pad_shared``, ``lanes``: as ``trace_kernel.CudaTraceKernel.
        launch``."""
        t0 = timing.launch_clock()
        fn = self._function()
        held, scene_at, cam_at, seed_at = tk.launch_operands(scene_block, cam_block, seed,
                                                              device)
        n6 = 6 * scene_block.shape[0]
        w, block = cfg.width, cfg.block
        if lanes is None:
            lanes = tk.sample_lanes(spp, block, local_h * w, tk.device_sm_count(device), MAX_LANES)
        f32 = dict(dtype=torch.float32, device=device)
        color = acc = partial = sums = None
        if mode in ("fused", "dump"):
            color = torch.empty((local_h, w, 3), **f32)
        if mode == "dump":
            acc = torch.empty((local_h, w, n6), **f32)
        else:
            n_blocks = -(-w // block) * -(-local_h // block)
            partial = torch.empty((n_blocks, n6 + 1), **f32)
            sums = torch.empty((n6 + 1,), **f32)

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(
                scene_at, scene_block.shape[0], cam_at, seed_at, local_h, w,
                tk._f32(1.0 / w), tk._f32(1.0 / cfg.height),
                spp, tk._f32(1.0 / spp), cfg.max_bounces, int(cfg.resolved_jitter),
                cfg.push_ray_origin, MODES.index(mode), block, lanes, ptr(pixels), ptr(color),
                ptr(acc), ptr(partial), ptr(sums), stream, pad_shared,
            )
        if err != 0:
            raise RuntimeError(f"grad kernel ({mode}) launch failed: cudaError {err}")
        timing.count_launch(f"k2.{mode}", t0)
        if mode == "fused":
            return sums, color
        return (color, acc) if mode == "dump" else sums


CUDA_KERNEL = CudaGradKernel()


def _check(scene_block, cam_block, seed, cfg: RenderConfig, local_h, spp, pixels, dev, what):
    require_diffuse(cfg, what)
    tk.check_blocks(scene_block, cam_block, seed, cfg, local_h, spp)
    if cfg.max_bounces > MAX_BOUNCES:
        raise ValueError(f"the gradient kernels take at most {MAX_BOUNCES} bounces, "
                         f"got {cfg.max_bounces}")
    if pixels is not None:
        shape = (local_h, cfg.width, 3)
        if pixels.dtype != torch.float32 or tuple(pixels.shape) != shape:
            raise ValueError(f"per-pixel input must be float32 {shape}, got "
                             f"{pixels.dtype} {tuple(pixels.shape)}")
        if not pixels.is_contiguous():
            raise ValueError("per-pixel input must be contiguous")
        if pixels.device != dev:
            raise ValueError(f"per-pixel input is on {pixels.device}, the launch on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no gradient kernel for device {dev}")


def fused(scene_block, cam_block, seed, cfg: RenderConfig, target, *, local_h: int, spp: int,
          device=None):
    """The fused-mode wrapper -> (sums [6N + 1], colour [local_h, W, 3]) on
    ``device`` (default: the blocks'). CPU: the plain version. CUDA: the
    kernel, or an exception."""
    dev = tk.launch_device(scene_block, device)
    _check(scene_block, cam_block, seed, cfg, local_h, spp, target, dev, "fused")
    if dev.type == "cpu":
        return fused_plain(scene_block, cam_block, seed, cfg, target, local_h=local_h, spp=spp,
                           device=dev)
    return CUDA_KERNEL.launch("fused", scene_block, cam_block, seed, cfg, target,
                              local_h=local_h, spp=spp, device=dev)


def dump(scene_block, cam_block, seed, cfg: RenderConfig, *, local_h: int, spp: int,
         device=None):
    """The dump-mode wrapper -> (colour [local_h, W, 3], accumulators
    [local_h, W, 6N])."""
    dev = tk.launch_device(scene_block, device)
    _check(scene_block, cam_block, seed, cfg, local_h, spp, None, dev, "dump")
    if dev.type == "cpu":
        return dump_plain(scene_block, cam_block, seed, cfg, local_h=local_h, spp=spp,
                          device=dev)
    return CUDA_KERNEL.launch("dump", scene_block, cam_block, seed, cfg, None,
                              local_h=local_h, spp=spp, device=dev)


def replay(scene_block, cam_block, seed, cfg: RenderConfig, cotangent, *, local_h: int,
           spp: int, device=None):
    """The replay-mode wrapper -> sums [6N + 1] (0 in the loss slot)."""
    dev = tk.launch_device(scene_block, device)
    _check(scene_block, cam_block, seed, cfg, local_h, spp, cotangent, dev, "replay")
    if dev.type == "cpu":
        return replay_plain(scene_block, cam_block, seed, cfg, cotangent, local_h=local_h,
                            spp=spp, device=dev)
    return CUDA_KERNEL.launch("replay", scene_block, cam_block, seed, cfg, cotangent,
                              local_h=local_h, spp=spp, device=dev)


# -- agreement of two outputs ------------------------------------------------------
# The kernel against its plain version. Gradient sums: every entry within
# rtol 1e-4 plus 1e-8 of the largest |reference| (the pixel sums are taken
# in another order). Accumulators: a borderline hit decision may send one
# sample down another path, so at most 1% of pixels may have a channel off
# by more than 1e-3 of that channel's range. Colour: trace_kernel.agreement's
# colour rule on the mean.
SUMS_RTOL = 1e-4
SUMS_ATOL = 1e-8  # x max |reference|
ACC_TOL = 1e-3  # x the channel's range
MAX_OFF_SHARE = 0.01


def agreement(got: torch.Tensor, ref: torch.Tensor, kind: str):
    """Hold ``got`` against ``ref`` -> (checks, max |got - ref|); each check
    is (name, share out of tolerance, ceiling, ok). ``kind``: "sums" [6N + 1],
    "acc" [h, W, 6N] or "color" [h, W, 3] (means)."""
    if kind == "color":
        return tk.agreement(got, ref, "color", 1)
    got = got.detach().to("cpu", torch.float64).numpy()
    ref = ref.detach().to("cpu", torch.float64).numpy()
    if got.shape != ref.shape:
        raise ValueError(f"shapes {got.shape} and {ref.shape} differ")
    diff = np.abs(got - ref)
    if kind == "sums":
        finite = np.isfinite(got) & np.isfinite(ref)
        tol = SUMS_RTOL * np.abs(ref) + SUMS_ATOL * np.abs(ref).max()
        checks = [("finite", ~finite, 0.0), ("sums", diff > tol, 0.0)]
    elif kind == "acc":
        finite = np.isfinite(got).all(axis=-1) & np.isfinite(ref).all(axis=-1)
        span = ref.max(axis=(0, 1)) - ref.min(axis=(0, 1))
        checks = [("finite", ~finite, 0.0),
                  ("acc", (diff > ACC_TOL * span).any(axis=-1), MAX_OFF_SHARE)]
    else:
        raise ValueError(f"kind must be 'sums', 'acc' or 'color', got {kind!r}")
    out = []
    for name, off, ceiling in checks:
        share = float(off.mean())
        out.append((name, share, ceiling, share <= ceiling))
    return out, float(np.nan_to_num(diff, nan=np.inf).max())


# -- entry points (the JAX package's signatures, plus a device) ---------------------

def _split(sums: torch.Tensor, n: int, denom=1):
    g = sums[: 6 * n].reshape(n, 6) / denom
    return g[:, 0:3], g[:, 3:6]


def _replay_sums(scene_block, cam_block, seed, cfg: RenderConfig, ct, *, local_h: int,
                 spp: int, device, tape=None):
    """The replay of a configuration off the product chain against ``ct``
    [local_h, W, 3], the cotangent of the cfg.spp-sample mean colour: K3's
    (NEE diffuse) or K4's (glossy) ``replay_color`` over ``local_h`` rows and
    ``spp`` samples at ``seed``, sweeping ``tape`` if given -> flat sums
    [10N + 16] (``sweep.block_from_sums`` lays them out as the gradient
    block)."""
    kernel = nk if route(cfg) == "nee" else ak
    return kernel.replay_color(scene_block, cam_block, seed, cfg, ct, local_h=local_h, spp=spp,
                               device=device, tape=tape)


def _loss_grads(scene, cam, cfg: RenderConfig, frame, target, device):
    """(loss, gradients, mean colour [H, W, 3]) of the mean-squared pixel loss
    against ``target`` [H, W, 3] (``pallas_loss_and_grads``' dispatch).
    Diffuse: one K2 fused launch; gradients (d_emission, d_albedo) [N, 3].
    NEE diffuse: one K3 fused launch; glossy: one colour-sum launch of K1
    and one replay; gradients: the block [N + 5, 11]."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    seed = tk.make_seed_block(cfg, frame)
    kw = dict(local_h=cfg.height, spp=cfg.spp, device=device)
    target = tk._per_pixel(target, device)
    denom = cfg.height * cfg.width * 3
    kind = route(cfg)
    if kind == "chain":
        sums, color = fused(sb, cb, seed, cfg, target, **kw)
        return sums[-1] / denom, _split(sums, sb.shape[0], denom), color
    if kind == "nee":
        sums, color = nk.fused(sb, cb, seed, cfg, target, **kw)
        return sums[-1] / denom, sweep.block_from_sums(sums) / denom, color
    color, diff, sums = sweep.color_loss_replay(sb, cb, seed, cfg, target, _replay_sums, **kw)
    return torch.sum(diff * diff) / denom, sweep.block_from_sums(sums), color


def fused_loss_grads(scene, cam, cfg: RenderConfig, frame, target, device=None):
    """(loss, d_emission [N, 3], d_color [N, 3], colour [H, W, 3]) of the
    mean-squared pixel loss against ``target`` [H, W, 3]. Diffuse: one fused
    launch. NEE diffuse: one fused launch of the NEE kernel. Glossy: one
    colour-sum launch of the forward kernel and one K4 replay."""
    loss, grads, color = _loss_grads(scene, cam, cfg, frame, target, device)
    if on_chain(cfg):
        return loss, *grads, color
    d = sweep.scene_grads_from_block(grads)
    return loss, d.emission, d.color, color


def grad_acc_slab(scene, cam, cfg: RenderConfig, frame, row_offset=0, local_h=None, spp=None,
                  sample_offset=0, device=None):
    """One dump launch on rows [row_offset, row_offset + local_h) and samples
    [sample_offset, sample_offset + spp) -> (colour [local_h, W, 3], acc
    [local_h, W, 6N]), both averaged over those samples."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    local_h = cfg.height if local_h is None else local_h
    return dump(sb, cb, tk.make_seed_block(cfg, frame, sample_offset, row_offset), cfg,
                local_h=local_h, spp=cfg.spp if spp is None else spp, device=device)


def render_grad_acc(scene, cam, cfg: RenderConfig, frame, device=None):
    """One dump launch over the frame -> (colour [H, W, 3], acc [H, W, 6N]).
    ``acc[..., 6i + ch]`` is d(mean colour channel ch % 3)/d(emission (ch < 3)
    or albedo (ch >= 3) of sphere i) at that pixel."""
    return grad_acc_slab(scene, cam, cfg, frame, device=device)


def contract(ct: torch.Tensor, acc: torch.Tensor):
    """ct [H, W, 3] x acc [H, W, 6N] -> (d_emission [N, 3], d_color [N, 3])
    of sum(ct * colour)."""
    n = acc.shape[-1] // 6
    g = torch.sum(ct.repeat(1, 1, 2 * n) * acc, dim=(0, 1)).reshape(n, 6)
    return g[:, 0:3], g[:, 3:6]


def render_color_grads(scene, cam, cfg: RenderConfig, frame, cotangent, device=None):
    """(d_emission [N, 3], d_color [N, 3]) of sum(cotangent * mean colour) for
    ``cotangent`` [H, W, 3]: one replay launch of the configuration's kernel
    (under NEE or glossy it also computes the geometry and camera gradients,
    which this signature drops)."""
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    seed = tk.make_seed_block(cfg, frame)
    kw = dict(local_h=cfg.height, spp=cfg.spp, device=device)
    if not on_chain(cfg):
        sums = _replay_sums(sb, cb, seed, cfg, cotangent, **kw)
        d = sweep.scene_grads_from_block(sweep.block_from_sums(sums))
        return d.emission, d.color
    sums = replay(sb, cb, seed, cfg, tk._per_pixel(cotangent, device) / cfg.spp, **kw)
    return _split(sums, sb.shape[0])


def cross_contract(a, acc_a, b, acc_b, target):
    """(loss, {"emission", "color"}) of the cross-estimator mean((A - T)(B - T))
    from two dumps' colours and accumulators, each contracted against the
    other's residual."""
    ra, rb = a - target, b - target
    denom = a.numel()
    d_ea, d_ca = contract(rb / denom, acc_a)
    d_eb, d_cb = contract(ra / denom, acc_b)
    return torch.sum(ra * rb) / denom, {"emission": d_ea + d_eb, "color": d_ca + d_cb}


def cross_grads(scene, cam, cfg: RenderConfig, step, target, device=None):
    """(loss, gradients by field) of the cross-estimator over two independent
    renders, frames 2 step and 2 step + 1: the inverse step's gradient on
    ``"cuda"``. Diffuse: two dump launches and ``cross_contract`` ->
    {"emission", "color"}. NEE diffuse and glossy: two colour-sum launches
    of the forward kernel, then two replays (K3 for NEE diffuse, K4 for
    glossy), each against the other render's residual -> also "position"
    and "radius".

    Under NEE on the card each colour pass writes its paths into a path
    tape, which its replay (K3 or K4) sweeps instead of tracing them again,
    with the same bits. A tape takes 56 B a pixel, sample and bounce, 68
    under glossy (``sweep.tape_bytes``), so the step runs in the fewest
    equal row slabs whose two tapes fit ``sweep.TAPE_BUDGET`` (4 GiB;
    ``sweep.step_tapes``): one at 256x256x16 (2 x 293.6 MB), two of 256 rows
    at 512x512x32 (2 x 1.17 GB diffuse, 2 x 1.43 GB glossy). Each slab is the two colour passes, then the two
    replays against the other pass's residual rows; the two tapes serve
    every slab, and the slabs' gradient sums add up in slab order. The
    residual is per pixel, so the loss is the whole frame's, as one slab
    gives it. On the CPU, without NEE, and where even one row's tapes would
    not fit, one slab and no tape: the replays trace again. The scene and
    camera blocks are built once a step, for every launch."""
    if on_chain(cfg):
        a, acc_a = render_grad_acc(scene, cam, cfg, 2 * step, device)
        b, acc_b = render_grad_acc(scene, cam, cfg, 2 * step + 1, device)
        target = tk._per_pixel(target, a.device)
        return cross_contract(a, acc_a, b, acc_b, target)
    sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
    rows, tapes = sweep.step_tapes(cfg, device)
    target = tk._per_pixel(target, device)
    denom = cfg.height * cfg.width * 3
    sums, residuals = None, []
    for r0 in range(0, cfg.height, rows):
        kw = dict(local_h=min(rows, cfg.height - r0), spp=cfg.spp, device=device)
        seeds = [tk.make_seed_block(cfg, f, 0, r0) for f in (2 * step, 2 * step + 1)]
        slab = [None if t is None else t.slab(cfg, kw["local_h"], cfg.spp) for t in tapes]
        a, b = (tk.trace(sb, cb, seed, cfg, mode="color", tape=t, **kw) / cfg.spp
                for seed, t in zip(seeds, slab))
        ra, rb = a - target[r0:r0 + kw["local_h"]], b - target[r0:r0 + kw["local_h"]]
        # each pass's replay against the other pass's residual
        ga, gb = (_replay_sums(sb, cb, seed, cfg, residual / denom, tape=t, **kw)
                  for seed, residual, t in zip(seeds, (rb, ra), slab))
        sums = ga + gb if sums is None else sums + (ga + gb)
        residuals.append((ra, rb))
    ra, rb = residuals[0] if len(residuals) == 1 else (torch.cat(x) for x in zip(*residuals))
    d = sweep.scene_grads_from_block(sweep.block_from_sums(sums))
    return torch.sum(ra * rb) / denom, {"emission": d.emission, "color": d.color,
                                        "position": d.position, "radius": d.radius}


def loss_and_grads(scene, cam, cfg: RenderConfig, frame, target, device=None):
    """(loss, (d_scene, d_cam)) of the mean-squared pixel loss, on the render
    device (``pallas_loss_and_grads``'s dispatch). NEE diffuse: one fused
    launch of the NEE kernel, all parameters. Glossy, with or without NEE:
    one colour-sum launch of the forward kernel and one K4 replay, all
    parameters. Diffuse: one fused launch of the product-chain kernel;
    geometry and camera get exact zeros, since that estimator does not
    depend on them."""
    loss, grads, _ = _loss_grads(scene, cam, cfg, frame, target, device)
    if not on_chain(cfg):
        return loss, sweep.grads_from_block(scene, cam, cfg, grads)

    def zeros(x):  # x's shape and dtype on the loss's device: nothing is copied
        return torch.zeros(x.shape, dtype=x.dtype, device=loss.device)

    d_scene = Scene(zeros(scene.radius), zeros(scene.position), *grads)
    d_cam = Camera(zeros(cam.position), zeros(cam.yaw), zeros(cam.pitch))
    return loss, (d_scene, d_cam)


class _DumpColor(torch.autograd.Function):
    """Mean colour [H, W, 3] from one dump launch; the backward contracts the
    colour's cotangent against the saved accumulators."""

    @staticmethod
    def forward(ctx, cfg, frame, device, radius, position, emission, color, cam_position, yaw,
                pitch):
        scene = Scene(radius, position, emission, color)
        mean, acc = render_grad_acc(scene, Camera(cam_position, yaw, pitch), cfg, frame, device)
        ctx.save_for_backward(acc)
        ctx.inputs = [(t.shape, t.dtype, t.device) for t in
                      (radius, position, emission, color, cam_position, yaw, pitch)]
        return mean

    @staticmethod
    def backward(ctx, grad_color):
        (acc,) = ctx.saved_tensors
        d_e, d_c = contract(grad_color.contiguous(), acc)
        grads = []
        for k, (shape, dtype, dev) in enumerate(ctx.inputs):
            if not ctx.needs_input_grad[3 + k]:
                grads.append(None)
            elif k == 2:
                grads.append(d_e.to(dev, dtype))
            elif k == 3:
                grads.append(d_c.to(dev, dtype))
            else:
                grads.append(torch.zeros(shape, dtype=dtype, device=dev))
        return (None, None, None, *grads)


class _ReplayColor(torch.autograd.Function):
    """Mean colour [H, W, 3] of an NEE or glossy render from one colour-sum
    launch of the forward kernel; the backward is one replay launch (K3 for
    NEE diffuse, K4 for glossy) against the colour's cotangent, with
    gradients for all seven leaves."""

    @staticmethod
    def forward(ctx, cfg, frame, device, radius, position, emission, color, cam_position, yaw,
                pitch):
        ctx.render = (cfg, frame, device)
        ctx.save_for_backward(radius, position, emission, color, cam_position, yaw, pitch)
        scene = Scene(radius, position, emission, color)
        return tk.render_color_sums(scene, Camera(cam_position, yaw, pitch), cfg, frame,
                                    device=device) / cfg.spp

    @staticmethod
    def backward(ctx, grad_color):
        cfg, frame, device = ctx.render
        leaves = ctx.saved_tensors
        scene, cam = Scene(*leaves[:4]), Camera(*leaves[4:])
        sb, cb, device = tk.device_blocks(scene, cam, cfg, device)
        sums = _replay_sums(sb, cb, tk.make_seed_block(cfg, frame), cfg, grad_color,
                            local_h=cfg.height, spp=cfg.spp, device=device)
        d_scene, d_cam = sweep.grads_from_block(scene, cam, cfg, sweep.block_from_sums(sums))
        grads = [d_scene.radius, d_scene.position, d_scene.emission, d_scene.color,
                 d_cam.position, d_cam.yaw, d_cam.pitch]
        return (None, None, None,
                *(g.to(x.device, x.dtype) if need else None
                  for g, x, need in zip(grads, leaves, ctx.needs_input_grad[3:])))


def render_color(scene, cam, cfg: RenderConfig, frame=0, device=None) -> torch.Tensor:
    """Differentiable mean colour [H, W, 3] through the kernels. Diffuse: one
    dump launch forward, a contraction backward; gradients reach emission
    and albedo, and positions, radii and the camera get exact zeros. NEE
    diffuse and glossy: the forward kernel's colour sums forward, one replay
    launch backward (K3, K4); gradients reach all seven leaves."""
    device = resolve_device(device)
    fn = _DumpColor if on_chain(cfg) else _ReplayColor
    return fn.apply(cfg, frame, device, scene.radius, scene.position, scene.emission,
                    scene.color, cam.position, cam.yaw, cam.pitch)
