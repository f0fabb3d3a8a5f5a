"""Frame rendering: camera + scene -> 14-channel AOV buffer.

The counterpart of ``pathtrace_tpu.render``. Output is a dict of named
AOVs, or the packed ``[H, W, 14]`` buffer in the reference's channel order
(``src/pathtrace.cu:240-254``): c0-2 colour RGB, c3-5 normal XYZ, c6-8
albedo RGB, c9 depth, c10-13 the luminance variances of colour, normal,
albedo and depth. Row 0 is the top of the image.

Two backends draw the same random lattice:

- ``"cuda"``: the hand-written kernel (``ops/trace_kernel.py``);
- ``"torch"``: the plain wavefront (``ops/trace.py``), which traces spp
  chunks and merges them with Chan's formula.

``"auto"`` picks ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch

from pathtrace_tpu_torch import camera as camera_lib
from pathtrace_tpu_torch import rng
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.ops import variance as var_lib
from pathtrace_tpu_torch.ops.trace import trace_paths

FEATURES = ("color", "normal", "albedo", "depth")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the current CUDA device for None,
    or an error where there is none (the CPU is never chosen silently), else
    ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device available; pass device="cpu" to run on the CPU')
    return torch.device("cuda", torch.cuda.current_device())


def resolve_backend(cfg: RenderConfig, device: torch.device) -> str:
    """The backend ``cfg.backend`` names on ``device``."""
    if cfg.backend != "auto":
        return cfg.backend
    return "cuda" if device.type == "cuda" else "torch"


def primary_rays(cam, cfg: RenderConfig, jitter_uv=None, row_offset=0, local_h=None):
    """Eye position [3] + ray directions [..., h, W, 3] for image rows
    [row_offset, row_offset + local_h). ``jitter_uv`` [..., h, W, 2] offsets
    each sampling position by u - 0.5 pixels (``pathtrace.cu:222-225``)."""
    h = cfg.height if local_h is None else local_h
    dev = cam.device
    basis = cam.eye_ray_basis(cfg.width, cfg.height)
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + float(row_offset)
    cols = torch.arange(cfg.width, dtype=torch.float32, device=dev)[None, :]
    rows = rows.expand(h, cfg.width)
    cols = cols.expand(h, cfg.width)
    if jitter_uv is not None:
        rows = rows + (jitter_uv[..., 0] - 0.5)
        cols = cols + (jitter_uv[..., 1] - 0.5)
    ndc_x, ndc_y = camera_lib.pixel_ndc(rows, cols, cfg.width, cfg.height)
    return cam.position, camera_lib.ray_directions(basis, ndc_x, ndc_y)


def _trace_chunk(scene, cam, cfg: RenderConfig, frame, chunk_spp: int,
                 sample_offset: int, row_offset=0, local_h=None):
    """Trace ``chunk_spp`` samples of rows [row_offset, row_offset+local_h)
    -> partial sums + partial moments."""
    h = cfg.height if local_h is None else local_h
    uniforms = rng.sample_uniforms(
        cfg.seed, frame, chunk_spp, h, cfg.width, cfg.max_bounces, sample_offset,
        row_offset=row_offset, slots_per_bounce=cfg.slots_per_bounce,
        device=scene.device,
    )
    jitter_uv = uniforms[..., :2] if cfg.resolved_jitter else None
    origin, directions = primary_rays(cam, cfg, jitter_uv, row_offset, h)
    if directions.dim() == 3:  # no jitter -> no sample axis; add it
        directions = directions.expand(chunk_spp, h, cfg.width, 3)
    res = trace_paths(
        scene, origin, directions, uniforms[..., 2:],
        max_bounces=cfg.max_bounces,
        push_ray_origin=cfg.push_ray_origin,
        nee_light_index=cfg.light_index if cfg.nee else None,
        brdf=cfg.brdf,
    )
    sums = {
        "color": torch.sum(res.color, dim=0),
        "normal": torch.sum(res.normal, dim=0),
        "albedo": torch.sum(res.albedo, dim=0),
        "depth": torch.sum(res.depth, dim=0),
    }
    moments = {
        "color": var_lib.moments_from_samples(
            var_lib.luminance(res.color), res.include_color),
        "normal": var_lib.moments_from_samples(var_lib.luminance(res.normal), res.hit0),
        "albedo": var_lib.moments_from_samples(var_lib.luminance(res.albedo), res.hit0),
        "depth": var_lib.moments_from_samples(res.depth, res.hit0),
    }
    return sums, moments


def accumulate_frame(scene, cam, cfg: RenderConfig, frame, row_offset=0,
                     local_h=None, spp=None, sample_offset=0):
    """A frame slab as (sums, moments) partials on the ``"torch"`` backend:
    samples [sample_offset, sample_offset + spp) of rows [row_offset,
    row_offset + local_h), traced in ``cfg.spp_chunk`` chunks whose sums add
    and whose moments merge with Chan's formula."""
    chunks = cfg.chunks(cfg.spp if spp is None else spp)
    sums, moments = _trace_chunk(scene, cam, cfg, frame, chunks[0], sample_offset,
                                 row_offset, local_h)
    offset = sample_offset + chunks[0]
    for chunk_spp in chunks[1:]:
        s, m = _trace_chunk(scene, cam, cfg, frame, chunk_spp, offset, row_offset, local_h)
        sums = {k: sums[k] + s[k] for k in sums}
        moments = {k: var_lib.merge_moments(moments[k], m[k]) for k in moments}
        offset += chunk_spp
    return sums, moments


def finalize_aovs(sums, moments, total_spp: int) -> Dict[str, torch.Tensor]:
    """Partials -> the 10 mean channels + 4 variance channels. Means divide
    by the total spp whatever the masks (pathtrace.cu:234-237)."""
    inv = 1.0 / float(total_spp)
    out = {k: sums[k] * inv for k in FEATURES}
    out.update({f"{k}_var": var_lib.variance(moments[k]) for k in FEATURES})
    return out


def pack_channels(aovs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dict of AOVs -> packed [H, W, 14] buffer (reference channel order)."""
    return torch.cat(
        [
            aovs["color"], aovs["normal"], aovs["albedo"],
            aovs["depth"][..., None],
            aovs["color_var"][..., None], aovs["normal_var"][..., None],
            aovs["albedo_var"][..., None], aovs["depth_var"][..., None],
        ],
        dim=-1,
    )


def unpack_channels(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Packed [..., 14] buffer -> dict of AOV views."""
    return {
        "color": buf[..., 0:3],
        "normal": buf[..., 3:6],
        "albedo": buf[..., 6:9],
        "depth": buf[..., 9],
        "color_var": buf[..., 10],
        "normal_var": buf[..., 11],
        "albedo_var": buf[..., 12],
        "depth_var": buf[..., 13],
    }


def render_aovs(scene, cam, cfg: RenderConfig, frame=0, device=None) -> Dict[str, torch.Tensor]:
    """Render one frame on ``device`` (default: the current CUDA device;
    ``"cpu"`` must be asked for) -> dict of AOVs, each [H, W, C] or [H, W]."""
    device = resolve_device(device)
    if resolve_backend(cfg, device) == "cuda":
        from pathtrace_tpu_torch.ops import trace_kernel

        return trace_kernel.render_aovs(scene, cam, cfg, frame, device=device)
    sums, moments = accumulate_frame(scene.to(device), cam.to(device), cfg, frame)
    return finalize_aovs(sums, moments, cfg.spp)


def render_channels(scene, cam, cfg: RenderConfig, frame=0, device=None) -> torch.Tensor:
    """Render one frame -> packed [H, W, 14] buffer."""
    return pack_channels(render_aovs(scene, cam, cfg, frame, device))
