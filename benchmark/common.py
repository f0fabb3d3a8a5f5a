"""What the drivers share: the scene and weights made from the seed, the
comparisons that decide ``correct``, and the port's entry points.

Weights are drawn on the run's device by one ``torch.Generator`` seeded with
the run's seed, in one call, and cut into the denoiser's tensors: kernels
normal with Flax's lecun scale (1 / sqrt(fan in)), biases 0, BatchNorm
scale 1, shift 0, running mean 0 and variance 1, and the RGB head's bias 1
(so that the output, RGB times albedo, lies mostly inside the display's
range rather than clipped at 0). The program gets them as
a checkpoint or a model; the reference draws them again from the seed.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import fpn

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def spheres(config: dict, device="cpu") -> dict:
    """The configuration's spheres as the reference takes them."""
    rows = config["scene"]["spheres"]
    return {
        "rad": torch.tensor([r["radius"] for r in rows], dtype=torch.float32, device=device),
        "pos": torch.tensor([r["position"] for r in rows], dtype=torch.float32, device=device),
        "emis": torch.tensor([r["emission"] for r in rows], dtype=torch.float32, device=device),
        "alb": torch.tensor([r["albedo"] for r in rows], dtype=torch.float32, device=device),
    }


def port_scene(sp: dict):
    """The program's ``Scene`` of the same spheres, on the host."""
    from pathtrace_tpu_torch.scene import Scene

    return Scene(*(sp[k].cpu().numpy() for k in ("rad", "pos", "emis", "alb")))


def render_config(config: dict, seed: int, **fields):
    """The program's ``RenderConfig`` of the configuration, on the kernels'
    route (on the CPU, which only the tests use, their plain versions)."""
    from pathtrace_tpu_torch.config import RenderConfig

    r = config["render"]
    base = dict(width=r["width"], height=r["height"], max_bounces=r["max_bounces"],
                push_ray_origin=r["push_ray_origin"], nee=r["nee"],
                light_index=r["light_index"], seed=int(seed), backend="cuda")
    base.update(fields)
    return RenderConfig(**base)


def fpn_weights(seed: int, device, widths, lateral) -> dict:
    """{state-dict name: tensor} of the denoiser, drawn from ``seed``."""
    shapes = fpn.shapes(widths, lateral)
    kernels = {k: s for k, s in shapes.items() if k.endswith(".weight") and len(s) == 4}
    total = sum(math.prod(s) for s in kernels.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            n = math.prod(shape)
            fan_in = shape[1] * shape[2] * shape[3]
            out[name] = (flat[offset:offset + n] * (1.0 / math.sqrt(fan_in))).view(shape)
            offset += n
        elif name.endswith(("running_var", ".weight")) or name == "rgb_conv.bias":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def port_state_dict(weights: dict) -> dict:
    """``weights`` on the host as the program's ``DenoiseCNN.state_dict()``
    holds them: with each BatchNorm's ``num_batches_tracked``."""
    state = {k: v.detach().to("cpu") for k, v in weights.items()}
    for k in [k for k in state if k.endswith(".running_var")]:
        state[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def write_checkpoint(directory: str, weights: dict, widths, lateral) -> None:
    """``weights`` as ``pathtrace_tpu_torch.train.save_checkpoint`` writes a
    bare model: ``model.json`` and ``model_epoch.pt`` = {"model": state}."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model.json"), "w") as f:
        json.dump({"widths": list(widths), "lateral_features": lateral}, f)
    torch.save({"model": port_state_dict(weights)}, os.path.join(directory, "model_epoch.pt"))


def channel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| of a [..., C] buffer, each channel over
    max(1, its largest |ref|)."""
    got, ref = got.double().reshape(-1, got.shape[-1]), ref.double().reshape(-1, ref.shape[-1])
    scale = torch.clamp(ref.abs().amax(0), min=1.0)
    gap = float(((got - ref).abs().amax(0) / scale).max())
    return gap if math.isfinite(gap) and bool(torch.isfinite(got).all()) else math.inf


def norm_gap(got: dict, ref: dict) -> float:
    """Worst leaf of |norm(got) - norm(ref)| over max(norm(ref), the median
    leaf's norm of ref), over the leaves whose reference norm is at least a
    thousandth of the median's (the others move by round-off alone). A norm
    that is not finite on either side reads infinite."""
    ref_n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    median = float(np.median(list(ref_n.values())))
    if not all(math.isfinite(n) for n in ref_n.values()) or median <= 0:
        return math.inf
    gaps = [abs(float(torch.linalg.vector_norm(v.double())) - ref_n[k]) / max(ref_n[k], median)
            for k, v in got.items() if ref_n[k] >= 1e-3 * median]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def leaves_left_out(ref: dict) -> list:
    ref_n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    median = float(np.median(list(ref_n.values())))
    return sorted(k for k, n in ref_n.items() if n < 1e-3 * median)


def relative_gap(got, ref, scale=None) -> float:
    """|got - ref| over |ref| (or ``scale``); infinite where not finite."""
    gap = abs(float(got) - float(ref)) / max(abs(float(ref if scale is None else scale)), 1e-30)
    return gap if math.isfinite(gap) else math.inf


def sample_indices(seed: int, count: int, k: int, salt: int) -> list:
    """``k`` distinct indices of ``count`` drawn from ``seed``, and the last."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, salt])
    picked = set(rng.choice(count, size=min(k, count), replace=False).tolist())
    picked.add(count - 1)
    return sorted(picked)
