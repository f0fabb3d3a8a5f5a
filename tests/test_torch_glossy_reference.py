"""The benchmark's frozen glossy tracer and its two inverse cases against the port, on the CPU.

- ``benchmark/reference/glossy.py`` traces the paths of the port's plain
  glossy trajectory (``trace_kernel._sample_plain``: five draws a bounce,
  the mirrored and jittered cosine direction), with and without NEE, each
  sample to the bit, at 16x8x4 on seeded scenes.
- Three steps of ``inverse.make_inverse_step`` on ``device="cpu"`` (the
  kernels' plain versions: K1's colour sums and K4's hand-derived sweep
  under glossy NEE; K2's dump and the contraction for the albedo) agree
  with three steps of the reference (``benchmark/reference/inverse.py``:
  autograd through the frozen tracers, Adam written out) on the two cases
  the benchmark's inverse cells run, at 16x12x2 on seeded scenes.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import camera as ref_camera
from benchmark.reference import glossy, tracer
from benchmark.reference import inverse as ref_inverse
from pathtrace_tpu_torch import Camera, RenderConfig, Scene, cornell_box, inverse
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.render import render_aovs

POSE = (50.0, 52.0, 295.6, -90.0, 0.0)
SEEDS = [2**31 + 7919, 2**31 + 4 * 7919]
FIELD = {"position": "pos", "radius": "rad", "color": "alb"}


def seeded_scene(seed: int) -> Scene:
    """The Cornell box with its two balls moved by up to 3 units and the
    albedos of all but the light drawn in [0.2, 0.9]."""
    box = cornell_box()
    rng = np.random.default_rng(seed)
    pos = box.position.numpy().copy()
    pos[6:8] += rng.uniform(-3.0, 3.0, (2, 3))
    alb = box.color.numpy().copy()
    alb[:8] = rng.uniform(0.2, 0.9, (8, 3))
    return Scene(box.radius, pos.astype(np.float32), box.emission, alb.astype(np.float32))


def spheres(scene: Scene) -> dict:
    return {"rad": scene.radius, "pos": scene.position, "emis": scene.emission,
            "alb": scene.color}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("nee", [False, True])
def test_glossy_reference_traces_the_ports_paths(nee, seed):
    width, height, spp, frame = 16, 8, 4, 41
    scene = seeded_scene(seed)
    cfg = RenderConfig(width=width, height=height, spp=spp, seed=seed, brdf="glossy", nee=nee,
                       backend="cuda")
    sb, cb, _ = tk.device_blocks(scene, Camera.create(POSE[:3], POSE[3], POSE[4]), cfg, "cpu")
    lat = tk.PlainLattice(sb, cb, tk.make_seed_block(cfg, frame), cfg, height)
    pose = ref_camera.Pose(POSE[:3], POSE[3], POSE[4])
    fr = glossy.Frame(spheres(scene), pose.position, pose.corner_rays(width, height), width,
                      height, seed, frame, range(height), light=8 if nee else None)
    got = fr.paths(0, spp)
    for s in range(spp):
        want = lat.sample(s, cfg)
        for w, g in zip(want[0] + want[1] + want[2] + [want[3]],
                        got[0] + got[1] + got[2] + [got[3]]):
            assert torch.equal(w, g[s])
        assert torch.equal(want[4], got[4][s]) and torch.equal(want[5], got[5][s])


def _case(name: str, seed: int):
    """(config, true scene, corrupted scene, fields, rates, masks, rate(name,
    step)) of the benchmark's case ``name`` on a seeded scene."""
    true = seeded_scene(seed)
    if name == "glossy_geometry":  # cornell-glossy-nee's: sphere 6 moved and shrunk
        cfg = RenderConfig(width=16, height=12, spp=2, seed=seed, brdf="glossy", nee=True,
                           backend="cuda")
        pos, rad = true.position.clone(), true.radius.clone()
        pos[6] += torch.tensor([6.0, -4.0, 8.0])
        rad[6] *= 0.8
        rates = {"position": inverse.exponential_decay(0.5, 400, 0.02),
                 "radius": inverse.exponential_decay(0.1, 400, 0.02)}
        masks = {"position": torch.zeros(9, 1), "radius": torch.zeros(9)}
        masks["position"][6] = masks["radius"][6] = 1.0
        return (cfg, true, true.replace(position=pos, radius=rad), ("position", "radius"),
                rates, masks, lambda k, step: rates[k](step))
    # cornell-diffuse.inverse_albedo's: the nine albedos moved and clipped
    cfg = RenderConfig(width=16, height=12, spp=2, seed=seed, backend="cuda")
    alb = np.clip(true.color.numpy() + np.random.default_rng(0).uniform(-0.35, 0.35, (9, 3)),
                  0.05, 0.95).astype(np.float32)
    return (cfg, true, true.replace(color=torch.from_numpy(alb)), ("color",), 2e-2, None,
            lambda k, step: 2e-2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["glossy_geometry", "albedo"])
def test_three_inverse_steps_are_the_references(name, seed):
    cfg, true, bad, fields, rates, masks, rate = _case(name, seed)
    cam = Camera.create(POSE[:3], POSE[3], POSE[4])
    # one target for both sides: the step is under test, not the target's render
    target = render_aovs(true, cam, cfg, frame=987654, device="cpu")["color"]
    state, step_fn, opt = inverse.make_inverse_step(bad, cam, cfg, target, fields, rates,
                                                    grad_mask=masks, device="cpu")
    losses = []
    for i in range(3):
        state, loss = step_fn(state)
        losses.append(float(loss))
        if i == 0:  # Adam's first moment after one step is (1 - b1) x the gradient
            first = {k: opt.state[p]["exp_avg"] / 0.1 for k, p in state.params.items()}

    pose = ref_camera.Pose(POSE[:3], POSE[3], POSE[4])
    corners = pose.corner_rays(cfg.width, cfg.height)
    kind = glossy.Frame if cfg.brdf == "glossy" else tracer.Frame

    def frame(sp, index, rows):
        return kind(sp, pose.position, corners, cfg.width, cfg.height, seed, index, rows,
                    light=8 if cfg.nee else None)

    def scene_of(p):  # the albedo clipped to [0, 1], as the step clips it (inside, slope 1)
        sp = spheres(true)
        for k, v in p.items():
            sp[FIELD[k]] = torch.clamp(v, 0.0, 1.0) if k == "color" else v
        return sp

    params = {k: getattr(bad, k).clone().requires_grad_(True) for k in fields}
    ref_losses, ref_first, ref_after = ref_inverse.cross_steps(
        frame, scene_of, params, target, range(cfg.height), cfg.width, cfg.spp, 3, rate, masks)

    # The colours are the same paths' sums in another order: the losses agree
    # to f32 rounding (seen: at most 3e-7 of the mean |(A - T)(B - T)|).
    for got, (want, scale) in zip(losses, ref_losses):
        assert abs(got - want) <= 1e-5 * scale, (losses, ref_losses)
    for k in fields:
        # The hand-derived sweep (sums in double) against autograd (f32): the
        # same derivative rounded in another order (seen: 2.3e-6 of the
        # largest entry).
        g, w = first[k], ref_first[k]
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), k
        # Adam's normalised steps carry that rounding into the change (seen:
        # 5.4e-6 of the largest entry).
        ch, want_ch = state.params[k].detach() - getattr(bad, k), ref_after[k] - getattr(bad, k)
        assert float((ch - want_ch).abs().max()) <= 1e-4 * float(want_ch.abs().max()), k
        assert float(want_ch.abs().max()) > 0
