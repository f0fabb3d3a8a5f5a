"""``python -m pathtrace_tpu_torch.bench`` against the repo's root bench.py.

(a) The plan: the groups of cells that run for ``--quick``, ``--no-grad``
and ``--full`` on the card and on the CPU are bench.py's branches, with the
card in the TPU's place.

(b) Each card cell's entry point, run on the CPU (the kernel wrappers run
their plain versions), against the JAX function of bench.py's cell on the
same inputs: 16x16, 2 spp, 5 bounces, frame 3 (NEE: frames 0-3), a
target uniform in [0, 0.5) from numpy seed 0. The Pallas kernels run in interpret mode, as
tests/test_torch_grad_kernel.py runs them. Tolerances, from the
cross-package tests of the same entry points:

- the forward buffer (K1): ``trace_kernel.agreement``'s rules, as
  tests/test_torch_trace_kernel.py;
- diffuse loss and gradients (K2 fused): loss rtol 1e-4, gradients rtol
  2e-2 plus 2e-3 of the largest |Pallas| entry (tests/test_torch_grad_kernel.py);
- the two NEE cells (K3 fused; K1 colour sums + K4): held against
  ``jax.value_and_grad`` of the jnp backend with NEE, the estimator the JAX
  package's own tests hold its NEE kernels to; its Pallas NEE calls do not
  finish in interpret mode within minutes here (tests/test_torch_nee_grad.py).
  The JAX side runs op by op (``jax.disable_jit``), as in
  tests/test_torch_inverse.py: XLA's fused CPU code rounds otherwise and
  sends more samples down another path. Frames 0-3 each. A pixel whose
  colour differs by more than ``trace_kernel.COLOR_ATOL`` between the
  packages (a path took another decision) is counted and then left out of
  both losses (its target is each package's own colour): at most
  ``MAX_OFF_SHARE`` of the four frames' pixels, ``trace_kernel.agreement``'s
  colour rule (the counts are printed). Left in, frame 1's pixels break
  the gradient tolerances. A
  second test is the witness that these are rounding: at each path where
  the two packages' f32 decision records split, float64 takes one of the
  two decisions (in frame 1 once JAX's, a shadow ray grazing the r = 1e5
  ceiling; once the port's, a hit at the seam of the light and the
  ceiling). Loss rtol 1e-4; emission and albedo rtol 2e-3 plus 5e-4 of the
  largest; position and radius rtol 2e-3 plus 2e-3; camera position 5e-3 of
  the largest; yaw and pitch 5e-2 of the largest camera-position entry
  (tests/test_torch_nee_grad.py, tests/test_torch_ad_grad.py);
- the inverse step's cross-estimator (two K2 dumps): loss rtol 2e-3,
  gradients rtol 2e-2 plus 2e-2 of the largest (tests/test_torch_inverse.py);
- the denoised frame at 32x32: the CNN's output on the cell's own buffer
  within 1e-4 absolute of Flax's on the same buffer, with JAX's
  ``create_state(jax.random.key(0), ...)`` weights carried across by
  ``convert.py`` (tests/test_torch_model.py); the render is K1's, held above;
- the sharded world-of-one forward against the unsharded cell, to the bit;
  the sharded loss and gradients (K2's dump and the contraction on the
  slab, where the unsharded cell launches K2 fused) under
  ``grad_kernel.agreement``'s sums rule, rtol 1e-4 plus 1e-8 of the largest,
  the port's rule for fused = dump + contraction
  (tests/test_torch_grad_kernel.py); 1e-7 of the largest was measured.

(c) The roofline fields equal ``pathtrace_tpu.utils.roofline.mfu_report``'s
within 1e-3 relative at 512x512x32x5. (d) Earlier records: only the card's
count. (e) The CPU branch prints JSON lines only. (f) Without CUDA and
without ``--device cpu`` it exits non-zero and prints no result.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.grad import render_color as jax_render_color
from pathtrace_tpu.grad import render_loss_grads as jax_render_loss_grads
from pathtrace_tpu.models.denoise_cnn import DenoiseCNN as FlaxDenoiseCNN
from pathtrace_tpu.models.infer import _denoise_jit
from pathtrace_tpu.ops.pallas_grad import pallas_cross_grads, pallas_loss_and_grads
from pathtrace_tpu.ops.pallas_trace import render_channels_pallas
from pathtrace_tpu.train import create_state
from pathtrace_tpu.utils.roofline import mfu_report

from pathtrace_tpu_torch import Camera, bench, cornell_box
from pathtrace_tpu_torch.convert import denoise_state_dict_from_flax
from pathtrace_tpu_torch.models import DenoiseCNN
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import trace_kernel as tk

REPO = Path(__file__).resolve().parents[1]
SIZE, SPP, BOUNCES, FRAME = 16, 2, 5, 3
NEE_FRAMES = (0, 1, 2, 3)
DENOISE_SIZE = 32
ARGS = ["--size", str(SIZE), "--spp", str(SPP), "--bounces", str(BOUNCES)]
SCENE_FIELDS = ("radius", "position", "emission", "color")


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def grads_to_numpy(d_scene, d_cam) -> dict:
    out = {k: _np(getattr(d_scene, k)) for k in SCENE_FIELDS}
    out.update(cam_position=_np(d_cam.position), yaw=_np(d_cam.yaw), pitch=_np(d_cam.pitch))
    return out


def jax_config(**kw):
    return JaxConfig(width=SIZE, height=SIZE, spp=SPP, max_bounces=BOUNCES, **kw)


def run_cell(group, **kw):
    (cell,) = bench.build_cells(group, bench.parse_args(ARGS), "cpu", **kw)
    return cell, cell.call(FRAME)


@pytest.fixture(scope="module")
def target():
    return np.random.default_rng(0).uniform(0.0, 0.5, (SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_inputs():
    return jax_cornell_box(), JaxCamera.create()


# -- (a) the plan ---------------------------------------------------------------------

def bench_py_fields(quick, no_grad, full, on_tpu):
    """The fields bench.py's main sets, in order, from its branch conditions."""
    fields = []
    if on_tpu:  # :175, :197
        fields += ["pallas_fwd_ms", "sharded_1dev_fwd_mrays"]
    if on_tpu and not no_grad:  # :210, :232, :268
        fields += ["pallas_fwd_bwd_mrays", "ad_fwd_bwd_mrays", "ad_backend",
                   "vjp_fwd_bwd_mrays", "sharded_1dev_fwd_bwd_mrays"]
    if on_tpu:  # :285
        fields += ["counted_flops_per_segment", "achieved_tflops", "peak_fma_tflops", "mfu",
                   "vpu_issue_util"]
    if on_tpu and not no_grad and not quick:  # :297
        fields.append("inverse_step_ms")
    if on_tpu and not quick:  # :311
        fields += ["denoised_frame_ms", "denoised_frame_fps"]
    if full or not on_tpu:  # :337
        fields.append("jnp_fwd_mrays")
        if not no_grad:
            fields.append("fwd_bwd_mrays")
    return fields


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("flags", [(), ("--quick",), ("--no-grad",), ("--full",),
                                   ("--quick", "--full"), ("--quick", "--no-grad", "--full")],
                         ids=lambda f: "+".join(f) or "default")
def test_plan_is_bench_py_branches(device, flags):
    args = bench.parse_args(list(flags))
    groups = bench.plan(args, device)
    fields = [f for g in groups for f in bench.GROUP_FIELDS[g]]
    assert fields == bench_py_fields("--quick" in flags, "--no-grad" in flags,
                                     "--full" in flags, device == "cuda")
    assert (args.size, args.spp) == ((128, 4) if "--quick" in flags else (512, 32))


def test_calls_a_sample_are_bench_py_k():
    for flags, quick in (([], False), (["--quick"], True)):
        args = bench.parse_args(flags + ["--full"])
        ks = {}
        for group in bench.plan(args, "cuda"):
            if group in ("mfu", "denoised"):
                continue
            for cell in bench.build_cells(group, args, "cpu"):
                ks[cell.field] = (cell.k, cell.plain)
        want = {f: 64 for f in ("sharded_1dev_fwd_mrays", "pallas_fwd_bwd_mrays",
                                "sharded_1dev_fwd_bwd_mrays", "jnp_fwd_mrays", "fwd_bwd_mrays")}
        want.update(pallas_fwd_ms=128, ad_fwd_bwd_mrays=32, vjp_fwd_bwd_mrays=32)
        if not quick:
            want["inverse_step_ms"] = 64
        want = {f: (min(k, 8) if quick else k) for f, k in want.items()}
        assert {f: k for f, (k, _) in ks.items()} == want
        assert {f for f, (_, plain) in ks.items() if plain} == {"jnp_fwd_mrays", "fwd_bwd_mrays"}


# -- (b) the card cells against bench.py's JAX functions -----------------------------------

def test_headline_cell_is_the_pallas_forward(jax_inputs):
    _, got = run_cell("fwd")
    want = render_channels_pallas(*jax_inputs, jax_config(backend="pallas"), FRAME,
                                  interpret=True)
    checks, _ = tk.agreement(got, torch.from_numpy(np.asarray(want)), "channels", SPP)
    failed = [(name, share) for name, share, _, ok in checks if not ok]
    assert not failed, failed


def test_sharded_forward_is_the_forward_to_the_bit():
    _, got = run_cell("sharded_fwd")
    _, want = run_cell("fwd")
    assert torch.equal(got, want)


def test_fwd_bwd_cell_is_pallas_loss_and_grads(jax_inputs, target):
    cell, (loss, grads) = run_cell("fwd_bwd", target=target)
    loss_j, grads_j = pallas_loss_and_grads(*jax_inputs, jax_config(backend="pallas"), FRAME,
                                            jnp.asarray(target), interpret=True)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    got, want = grads_to_numpy(*grads), grads_to_numpy(*grads_j)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=2e-2,
                                   atol=2e-3 * np.abs(want[name]).max(), err_msg=name)
    assert float(cell.scalar((loss, grads))) == pytest.approx(
        float(loss) + float(grads[0].emission.sum()), rel=1e-6)


def test_sharded_fwd_bwd_is_the_fwd_bwd_cell(target):
    _, (loss, grads) = run_cell("sharded_fwd_bwd", target=target)
    _, (loss_u, grads_u) = run_cell("fwd_bwd", target=target)
    for got, want in ((loss[None], loss_u[None]),
                      (torch.cat([grads[0].emission, grads[0].color], 1),
                       torch.cat([grads_u[0].emission, grads_u[0].color], 1))):
        checks, _ = gk.agreement(got.reshape(-1), want.reshape(-1), "sums")
        assert all(ok for *_, ok in checks), checks
    got, want = grads_to_numpy(*grads), grads_to_numpy(*grads_u)
    for name in ("radius", "position", "cam_position", "yaw", "pitch"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert not want[name].any()


def nee_cfg():
    return dataclasses.replace(bench.bench_config(bench.parse_args(ARGS)), nee=True)


@pytest.fixture(scope="module")
def nee_frames(jax_inputs, target):
    """For each of NEE_FRAMES: (pixels whose paths differ, the port's target,
    JAX's loss, JAX's gradients), JAX's by ``jax.value_and_grad`` of the jnp
    backend with NEE, op by op. A pixel's paths differ where the port's NEE
    colour (K1's plain version) and JAX's differ by more than
    ``trace_kernel.COLOR_ATOL``; there each package's target is its own
    colour, so the pixel adds nothing to either loss or gradient."""
    jcfg = jax_config(backend="jnp", nee=True)
    out = {}
    for frame in NEE_FRAMES:
        port = tk.render_color_sums(cornell_box(), Camera.create(), nee_cfg(), frame,
                                    device="cpu") / SPP
        with jax.disable_jit():
            ref = np.asarray(jax_render_color(*jax_inputs, jcfg, frame), np.float64)
        off = np.abs(_np(port) - ref).max(axis=-1) > tk.COLOR_ATOL
        t_port = np.where(off[..., None], port.numpy(), target).astype(np.float32)
        t_jax = np.where(off[..., None], ref, target).astype(np.float32)
        with jax.disable_jit():
            loss, grads = jax_render_loss_grads(*jax_inputs, jcfg, frame, jnp.asarray(t_jax))
        out[frame] = off, t_port, float(loss), grads_to_numpy(*grads)
    return out


def test_nee_paths_differ_in_few_pixels(nee_frames):
    """``trace_kernel.agreement``'s colour rule over the frames stacked: at
    most MAX_OFF_SHARE of the pixels differ by more than COLOR_ATOL."""
    off = np.stack([nee_frames[f][0] for f in NEE_FRAMES])
    counts = {f: int(nee_frames[f][0].sum()) for f in NEE_FRAMES}
    print(f"pixels whose paths differ, by frame: {counts} of {SIZE * SIZE} each")
    assert off.mean() <= tk.MAX_OFF_SHARE, counts


@pytest.mark.parametrize("group", ["nee", "vjp"])
def test_nee_cells_match_jnp_ad(group, nee_frames):
    for frame in NEE_FRAMES:
        _, t_port, loss_j, want = nee_frames[frame]
        (cell,) = bench.build_cells(group, bench.parse_args(ARGS), "cpu", target=t_port)
        loss, grads = cell.call(frame)
        np.testing.assert_allclose(float(loss), loss_j, rtol=1e-4, err_msg=f"frame {frame}")
        got = grads_to_numpy(*grads)

        def close(name, rtol, atol_scale, scale=None):
            w = want[name]
            scale = max(float(np.abs(w).max()), 1e-12) if scale is None else scale
            np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol_scale * scale,
                                       err_msg=f"frame {frame}: {name}")

        close("emission", 2e-3, 5e-4)
        close("color", 2e-3, 5e-4)
        close("position", 2e-3, 2e-3)
        close("radius", 2e-3, 2e-3)
        close("cam_position", 2e-3, 5e-3)
        cam_scale = float(np.abs(want["cam_position"]).max())
        close("yaw", 0.0, 5e-2, cam_scale)
        close("pitch", 0.0, 5e-2, cam_scale)
        assert np.abs(got["position"]).max() > 0 and np.abs(got["cam_position"]).max() > 0
    assert cell.k == bench.K_NEE


def test_nee_path_splits_are_f32_borderlines(jax_inputs, monkeypatch):
    """Where the two packages' f32 NEE paths take another decision, float64
    takes one of their two decisions, and a split of the sphere hit is
    between two hits within 1e-5 of each other in float64: rounding at a
    boundary, not a difference of the packages. The decisions are the
    frozen-decision records (``ops/frozen.py`` in each package) of
    NEE_FRAMES; the port's record in float64 is the witness. Each split is
    printed with the float64 margins (``pytest -s``)."""
    from pathtrace_tpu.ops import frozen as jax_frozen
    from pathtrace_tpu_torch.config import RenderConfig
    from pathtrace_tpu_torch.ops import frozen

    rays = {"hit": [], "shadow": []}  # the float64 record's rays, a bounce a call
    hit, shadow = frozen._intersect_record, frozen.shadow_visibility

    def spy_hit(scene, ray_o, dn, inv_len):
        if dn.dtype == torch.float64:
            rays["hit"].append((torch.broadcast_to(ray_o, dn.shape), dn))
        return hit(scene, ray_o, dn, inv_len)

    def spy_shadow(origin, direction, scene, light_index):
        if direction.dtype == torch.float64:
            rays["shadow"].append((origin, direction / direction.norm(dim=-1, keepdim=True)))
        return shadow(origin, direction, scene, light_index)

    monkeypatch.setattr(frozen, "_intersect_record", spy_hit)
    monkeypatch.setattr(frozen, "shadow_visibility", spy_shadow)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP, max_bounces=BOUNCES, nee=True)
    scene64 = cornell_box().astype(torch.float64)
    names = frozen.Decisions._fields
    splits = paths = 0
    for frame in NEE_FRAMES:
        rays = {"hit": [], "shadow": []}
        with jax.disable_jit():
            (rec_j,) = jax_frozen.record_frame(*jax_inputs, jax_config(backend="jnp", nee=True),
                                               frame)[1]
        (rec_p,) = frozen.record_frame(cornell_box(), Camera.create(), cfg, frame,
                                       device="cpu")[1]
        (rec_64,) = frozen.record_frame(scene64, Camera.create().astype(torch.float64), cfg,
                                        frame, device="cpu")[1]
        dec = {n: np.stack([np.asarray(getattr(r, n), np.float64) for r in (rec_j, rec_p)]
                           + [getattr(rec_64, n).double().numpy()]) for n in names}
        split = np.zeros(dec["idx"].shape[1:-1], bool)
        for n in names:
            split |= (dec[n][0] != dec[n][1]).any(axis=-1)
        paths += split.size
        for s, y, x in np.argwhere(split):
            splits += 1
            kinds = [n for n in names if (dec[n][0, s, y, x] != dec[n][1, s, y, x]).any()]
            b = min(int(np.argmax(dec[n][0, s, y, x] != dec[n][1, s, y, x])) for n in kinds)
            jax32, port32, f64 = ([int(dec[n][k, s, y, x, b]) for n in names] for k in range(3))
            assert f64 in (jax32, port32), (frame, s, y, x, b)
            print(f"frame {frame}, sample {s}, pixel ({y}, {x}), bounce {b}: "
                  f"{dict(zip(names, jax32))} in JAX, {dict(zip(names, port32))} in the port; "
                  f"float64 sides with {'JAX' if f64 == jax32 else 'the port'}")
            kind = "shadow" if kinds == ["vis"] else "hit"
            o, d = (t[s, y, x] for t in rays[kind][b])
            ts = {}
            for i in range(scene64.num_objects):
                rel = scene64.position[i] - o
                tca = float(rel @ d)
                det = float(scene64.radius[i] ** 2 - torch.sum((rel - tca * d) ** 2))
                if det >= 0.0:
                    ts[i] = (tca - det ** 0.5, tca + det ** 0.5)
            print(f"  float64 roots along the {kind} ray: "
                  + ", ".join(f"sphere {i} {a:.10g} / {c:.10g}" for i, (a, c) in ts.items()))
            if "idx" in kinds:
                i_j, i_p = int(dec["idx"][0, s, y, x, b]), int(dec["idx"][1, s, y, x, b])
                t_j = ts[i_j][0 if dec["use_near"][0, s, y, x, b] else 1]
                t_p = ts[i_p][0 if dec["use_near"][1, s, y, x, b] else 1]
                assert abs(t_j - t_p) <= 1e-5 * abs(t_p), (t_j, t_p)
    assert splits <= tk.MAX_OFF_SHARE * paths, (splits, paths)


def test_inverse_cell_is_pallas_cross_grads(jax_inputs, target, monkeypatch):
    monkeypatch.setattr(bench, "INVERSE_SIZE", SIZE)
    monkeypatch.setattr(bench, "INVERSE_SPP", SPP)
    _, (loss, grads) = run_cell("inverse", target=target)
    cfg = JaxConfig(width=SIZE, height=SIZE, spp=SPP, backend="pallas")
    loss_j, grads_j = pallas_cross_grads(*jax_inputs, cfg, FRAME, jnp.asarray(target),
                                         interpret=True)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-3)
    for name in ("color", "emission"):
        want = np.asarray(grads_j[name], np.float64)
        np.testing.assert_allclose(_np(grads[name]), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max(), err_msg=name)


def test_denoised_cell_is_denoise_jit_on_jax_weights():
    flax_model = FlaxDenoiseCNN()
    state = create_state(jax.random.key(0), flax_model, (DENOISE_SIZE, DENOISE_SIZE, 14))
    port = DenoiseCNN()
    port.load_state_dict(denoise_state_dict_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}))
    args = bench.parse_args(["--size", str(DENOISE_SIZE)])
    (cell,) = bench.build_cells("denoised", args, "cpu", model=port)
    got = cell.call(FRAME)
    cfg = bench.bench_config(args, spp=bench.DENOISE_SPP)
    buf = tk.render_channels(cornell_box(), Camera.create(), cfg, FRAME, "cpu")
    want = np.asarray(_denoise_jit(flax_model, state.params, state.batch_stats,
                                   jnp.asarray(buf.numpy())))
    assert got.shape == want.shape == (DENOISE_SIZE, DENOISE_SIZE, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-4
    assert cfg.spp == 4 and cell.k == 64


# -- (c) the roofline fields -------------------------------------------------------------

def test_mfu_fields_are_mfu_report():
    peaks = {"peak_fma_flops": 65.8e12, "peak_mul_flops": 32.8e12}
    seconds = 1.21e-3
    got = bench.mfu_fields(512, 512, 32, 5, seconds, peaks)
    rep = mfu_report(JaxConfig(width=512, height=512, spp=32, max_bounces=5), seconds,
                     peaks=peaks)
    want = {
        "counted_flops_per_segment": rep["counted_flops_per_segment"],
        "achieved_tflops": rep["achieved_flops_per_sec"] / 1e12,
        "peak_fma_tflops": rep["peak_fma_flops"] / 1e12,
        "mfu": rep["mfu"],
        "vpu_issue_util": rep["vpu_issue_util"],
    }
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == pytest.approx(value, rel=1e-3), name


# -- (d) earlier records ------------------------------------------------------------------

def test_priors_count_the_card_records_only(tmp_path):
    tpu = {"value": 90000.0, "backend": "tpu", "pallas_fwd_bwd_mrays": 80000.0,
           "denoised_frame_fps": 900.0}
    cuda_a = {"value": 30000.0, "backend": "cuda", "pallas_fwd_bwd_mrays": 25000.0,
              "sharded_1dev_fwd_mrays": 28000.0, "pallas_fwd_ms": 1.4}
    cuda_b = {"value": 34000.0, "backend": "cuda", "pallas_fwd_bwd_mrays": 24000.0,
              "denoised_frame_fps": 200.0}
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(tpu))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps(cuda_a))
    (tmp_path / "BENCH_r03.json").write_text(json.dumps({"parsed": cuda_b, "rc": 0}))
    (tmp_path / "BENCH_r04.json").write_text("not json")
    recs = bench.prior_records(tmp_path)
    assert sorted(r["value"] for r in recs) == [30000.0, 34000.0]

    extras = {"pallas_fwd_ms": 1.2, "sharded_1dev_fwd_mrays": 33000.0,
              "pallas_fwd_bwd_mrays": 30000.0, "denoised_frame_fps": 220.0, "mfu": 0.26,
              "vjp_fwd_bwd_mrays": 7000.0}
    headline = 35000.0
    vs_baseline, vs_prior = bench.compare_priors(headline, extras, recs)
    root = _root_bench()
    cuda = [cuda_a, cuda_b]
    assert vs_baseline == round(headline / root._prior_best(cuda, "value"), 3)
    want = {f: round(v / root._prior_best(cuda, f), 3) for f, v in extras.items()
            if f.endswith(("_mrays", "_fps")) and root._prior_best(cuda, f)}
    assert vs_prior == want
    assert set(want) == {"sharded_1dev_fwd_mrays", "pallas_fwd_bwd_mrays", "denoised_frame_fps"}
    assert bench.compare_priors(headline, extras, []) == (1.0, {})


# -- (e) the CPU branch, (f) no device ----------------------------------------------------------

def test_cpu_branch_prints_json_lines_of_the_plain_legs(capsys):
    assert bench.main(["--device", "cpu", "--size", "16", "--spp", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    records = [json.loads(line) for line in lines]
    last = records[-1]
    assert last["backend"] == "cpu" and last["device"] == "cpu"
    for field in ("jnp_fwd_mrays", "fwd_bwd_mrays"):
        assert np.isfinite(last[field]) and last[field] > 0
        assert last["samples"][field] >= bench.PLAIN_SAMPLES
        assert last["calls"][field] == 64
        assert np.isfinite(last["spread"][field])
    assert last["value"] == last["jnp_fwd_mrays"]
    assert last["vs_baseline"] == 1.0 and last["n_rays_per_frame"] == 16 * 16 * 2 * 5
    assert last["metric"] == "Mrays/s/chip fwd (Cornell 16^2 x 2spp x 5 bounces)"
    assert "pallas_fwd_ms" not in last and "mfu" not in last


def test_no_cuda_without_device_cpu_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err


def test_module_run_without_cuda_prints_no_result():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "pathtrace_tpu_torch.bench", "--quick"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
