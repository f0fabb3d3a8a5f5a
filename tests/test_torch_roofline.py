"""The f32 probes' plain versions and the bound arithmetic (no card needed).

The probe kernel (``csrc/probe_kernel.cu``) runs only on a CUDA device; its
plain version, the same chains as a torch loop, is held here against the
chains' closed forms, and ``bound_ms`` and ``count_segments`` against
numbers worked out by hand. The kernel against the plain version on the
card is in tests/test_torch_nee_grad_cuda.py and chip_smoke.py (phase 11).
"""

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.scene import Scene
from pathtrace_tpu_torch.utils import roofline as rf

ITERS = 2
STEPS = ITERS * rf.INNER


def inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((1.0 + 0.1 * rng.uniform(size=(4, 128))).astype(np.float32))
    a = torch.from_numpy((0.9999 + 1e-4 * rng.uniform(size=(4, 128))).astype(np.float32))
    return x, a


def closed_form(mode, x, a, steps):
    """The chain's value in float64: x_{k+1} = p x_k + q is affine, so
    x_n = p^n x_0 + q (p^n - 1) / (p - 1) (q n when p is 1)."""
    x, a = x.double(), a.double()
    b, c = x * float(np.float32(1e-7)), x * float(np.float32(1e-9))
    p, q = {"mul": (a, 0 * b), "add": (1 + 0 * a, b), "fma": (a, b), "mul_then_add": (a, b),
            "add_add": (1 + 0 * a, b + c), "fma_fma": (a * a, a * b + c)}[mode]
    geometric = torch.where(p == 1, torch.full_like(p, steps), (p ** steps - 1) / (p - 1 + (p == 1)))
    return p ** steps * x + q * geometric


@pytest.mark.parametrize("mode", rf.LATENCY_MODES)
def test_latency_chain_plain_matches_closed_form(mode):
    """One chain, 64 steps of float32 rounding: within 1e-5 of the value."""
    x, a = inputs()
    got = rf.latency_chain(x, a, mode, ITERS)
    assert got.dtype == torch.float32 and got.shape == x.shape
    torch.testing.assert_close(got.double(), closed_form(mode, x, a, STEPS), rtol=1e-5, atol=0)


@pytest.mark.parametrize("fma", [True, False])
def test_peak_chain_plain_is_the_sum_of_its_chains(fma):
    x, a = inputs()
    got = rf.peak_chain(x, a, fma, ITERS)
    mode = "fma" if fma else "mul"
    want = sum(closed_form(mode, x * float(np.float32(1.0) + np.float32(0.001) * np.float32(j)),
                           a, STEPS) for j in range(rf.PEAK_CHAINS))
    # b and c follow the element's x, not the chain's start: correct the FMA offset
    if fma:
        xs = x.double()
        scale = sum(1.0 + 0.001 * j for j in range(rf.PEAK_CHAINS))
        p = a.double()
        geometric = (p ** STEPS - 1) / (p - 1)
        want = p ** STEPS * xs * scale + rf.PEAK_CHAINS * xs * 1e-7 * geometric
    torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=0)


def test_fused_steps_round_once():
    """fma keeps the product exact: it differs from mul_then_add where the
    product's rounding matters, and equals the double-precision value."""
    x = torch.tensor([[1.0 + 2.0 ** -12] * 128], dtype=torch.float32)
    a = torch.tensor([[1.0 + 2.0 ** -12] * 128], dtype=torch.float32)
    b = x * np.float32(3e-8)  # a quarter of an ulp; the product's lost bit is half of one
    one = (x.double() * a.double() + b.double()).float()
    assert torch.equal(rf._step_plain("fma", x, a, b, b), one)
    assert not torch.equal(rf._step_plain("mul_then_add", x, a, b, b), one)


def test_zero_trips_return_the_start():
    x, a = inputs()
    assert torch.equal(rf.latency_chain(x, a, "fma", 0), x)


@pytest.mark.parametrize("bad", ["mode", "dtype", "shape", "contiguous", "iters", "device"])
def test_chain_wrapper_rejects_bad_input(bad):
    x, a = inputs()
    mode, iters = "fma", 1
    if bad == "mode":
        mode = "div"
    elif bad == "dtype":
        x = x.double()
    elif bad == "shape":
        a = a[:2]
    elif bad == "contiguous":
        x, a = x.T, a.T
    elif bad == "iters":
        iters = -1
    elif bad == "device":
        x, a = x.to("meta"), a.to("meta")
    with pytest.raises(ValueError):
        rf.latency_chain(x, a, mode, iters)


def test_measurements_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (rf.measure_f32_peak, rf.latency_probe):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(device=torch.device("cuda", 0))


def test_bound_ms():
    # 512 x 512 x 32 spp x 5 bounces = 41.94 M segments of 568 operations at 30e12 a second
    assert rf.bound_ms(512 * 512 * 32 * 5, 568.0, 30e12) == pytest.approx(0.79412, rel=1e-4)
    assert rf.bound_ms(0, 568.0, 1e12) == 0.0
    with pytest.raises(ValueError):
        rf.bound_ms(1, 1.0, 0.0)
    counts = rf.OPS_PER_SEGMENT
    assert counts["forward_diffuse"] < counts["color_nee"] < counts["forward_nee"]
    assert counts["nee_grad_fused"] == pytest.approx(1973.6)


@pytest.mark.parametrize("kernel,want_ms", [("forward_diffuse", 0.355577), ("forward_nee", 0.562162),
                                            ("color_nee", 0.549517), ("nee_grad_fused", 1.235504)])
def test_bound_at_the_published_f32_peak(kernel, want_ms):
    """The counts credit a multiply and an add with two operations, so they
    go over a peak that credits a fused multiply-add with two: 41.94 M
    segments (512 x 512 x 32 spp x 5 bounces) at 67 TFLOP/s, worked by hand."""
    got = rf.bound_ms(512 * 512 * 32 * 5, rf.OPS_PER_SEGMENT[kernel], 67e12)
    assert got == pytest.approx(want_ms, rel=1e-5)
    # Over the rate of single instructions (half the peak) the bound is twice as long.
    assert rf.bound_ms(512 * 512 * 32 * 5, rf.OPS_PER_SEGMENT[kernel], 33.5e12) == \
        pytest.approx(2 * got)


def test_reading_shapes_are_the_named_ones():
    """chip_smoke.py holds the probes against their plain versions at the
    shapes the readings launch: the defaults are the named constants."""
    import inspect

    peak = inspect.signature(rf.measure_f32_peak).parameters
    lat = inspect.signature(rf.latency_probe).parameters
    assert (peak["grid"].default, peak["iters"].default) == (rf.PEAK_GRID, rf.PEAK_ITERS)
    assert (lat["grid"].default, lat["iters"].default) == (rf.LATENCY_GRID, rf.LATENCY_ITERS)
    x, a = rf.probe_inputs(rf.LATENCY_GRID * 8, "cpu")
    assert x.shape == a.shape == (64, 128) and float(a.max()) < 1.0 == float(x.min())


@pytest.mark.parametrize("case", ["closed box", "no scene", "one bounce", "nee"])
def test_count_segments(case):
    """Segments really traced: every primary ray, and a further one for each
    bounce that hit (the kernels stop a path at its first escape)."""
    cam = Camera.create()
    cfg = RenderConfig(width=16, height=8, spp=3, max_bounces=4)
    if case == "closed box":  # nothing escapes the Cornell box
        assert rf.count_segments(cornell_box(), cam, cfg) == 16 * 8 * 3 * 4
    elif case == "nee":
        import dataclasses

        assert rf.count_segments(cornell_box(), cam, dataclasses.replace(cfg, nee=True)) \
            == 16 * 8 * 3 * 4
    elif case == "one bounce":
        import dataclasses

        assert rf.count_segments(cornell_box(), cam,
                                 dataclasses.replace(cfg, max_bounces=1)) == 16 * 8 * 3
    else:  # a far, tiny sphere: every primary ray escapes, and is the only segment
        far = Scene(np.array([1e-3], np.float32), np.array([[0.0, 1e4, 0.0]], np.float32),
                    np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32))
        assert rf.count_segments(far, cam, cfg) == 16 * 8 * 3


@pytest.mark.parametrize("name", ["diffuse", "nee_diffuse", "glossy", "nee_glossy"])
def test_counted_operations_of_the_hand_derived_backward(name):
    """``OPS_PER_SEGMENT``'s entries for K4 are what scripts/torch_count_ops.py
    counts on the plain version (a taped forward sample plus the sweep with
    indexed accumulators), at any tile size; the forward part stays within
    8% of the JAX package's jaxpr counts of the same trajectory, which lack
    the tape's four selects a sphere."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_count_ops.py"
    spec = importlib.util.spec_from_file_location("torch_count_ops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = RenderConfig(width=8, height=8, spp=2, nee=name.startswith("nee"),
                       brdf=name.split("_")[-1])
    sb = cornell_box().packed()
    cb = tk.camera_block(Camera.create(), cfg)
    extra = torch.tensor([[1e-3, 50.0, 40.0, 1.0e4, 0.0, 0.0, 0.0, 0.5, 0.5, 0.5]])
    f9, t9 = mod.counts_for(cfg, sb, cb)
    f10, t10 = mod.counts_for(cfg, torch.cat([sb, extra]), cb)
    sweep = (t9 - f9) - 8 * ((t10 - f10) - (t9 - f9))
    key = {"diffuse": "ad_diffuse", "nee_diffuse": "ad_nee", "glossy": "ad_glossy",
           "nee_glossy": "ad_nee_glossy"}[name]
    assert (f9 + sweep) / 5 == pytest.approx(rf.OPS_PER_SEGMENT[key], abs=0.05)
    if name == "diffuse":
        assert f9 / 5 == pytest.approx(rf.OPS_PER_SEGMENT["forward_diffuse"], rel=0.08)
    if name == "nee_diffuse":
        assert f9 / 5 == pytest.approx(rf.OPS_PER_SEGMENT["forward_nee"], rel=0.08)
        assert (f9 + sweep) / 5 < rf.OPS_PER_SEGMENT["ad_replay_nee_jaxpr"]
