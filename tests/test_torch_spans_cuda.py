"""The program's spans and launch counters on the card.

- The spans and ``torch.profiler``'s device trace share one clock: in a
  recorded denoised frame, K1's partials kernel starts after the frame's
  ``frame.render`` span starts (the span launches it) and no later than 1 ms
  after the span ends, whether the profiler records the device alone (as
  the benchmark's measured window does) or the host too.
- A recorded NEE inverse step counts the launches the wrappers count, two
  of K1 (colour sums) and two of K3 (replay), with host time in each.
- ``benchmark.spans.record_cell`` reads the inverse cell's spans and
  launch times with the window profiled or not (``--profile 0|1``), and
  the device's idle time by span only where it is profiled.

These need the card and skip elsewhere. On the card:

    python -m pytest tests/test_torch_spans_cuda.py -m cuda --noconftest -o addopts="" -q
"""

import math

import pytest
import torch

from benchmark.tracing import _ns
from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box, inverse
from pathtrace_tpu_torch.interactive import FrameStepper
from pathtrace_tpu_torch.models import init_model
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.train import save_checkpoint
from pathtrace_tpu_torch.utils import timing


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("host", [False, True], ids=["device", "device_and_host"])
def test_k1_starts_inside_its_frame_render_span(dev, tmp_path, host):
    from torch.profiler import ProfilerActivity, profile

    save_checkpoint(str(tmp_path), init_model(torch.Generator().manual_seed(0), widths=(8, 16)))
    cfg = RenderConfig(width=64, height=64, spp=4, backend="cuda")
    stepper = FrameStepper(cornell_box(), Camera.create(), cfg, denoising=True,
                           checkpoint=str(tmp_path), progressive=True, device=dev)
    for _ in range(2):
        stepper.move("left")
        stepper.step()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        timing.start_recording()
        stepper.move("left")
        stepper.step()
        torch.cuda.synchronize()
        rec = timing.stop_recording()
    (s, e), = [(s, e) for name, s, e, _, _ in rec.spans if name == "frame.render"]
    k1 = [_ns(ev, "start") for ev in prof.profiler.kineto_results.events()
          if "CUDA" in str(ev.device_type()).upper() and "pathtrace_kernel" in ev.name()]
    assert len(k1) == 1, k1
    assert s <= k1[0] <= e + 1_000_000, (s, k1[0], e)


@pytest.mark.cuda
def test_a_recorded_inverse_step_counts_its_launches(dev):
    cfg = RenderConfig(width=64, height=64, spp=4, nee=True, backend="cuda")
    state, step_fn, _ = inverse.make_inverse_step(
        cornell_box(), Camera.create(), cfg, torch.zeros(64, 64, 3, device=dev),
        optimize=("position", "radius"), device=dev)
    state, _ = step_fn(state)
    torch.cuda.synchronize()
    k1, k3 = tk.CUDA_KERNEL.launches, nk.CUDA_KERNEL.launches["replay"]
    timing.start_recording()
    state, loss = step_fn(state)
    torch.cuda.synchronize()
    rec = timing.stop_recording()
    assert bool(torch.isfinite(loss))
    assert (rec.launches["k1"], rec.launches["k3.replay"]) == (2, 2)
    assert (tk.CUDA_KERNEL.launches - k1, nk.CUDA_KERNEL.launches["replay"] - k3) == (2, 2)
    assert rec.launch_ns["k1"] > 0 and rec.launch_ns["k3.replay"] > 0
    assert [name for name, *_ in rec.spans] == ["inverse.step", "inverse.grads", "inverse.adam"]


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [False, True], ids=["unprofiled", "profiled"])
def test_a_recorded_inverse_window(dev, profile):
    from benchmark import spans

    r = spans.record_cell("cornell-nee.inverse_geometry", 2**31 + 4243, 0.5, dev, profile=profile,
                          overrides=dict(width=16, height=16, spp=2))
    values = r["metrics"]
    assert r["profiled"] is profile and r["units"] > 0
    for name in ("host_ms.inverse.grads", "host_ms.inverse.adam", "launch_us.inverse"):
        assert values[name] is not None and math.isfinite(values[name]) and values[name] > 0, name
    assert (values["idle_ms.inverse.grads"] is not None) is profile
    assert ("idle_ms" in r["spans"]) is profile
