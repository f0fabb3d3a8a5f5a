"""The traced window's reduction, on made-up profiler events: the union of
device activity, time and launches by name, idle gaps by host operation,
and the readers built on it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, tracing


class Event:
    def __init__(self, name, start_us, end_us, device=False):
        self._n, self._s, self._e, self._d = name, start_us * 1000, end_us * 1000, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._n == tracing.WINDOW_SPAN


def summary(events, window_s=None):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return tracing.summarize(prof, window_s)


EVENTS = [
    Event(tracing.WINDOW_SPAN, 100, 1100),
    Event("aten::conv2d", 100, 400), Event("Optimizer.step#SGD.step", 600, 1000),
    Event("void (anonymous namespace)::pathtrace_kernel<14>(pt::TraceParams)", 50, 300, True),
    Event("sm80_xmma_fprop_cudnn", 250, 350, True),  # overlaps the one before
    Event("void (anonymous namespace)::nee_grad_kernel<1, true>(pt::TraceParams)", 500, 700, True),
    Event("Memcpy DtoH (Device -> Pageable)", 1050, 1200, True),  # cut at the window's end
]


def test_busy_time_is_the_union_inside_the_window():
    t = summary(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # [100, 350] + [500, 700] + [1050, 1100]
    assert t.busy_s == pytest.approx(500e-6)
    assert t.kernel_launches() == 3
    assert t.device_time["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(50e-6)


def test_a_window_traced_for_the_device_alone_takes_its_length_from_the_host():
    device = [e for e in EVENTS if e._d]
    t = summary(device, window_s=2e-3)
    assert t.window_s == 2e-3
    # [50, 350] + [500, 700] + [1050, 1200]: all of the block's device activity
    assert t.busy_s == pytest.approx(650e-6)
    assert t.kernel_launches() == 3
    assert t.device_time["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(150e-6)


def test_idle_gaps_by_host_operation():
    t = summary(EVENTS)
    # gaps [350, 500] (middle 425: no host op), [700, 1050] (middle 875: the optimiser)
    assert t.idle_by_host["Optimizer.step#SGD.step"] == pytest.approx(350e-6)
    assert t.idle_by_host["host, between operations"] == pytest.approx(150e-6)
    assert [name for name, _ in t.breakdown()["idle_gaps"]][0] == "Optimizer.step#SGD.step"


def test_readers():
    t = summary(EVENTS)
    work = {"units": 2, "ops_per_unit": 67e6, "k1_segments": 1000, "k3_segments": 1000}
    assert harness.load_reader("idle_share.render")(t, work) == pytest.approx(50.0)
    assert harness.load_reader("mfu.render")(t, work) == pytest.approx(100 * 2 * 67e6 / (1e-3 * 67e12))
    k1 = harness.load_reader("k1_roofline.render")(t, work)
    assert k1 == pytest.approx(100 * (1000 * 568.0 / 67e12) / 200e-6)
    k3 = harness.load_reader("k3_roofline.inverse")(t, work)
    assert k3 == pytest.approx(100 * (1000 * 1211.6 / 67e12) / 200e-6)
    assert harness.load_reader("denoise_device_ms.frame")(t, work) == pytest.approx(100e-3 / 2)
    assert harness.load_reader("kernels_per_step.train")(t, work) == 1.5
    assert harness.load_reader("kernels_per_step.train")(t, {"units": 0}) is None


@pytest.mark.parametrize("cell", ["inverse", "train"])
def test_device_and_host_time_a_step(cell):
    t = summary([e for e in EVENTS if e._d], window_s=2e-3)
    # busy 650 us and a 2 ms window, over 4 steps
    assert harness.load_reader(f"{cell}_device_ms")(t, {"units": 4}) == pytest.approx(650e-3 / 4)
    assert harness.load_reader(f"host_step_ms.{cell}")(t, {"units": 4}) == pytest.approx(0.5)
    assert harness.load_reader(f"{cell}_device_ms")(t, {"units": 0}) is None
    assert harness.load_reader(f"{cell}_device_ms")(summary([], window_s=2e-3), {"units": 4}) is None
