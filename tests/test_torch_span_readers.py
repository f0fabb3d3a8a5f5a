"""What reads the program's spans: ``benchmark/spans.py`` and the readers
``benchmark/metrics/host_ms.*``, ``idle_ms.*`` and ``launch_us.*``.

On made-up spans, idle intervals and launch counters each reader gives the
value worked out by hand, and None where the trace has no recording, no
units or no such span. The device's idle intervals are the complement of
its activity in the recorded window; the report splits them by span. On
the CPU at small sizes, a cell's window recorded by ``record_cell`` gives
every metric of the host's clock, with the leaves covering their root; the
harness's own run with ``--trace 0`` never starts a recording.
"""

import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans, tracing
from pathtrace_tpu_torch.utils import timing

MS = 1_000_000  # ns
SMALL = {
    "cornell-diffuse.preview": dict(width=24, height=24, widths=(8, 16)),
    "cornell-nee.inverse_geometry": dict(width=16, height=16, spp=2),
    "cornell-diffuse.train": dict(pool=20, patch=32, widths=(8, 16)),
}
SEED = 2**31 + 4242
SPAN_METRICS = [m for ms in spans.CELL_METRICS.values() for m in ms if not m.startswith("launch")]


def made_up(name):
    """Two units of ``name`` (30 ms and 40 ms), a span of another name over
    both, and the device idle in [20, 50], [150, 160], [210, 230] ms."""
    rows = [("other", 0, 300 * MS, None, 0), (name, 20 * MS, 50 * MS, 0, 0),
            (name, 140 * MS, 180 * MS, 0, 0)]
    trace = tracing.Trace(window_s=0.3, busy_s=0.25)
    rec = timing.Recording(spans=rows, launches={}, launch_ns={})
    return spans.attach(trace, rec, [(20 * MS, 50 * MS), (150 * MS, 160 * MS),
                                     (210 * MS, 230 * MS)])


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers(metric):
    kind, name = metric.split(".", 1)
    read = harness.load_reader(metric)
    # host: (30 + 40) / 2; idle: (30 + 10) / 2
    assert read(made_up(name), {"units": 2}) == pytest.approx(35.0 if kind == "host_ms" else 20.0)
    assert read(made_up(name), {"units": 0}) is None
    assert read(made_up("not." + name), {"units": 2}) is None
    assert read(tracing.Trace(window_s=0.3, busy_s=0.25), {"units": 2}) is None
    if kind == "idle_ms":
        assert read(spans.attach(made_up(name), timing.Recording(spans=made_up(name).spans)),
                    {"units": 2}) is None  # no device trace


def test_launch_reader():
    read = harness.load_reader("launch_us.inverse")
    trace = spans.attach(tracing.Trace(window_s=1.0, busy_s=0.5), timing.Recording(
        launches={"k1": 2, "k3.replay": 2, "k2.dump": 5},
        launch_ns={"k1": 40_000, "k3.replay": 60_000, "k2.dump": 999}))
    assert read(trace, {"units": 2}) == pytest.approx(25.0)
    trace.launches = {"k1": 0, "k3.replay": 0}
    assert read(trace, {"units": 2}) is None
    assert read(tracing.Trace(window_s=1.0, busy_s=0.5), {"units": 2}) is None


def test_every_cell_metric_has_a_reader():
    names = [m for ms in spans.CELL_METRICS.values() for m in ms]
    assert len(names) == len(set(names)) == 14
    assert all(callable(harness.load_reader(m)) for m in names)


class Event:
    def __init__(self, name, start_ms, end_ms, device=True, annotation=False):
        self._n, self._s, self._e = name, start_ms * MS, end_ms * MS
        self._d, self._a = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a


def test_idle_intervals_are_the_complement_of_device_activity():
    events = [Event("k1", 10, 30), Event("conv", 25, 40), Event("copy", 60, 70),
              Event("host op", 40, 60, device=False), Event("span", 0, 100, annotation=True),
              Event("late", 95, 130)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert spans.idle_intervals(prof, 0, 100 * MS) == [(0, 10 * MS), (40 * MS, 60 * MS),
                                                       (70 * MS, 95 * MS)]
    assert spans.idle_intervals(prof, 100 * MS, 140 * MS) == [(130 * MS, 140 * MS)]


def test_span_report_splits_idle_time_by_span():
    rows = [("frame", 0, 100 * MS, None, 0), ("frame.render", 0, 40 * MS, 0, 0),
            ("frame.denoise", 40 * MS, 90 * MS, 0, 0), ("read", 100 * MS, 110 * MS, None, 0)]
    idle = [(30 * MS, 50 * MS), (95 * MS, 105 * MS), (120 * MS, 130 * MS)]
    trace = spans.attach(tracing.Trace(window_s=0.13, busy_s=0.09),
                         timing.Recording(spans=rows), idle)
    report = spans.span_report(trace, {"units": 1})
    assert report["host_ms"] == {"frame": 100.0, "frame.denoise": 50.0, "frame.render": 40.0,
                                 "read": 10.0}
    assert report["leaf_share"] == {"frame": 0.9}
    assert report["idle_ms"] == pytest.approx({"frame": 5.0, "frame.render": 10.0,
                                               "frame.denoise": 10.0, "read": 5.0,
                                               "outside every span": 10.0})
    assert report["idle_ms_total"] == pytest.approx(40.0)
    assert spans.overlaps_ns(idle, [(0, 45 * MS), (45 * MS, 200 * MS)]) == [15 * MS, 25 * MS]


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_recorded_window_on_the_cpu(cell):
    r = spans.record_cell(cell, SEED, 0.3, torch.device("cpu"), overrides=SMALL[cell])
    assert r["profiled"] is False and r["correct"] and r["units"] > 0
    values = r["metrics"]
    assert set(values) == set(spans.CELL_METRICS[cell])
    for name, v in values.items():
        if name.startswith("host_ms"):
            assert v is not None and math.isfinite(v) and v >= 0, name
        else:  # the device's trace and the kernels' launches: the card's alone
            assert v is None, name
    (root, share), = r["spans"]["leaf_share"].items()
    assert 0.9 <= share <= 1.0, (root, share)
    assert "idle_ms" not in r["spans"] and r["launches"] == {}


def test_the_harness_without_trace_never_records(monkeypatch):
    def refuse():
        raise AssertionError("a --trace 0 run started a recording")

    monkeypatch.setattr(timing, "start_recording", refuse)
    cell = "cornell-diffuse.train"
    r = harness.run_cell(cell, SEED, 0.3, False, torch.device("cpu"), overrides=SMALL[cell])
    assert r["correct"] and not timing._REC.on
