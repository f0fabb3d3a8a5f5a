"""The program's spans and launch counters (``utils/timing.py``).

- With no recording, ``span`` hands back one shared object that reads no
  clock, allocates nothing and never calls ``torch.profiler``'s
  ``record_function``.
- A recording gives each span its parent and the unit (the root span) it
  belongs to, in the order the spans started; a ``tail`` span belongs to the
  root closed before it.
- The spans lie on the clock of the profiler's host events: a span inside a
  ``record_function`` lies inside that event.
- The launch counters (K1, K3's replay) are the kernel wrappers' own
  counts since the recording started, with the host ns added only while
  recording.
- Each entry point records its spans and no others: a denoised progressive
  frame, an inverse step on either route, training steps through
  ``loop_epoch``.

The card's side (the device trace on the same clock, the counts of a
recorded inverse step) is in tests/test_torch_spans_cuda.py.
"""

import contextlib
import time
import tracemalloc

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box, inverse, train
from pathtrace_tpu_torch.interactive import FrameStepper
from pathtrace_tpu_torch.models import init_model
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.utils import timing


@pytest.fixture(autouse=True)
def no_recording_left():
    yield
    if timing._REC.on:
        timing._REC.open = []
        timing.stop_recording()


def recorded(fn):
    timing.start_recording()
    try:
        fn()
    finally:
        rec = timing.stop_recording()
    return rec


def shape(rec):
    return [(name, parent, unit) for name, _, _, parent, unit in rec.spans]


# -- the recorder ------------------------------------------------------------------

def test_span_off_is_one_shared_object_that_reads_no_clock(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while not recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(timing.time, "time_ns", refuse)
    first = timing.span("frame")
    assert timing.span("train.step") is first and timing.span("x", tail=True) is first
    with timing.span("frame"):
        with timing.span("frame.render"):
            pass
    assert timing.launch_clock() == 0
    timing.add_launch_ns("k1", 0)
    assert timing.stop_recording().spans == []


def test_span_off_allocates_nothing():
    """The call allocates nothing, and a block in it no more than one in an
    empty ``contextlib.nullcontext`` (the ``with`` statement's own)."""
    span, empty = timing.span, contextlib.nullcontext()

    def bare():
        for _ in range(2000):
            pass

    def calls():
        for _ in range(2000):
            span("frame")

    def blocks():
        for _ in range(2000):
            with span("frame"):
                pass

    def nullcontexts():
        for _ in range(2000):
            with empty:
                pass

    peaks = {}
    for fn in (bare, calls, blocks, nullcontexts) * 2:
        fn()
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            fn()
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        peaks[fn.__name__] = min(peak, peaks.get(fn.__name__, peak))
    assert peaks["calls"] <= peaks["bare"]
    assert peaks["blocks"] <= peaks["nullcontexts"]


def test_nesting_gives_parent_and_unit():
    def run():
        with timing.span("a"):
            with timing.span("a.x"):
                pass
            with timing.span("a.y"):
                with timing.span("a.y.z"):
                    pass
        with timing.span("read", tail=True):
            pass
        with timing.span("b"):
            pass
        with timing.span("read", tail=True):
            pass

    rec = recorded(run)
    assert shape(rec) == [("a", None, 0), ("a.x", 0, 0), ("a.y", 0, 0), ("a.y.z", 2, 0),
                          ("read", None, 0), ("b", None, 5), ("read", None, 5)]
    starts = [s for _, s, _, _, _ in rec.spans]
    assert starts == sorted(starts)
    assert all(s <= e for _, s, e, _, _ in rec.spans)
    assert rec.start_ns <= starts[0] and rec.spans[-1][2] <= rec.stop_ns


def test_an_empty_recording_and_one_never_started():
    assert timing.stop_recording().spans == []
    rec = recorded(lambda: None)
    assert rec.spans == [] and rec.launches == dict.fromkeys(timing.LAUNCH_KEYS, 0)
    assert rec.start_ns <= rec.stop_ns
    with timing.span("after"):  # off again
        pass
    assert timing.stop_recording().spans == []


def test_stop_or_start_inside_a_span_raises():
    timing.start_recording()
    with timing.span("frame"):
        with pytest.raises(RuntimeError, match="inside a span"):
            timing.stop_recording()
        with pytest.raises(RuntimeError, match="inside a span"):
            timing.start_recording()
    assert shape(timing.stop_recording()) == [("frame", None, 0)]


def test_spans_lie_on_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    timing.start_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with timing.span("inner"):
                torch.ones(64).sum()
    rec = timing.stop_recording()
    (_, s, e, _, _), = rec.spans
    event = next(ev for ev in prof.profiler.kineto_results.events() if ev.name() == "outer")
    assert event.start_ns() <= s <= e <= event.end_ns()


@pytest.mark.parametrize("key", timing.LAUNCH_KEYS)
def test_launch_counters_are_the_wrappers_counts(monkeypatch, key):
    """Each key reads its wrapper's own ``launches`` (K3's replay, not its
    fused launches), which its module names when it is imported."""
    kernel = {"k1": tk, "k3.replay": nk}[key].CUDA_KERNEL

    def launched(n):
        if key == "k1":
            kernel.launches += n
        else:
            kernel.launches["replay"] += n
            kernel.launches["fused"] += 5

    monkeypatch.setattr(kernel, "launches", 7 if key == "k1" else {"fused": 7, "replay": 7})
    t0 = timing.launch_clock()
    timing.add_launch_ns(key, t0)  # not recording: nothing added
    timing.start_recording()
    t0 = timing.launch_clock()
    time.sleep(0.001)
    launched(2)
    timing.add_launch_ns(key, t0)
    rec = timing.stop_recording()
    assert t0 > 0
    assert rec.launches == {**dict.fromkeys(timing.LAUNCH_KEYS, 0), key: 2}
    assert rec.launch_ns[key] >= 1_000_000
    assert all(rec.launch_ns[k] == 0 for k in timing.LAUNCH_KEYS if k != key)


# -- the entry points ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt"))
    train.save_checkpoint(path, init_model(torch.Generator().manual_seed(0), widths=(8, 16)))
    return path


@pytest.mark.parametrize("denoising", [True, False])
def test_frame_spans(ckpt, denoising):
    cfg = RenderConfig(width=16, height=16, spp=2, backend="cuda")
    stepper = FrameStepper(cornell_box(), Camera.create(), cfg, denoising=denoising,
                           checkpoint=ckpt, progressive=True, device="cpu")
    stepper.step()
    rec = recorded(lambda: (stepper.move("left"), stepper.step(), stepper.step()))
    leaves = ["frame.render"] + (["frame.denoise"] if denoising else []) + ["frame.display"]
    one = [("frame", None, 0)] + [(n, 0, 0) for n in leaves]
    k = len(one)
    assert shape(rec) == one + [(n, None if p is None else k, k) for n, p, _ in one]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_inverse_step_spans(backend):
    cfg = RenderConfig(width=8, height=8, spp=1, max_bounces=2, backend=backend)
    state, step_fn, _ = inverse.make_inverse_step(cornell_box(), Camera.create(), cfg,
                                                  torch.zeros(8, 8, 3), device="cpu")
    state, _ = step_fn(state)

    def run():
        nonlocal state
        for _ in range(2):
            state, _ = step_fn(state)

    rec = recorded(run)
    assert shape(rec) == [("inverse.step", None, 0), ("inverse.grads", 0, 0),
                          ("inverse.adam", 0, 0), ("inverse.step", None, 3),
                          ("inverse.grads", 3, 3), ("inverse.adam", 3, 3)]


def test_train_spans():
    rng = np.random.default_rng(0)
    x = rng.random((6, 16, 16, 14), dtype=np.float32)
    y = rng.random((6, 16, 16, 3), dtype=np.float32)
    state = train.create_state(init_model(torch.Generator().manual_seed(0), (8, 16)), "cpu")
    train.loop_epoch(state, x, y, np.arange(3), 3)
    rec = recorded(lambda: train.loop_epoch(state, x, y, np.arange(6), 3))
    step = ["train.step", "train.upload", "train.forward", "train.backward", "train.sgd"]
    one = [(n, None if n == "train.step" else 0, 0) for n in step] + [("train.loss_read", None, 0)]
    assert shape(rec) == one + [(n, None if p is None else 6, 6) for n, p, _ in one]
    step_fn = recorded(lambda: train.train_step(state, torch.from_numpy(x[:3]),
                                                torch.from_numpy(y[:3])))
    assert shape(step_fn) == one[:-1]
