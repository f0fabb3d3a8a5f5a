"""The program's spans and launch counters (``utils/timing.py``).

- With no recording, ``span`` hands back one shared object that reads no
  clock, allocates nothing and never calls ``torch.profiler``'s
  ``record_function``.
- A recording gives each span its parent and the unit (the root span) it
  belongs to, in the order the spans started; a ``tail`` span belongs to the
  root closed before it.
- The spans lie on the clock of the profiler's host events: a span inside a
  ``record_function`` lies inside that event.
- The launch counts of a recording (K1, K3's replay, K4's replay and their
  taped replays, K2's dump mode) are the one table's counts since the
  recording started, with the host ns added only while recording; the
  table has a key for every mode each wrapper launches, one reset and one
  reader.
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
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
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

def test_span_off_is_one_shared_object_that_reads_no_clock(monkeypatch, counts):
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
    timing.count_launch("k1", 0)
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


# every kernel and mode a wrapper launches, by the key it counts as
TABLE = ("k1", "k2.fused", "k2.dump", "k2.replay", "k3.fused", "k3.replay", "k3.replay_taped",
         "k4.replay", "k4.replay_taped")


@pytest.fixture
def counts(monkeypatch):
    """The table of launch counts, every count at 7, restored after the test."""
    monkeypatch.setattr(timing, "_LAUNCHES", dict.fromkeys(timing._LAUNCHES, 7))


def test_every_launch_key_is_registered_by_its_wrapper(counts):
    """The table has a key for each mode of each wrapper's ``MODES`` (the
    modes outside ``LAUNCH_KEYS`` among them) and for the taped replays of K3
    and K4, and holds every key of ``LAUNCH_KEYS``; the one reset sets every
    count of the table to 0; a key outside the table cannot be counted."""
    modes = {"k1"} | {f"k2.{m}" for m in gk.MODES} | {f"k3.{m}" for m in nk.MODES}
    assert set(timing.launch_counts()) == set(TABLE)
    assert modes | {"k3.replay_taped", "k4.replay", "k4.replay_taped"} == set(TABLE)
    assert set(timing.LAUNCH_KEYS) <= set(TABLE)
    timing.reset_launch_counts()
    assert timing.launch_counts() == dict.fromkeys(TABLE, 0)
    for key in ("k3.dump", "k4.fused", "k2.replay_tape"):
        with pytest.raises(KeyError):
            timing.count_launch(key)
    with pytest.raises(KeyError):
        timing.count_launch("k2.dump", taped=True)
    assert timing.launch_counts() == dict.fromkeys(TABLE, 0)


def test_taped_replays_of_k3_and_k4_have_launch_keys(counts):
    """Each taped replay kernel has its engagement count beside its replay's:
    a taped replay counts as a replay and as a taped one."""
    keys = timing.LAUNCH_KEYS
    assert keys.index("k3.replay_taped") == keys.index("k3.replay") + 1
    assert keys.index("k4.replay_taped") == keys.index("k4.replay") + 1
    timing.count_launch("k4.replay", taped=True)
    timing.count_launch("k4.replay")
    assert timing.launch_counts() == {**dict.fromkeys(TABLE, 7), "k4.replay": 9,
                                      "k4.replay_taped": 8}


@pytest.mark.parametrize("key", timing.LAUNCH_KEYS)
def test_launch_counters_are_the_wrappers_counts(counts, key):
    """A recording reports each key's own count in the table since it
    started: not the other modes of the same kernel (K3's and K2's fused
    launches, K2's replays); a taped replay counts under its replay's key
    and its own, and its host time goes to its replay's key; host time is
    added only while recording."""
    base = key.removesuffix("_taped")
    taped = base != key
    kernel = key.split(".")[0]
    others = [k for k in TABLE if k.startswith(kernel + ".") and k not in (key, base)
              and not k.endswith("_taped")]
    timing.count_launch(base, timing.launch_clock(), taped=taped)  # not recording: no time
    timing.start_recording()
    t0 = timing.launch_clock()
    time.sleep(0.001)
    timing.count_launch(base, t0, taped=taped)
    timing.count_launch(base, timing.launch_clock(), taped=taped)
    for other in others:
        timing.count_launch(other)
    rec = timing.stop_recording()
    assert t0 > 0
    assert rec.launches == {**dict.fromkeys(timing.LAUNCH_KEYS, 0), base: 2, key: 2}
    assert rec.launch_ns[base] >= 1_000_000
    assert all(rec.launch_ns[k] == 0 for k in timing.LAUNCH_KEYS if k != base)
    assert all(timing.launch_counts()[k] == 8 for k in others)


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
