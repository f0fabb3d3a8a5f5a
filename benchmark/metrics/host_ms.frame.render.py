"""The host's ms a frame in the span ``frame.render``: the frame's render
in ``FrameStepper.step``: the progressive bookkeeping, the blocks, K1's
partials launch and the AOVs."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "frame.render")
