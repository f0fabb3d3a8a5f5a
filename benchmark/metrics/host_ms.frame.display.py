"""The host's ms a frame in the span ``frame.display``: the frame's copy to
the display in ``FrameStepper.step``, which waits for the card."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "frame.display")
