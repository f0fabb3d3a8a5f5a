"""The device's idle ms a frame inside the span ``frame.denoise``, the
denoising's eager launches: what the host's dispatch of the CNN leaves
the card waiting."""

from benchmark.spans import idle_ms


def read(trace, work):
    return idle_ms(trace, work, "frame.denoise")
