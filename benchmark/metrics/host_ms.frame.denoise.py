"""The host's ms a frame in the span ``frame.denoise``: the frame's
denoising in ``FrameStepper.step``: the channels packed, the CNN's eager
launches and the fade."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "frame.denoise")
