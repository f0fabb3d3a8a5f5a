"""The device's idle ms a step inside the span ``train.backward``, the
backward: what autograd's host work leaves the card waiting."""

from benchmark.spans import idle_ms


def read(trace, work):
    return idle_ms(trace, work, "train.backward")
