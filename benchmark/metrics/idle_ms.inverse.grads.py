"""The device's idle ms a step inside the span ``inverse.grads``, the
gradients: what the host around K1 and K3 leaves the card waiting."""

from benchmark.spans import idle_ms


def read(trace, work):
    return idle_ms(trace, work, "inverse.grads")
