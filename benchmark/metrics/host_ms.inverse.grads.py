"""The host's ms a step in the span ``inverse.grads``: the inverse step's
gradients (``step_fn``: ``cross_grads``, two K1 NEE colour launches and
two K3 replays, and the contraction)."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "inverse.grads")
