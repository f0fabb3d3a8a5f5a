"""The host's ms a step in the span ``inverse.adam``: the inverse step's
Adam update (``step_fn``: the masked gradients, the rates' schedules,
``Adam.step``)."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "inverse.adam")
