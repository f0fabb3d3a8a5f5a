"""The host's ms a step in the span ``train.backward``: the training step's
backward (``train_step``: autograd through the CNN)."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "train.backward")
