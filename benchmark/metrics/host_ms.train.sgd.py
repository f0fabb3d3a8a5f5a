"""The host's ms a step in the span ``train.sgd``: the training step's
update (``train_step``: the rate set, Nesterov SGD)."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "train.sgd")
