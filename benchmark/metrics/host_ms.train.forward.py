"""The host's ms a step in the span ``train.forward``: the training step's
forward (``train_step``: the gradients cleared, the CNN in training
mode, the L1 loss)."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "train.forward")
