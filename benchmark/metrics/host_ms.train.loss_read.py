"""The host's ms a step in the span ``train.loss_read``: the read of the
step's loss (``loop_epoch``: ``float(loss)``, which waits for the step
on the card)."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "train.loss_read")
