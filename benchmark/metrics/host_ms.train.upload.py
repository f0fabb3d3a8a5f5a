"""The host's ms a step in the span ``train.upload``: the training step's
upload (``train_step``: the batch and target moved to the card from
pageable memory, which blocks the host)."""

from benchmark.spans import span_ms


def read(trace, work):
    return span_ms(trace, work, "train.upload")
