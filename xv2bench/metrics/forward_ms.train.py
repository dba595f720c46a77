"""Device milliseconds a train step spends in its forward and loss (span
``train.forward``: the labels' loss views, the model in train mode, the
losses; model layer), idle inside included."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "train", "train.forward", "device")
