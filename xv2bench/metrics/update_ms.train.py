"""Device milliseconds a train step spends in its update (span
``train.update``: the learning rate, AdamW's step, zeroing the gradients;
optimizer layer), idle inside included."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "train", "train.update", "device")
