"""Device milliseconds a train step spends in its backward (span
``train.backward``: autograd through the model, K4/K5, the gradients'
average over the ranks; model layer), idle inside included."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "train", "train.backward", "device")
