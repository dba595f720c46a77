"""Device milliseconds a train call in elementwise, reduction and copy
kernels (model layer), from the traced slice."""

from xv2bench.readers import device_ms


def read(r):
    return device_ms(r, "train", ("elementwise", "cat/copy"))
