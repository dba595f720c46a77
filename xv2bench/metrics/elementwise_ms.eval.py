"""Device milliseconds a eval call in elementwise, reduction and copy
kernels (model layer), from the traced slice."""

from xv2bench.readers import device_ms


def read(r):
    return device_ms(r, "eval", ("elementwise", "cat/copy"))
