"""Device milliseconds a eval call in the libraries' convolutions and
matrix products (model layer), from the traced slice."""

from xv2bench.readers import device_ms


def read(r):
    return device_ms(r, "eval", ("library conv/GEMM",))
