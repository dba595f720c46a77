"""The port's kernels K1-K6 in a train call (kernels layer): the least time
of their launches in the traced slice, from the cell's shapes, over their
device time, in %."""

from xv2bench.readers import kernel_roofline


def read(r):
    return kernel_roofline(r, "train")
