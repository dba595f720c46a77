"""The whole train step's model FLOPs a second over the bf16 dense peak of
one H100, in % (whole step)."""

from xv2bench.readers import mfu


def read(r):
    return mfu(r, "train")
