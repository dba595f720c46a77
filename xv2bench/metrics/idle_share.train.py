"""The share of a train call's wall time in which the device runs nothing,
in % (device layer): the traced slice's busy time a call over the untraced
window's wall time a call."""

from xv2bench.readers import idle_share


def read(r):
    return idle_share(r, "train")
