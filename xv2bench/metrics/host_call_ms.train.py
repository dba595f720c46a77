"""Median host wall time of one ``Runner.train_step`` call in the untraced window
(trainer layer), any synchronisation the call makes included."""

from xv2bench.readers import host_call_ms


def read(r):
    return host_call_ms(r, "train")
