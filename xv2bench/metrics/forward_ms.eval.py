"""Device milliseconds an eval step spends in normalize, the 4-flip TTA
forward and the cast to float32 (span ``eval.forward``; model layer), idle
inside included."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "eval", "eval.forward", "device")
