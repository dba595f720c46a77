"""Host milliseconds an eval step spends copying its batch to the device
(span ``eval.h2d``; trainer layer)."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "eval", "eval.h2d", "host")
