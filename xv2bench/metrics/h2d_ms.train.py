"""Host milliseconds a train step spends copying its batch to the device
(span ``train.h2d``; the pageable copy blocks the host; trainer layer)."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "train", "train.h2d", "host")
