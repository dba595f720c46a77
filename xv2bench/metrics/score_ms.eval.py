"""Device milliseconds an eval step spends scoring its logits (span
``eval.score``: the relayout, the loss, the F1 counters; loss and F1 layer),
idle inside included."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "eval", "eval.score", "device")
