"""Host milliseconds a train step waits in AutoAugment's read of its draws
to the host (span ``augment.sync`` in ``slot_plan``; augment layer)."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "train", "augment.sync", "host")
