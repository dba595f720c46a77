"""Device milliseconds a train step spends in its augmentation (span
``train.augment``: the crop, AutoAugment grouped by op, K6; augment layer),
from its start event to its end event on the device, idle inside included."""

from xv2bench.spans import span_ms


def read(r):
    return span_ms(r, "train", "train.augment", "device")
