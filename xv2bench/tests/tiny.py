"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for the
harness's tests: 128^2 tiles and 64^2 crops to train, 64^2 tiles to
evaluate (the first call checked), batches of 2 or 4, float64 (so
that a sound run reads far inside every limit and a fault far outside)."""

import copy

from xv2bench import cells

SIZES = {"train": dict(batch_size=4, train_crop=64), "eval": dict(val_batch_size=2)}


def cell(workload: str, **program):
    c = cells.load(workload)
    c.config = copy.deepcopy(c.config)
    c.traffic = dict(c.traffic, tile=128 if c.kind == "train" else 64, pool_batches=4,
                     sample_among=1, check_batches=1)
    c.config["program"].update(SIZES[c.kind], **dict(dict(precision=64), **program))
    return c
