"""Model FLOPs of a step, counted once by ``torch.utils.flop_counter`` on the
benchmark's plain reference at the cell's shapes on the meta device, so that
whatever implements the step is charged the same work.  Train counts the
forward and the backward of one step; eval the four flips' forwards.
Recomputation is not counted."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from xv2bench.reference.model import Precision


def per_tile(build, spec: dict, kind: str, batch: int, tile: int) -> float:
    """FLOPs a tile (a crop in training, a whole tile at eval) of the model
    ``build(spec, Precision)`` (the cell's reference)."""
    channels = 3 if spec["type"] == "pre" else 6
    with torch.device("meta"):
        model = build(spec, Precision(torch.bfloat16))
        counter = FlopCounterMode(display=False)
        if kind == "train":
            x = torch.empty((batch, channels, tile, tile))
            with counter:
                out = model(x, True)
                outs = out if isinstance(out, list) else [out]
                sum(o.float().sum() for o in outs).backward()
        else:
            x = torch.empty((4 * batch, channels, tile, tile))
            with torch.no_grad(), counter:
                model(x, False)
    return counter.get_total_flops() / batch
