"""The one traffic generator: a host pool of tiles and building masks drawn
from the seed by the parameters of a traffic file, batched as the port's
``Loader`` yields them (uint8 NHWC tiles, uint8 masks, float32 ``valid``).

A tile is a coarse grid of colours at its own brightness and contrast, with
pixel noise, or a pre/post pair of two such images for a damage model: no
layer's work depends on the pixel values, but the batch statistics do, and
tiles of one distribution would give the split attention's BatchNorm over
pooled values that barely differ between the samples of a batch.  Its mask holds a Poisson number of axis-aligned buildings with
the mean count of the xBD data set; a localization mask marks them 1, a
damage mask marks each with a class drawn from xBD's mix (1 no damage, 2
minor, 3 major, 4 destroyed, 255 unclassified).  Every number comes from the
traffic file, which names its source.

The pool is ``pool_batches`` whole batches of distinct tiles, assembled once
at set-up; the run then takes them in a seeded order, so that no batch is
copied together in the timed loop.  The same seed gives the same pool and
the same order.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

SEED_MIX = 0x7A11C  # keeps the traffic's stream apart from the weights'


@dataclasses.dataclass
class Pool:
    images: List[np.ndarray]   # per batch: uint8 (B, H, W, C)
    masks: List[np.ndarray]    # per batch: uint8 (B, H, W)
    valid: np.ndarray          # float32 (B,): every row is a tile
    order: np.ndarray          # int: the pool batch of each call, in order

    def batch(self, call: int):
        k = int(self.order[call % len(self.order)])
        return self.images[k], self.masks[k]


def _image(rng: np.random.Generator, px: dict, size: int, channels: int,
           bank: np.ndarray, out: np.ndarray) -> None:
    """A tile with scene-level variation, written into ``out`` (size, size,
    channels): a coarse grid of colours (one per ``block`` x ``block`` px
    square) at the tile's own brightness and contrast, plus pixel noise (a
    window of the pool's noise bank at a random offset), for each 3-channel
    image of the tile."""
    blk = px["block"]
    cells = size // blk
    for h in range(channels // 3):
        coarse = rng.normal(0.0, 1.0, size=(cells, cells, 3)) * rng.uniform(*px["contrast"])
        coarse += rng.uniform(*px["brightness"]) + rng.normal(0.0, px["tint"], size=3)
        coarse = np.clip(coarse, 0, 255).astype(np.int16)
        oy, ox = rng.integers(0, size, size=2)
        img = np.repeat(np.repeat(coarse, blk, axis=0), blk, axis=1)
        img += bank[oy:oy + size, ox:ox + size]
        np.clip(img, 0, 255, out=img)
        out[:, :, 3 * h:3 * h + 3] = img


def _mask(rng: np.random.Generator, spec: dict, size: int, task: str) -> np.ndarray:
    b = spec["buildings"]
    mask = np.zeros((size, size), np.uint8)
    n = rng.poisson(b["mean_per_tile"])
    sides = rng.integers(b["side_px"][0], b["side_px"][1] + 1, size=(n, 2))
    corners = rng.integers(0, size, size=(n, 2))
    if task == "post":
        mix = spec["damage_mix"]
        labels = rng.choice(np.array([int(k) for k in mix], np.uint8), size=n,
                            p=np.array(list(mix.values()), np.float64) / sum(mix.values()))
    else:
        labels = np.ones(n, np.uint8)
    for (h, w), (y, x), lab in zip(sides, corners, labels):
        mask[y:y + h, x:x + w] = lab
    return mask


def make_pool(spec: dict, seed: int, batch: int, channels: int, task: str,
              calls: int = 4096) -> Pool:
    """The pool of ``spec`` for ``seed``: ``spec["pool_batches"]`` batches of
    ``batch`` tiles of ``spec["tile"]``^2 and ``channels`` channels, and the
    seeded order of ``calls`` calls over them."""
    rng = np.random.Generator(np.random.PCG64([seed & (2 ** 64 - 1), SEED_MIX]))
    size, nb = spec["tile"], spec["pool_batches"]
    images, masks = [], []
    half = spec["pixels"]["noise"]
    bank = rng.integers(-half, half + 1, size=(2 * size, 2 * size, 3), dtype=np.int16)
    for _ in range(nb):
        tiles = np.empty((batch, size, size, channels), np.uint8)
        for tile in tiles:
            _image(rng, spec["pixels"], size, channels, bank, tile)
        images.append(tiles)
        masks.append(np.stack([_mask(rng, spec, size, task) for _ in range(batch)]))
    # the first pool batches in their own order (the checked calls see
    # distinct tiles), then a seeded walk over the pool
    order = np.concatenate([np.arange(nb), rng.integers(0, nb, size=max(calls - nb, 0))])
    return Pool(images, masks, np.ones((batch,), np.float32), order)
