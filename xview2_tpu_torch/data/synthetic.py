"""Synthetic xBD-style dataset generator for tests and benchmarks.

Writes a miniature ``{root}/{split}/{images,targets}`` tree with the reference
naming scheme (``*_pre_disaster.png`` / ``*_post_disaster.png``) so the full
train/eval/post-process/score pipeline can run end-to-end without the real
22k-image xBD download.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image


def make_synthetic_split(root: str, split: str, n: int, *, size: int = 1024,
                         seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, split, "images")
    tgt_dir = os.path.join(root, split, "targets")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(tgt_dir, exist_ok=True)
    for i in range(n):
        img_pre = rng.integers(0, 256, (size, size, 3), np.uint8)
        img_post = np.clip(img_pre.astype(np.int16) + rng.integers(-20, 20), 0, 255).astype(np.uint8)
        # a few rectangular "buildings" with damage labels
        lbl_pre = np.zeros((size, size), np.uint8)
        lbl_post = np.zeros((size, size), np.uint8)
        for _ in range(rng.integers(2, 6)):
            h0 = int(rng.integers(0, size - 64))
            w0 = int(rng.integers(0, size - 64))
            hh = int(rng.integers(16, 64))
            ww = int(rng.integers(16, 64))
            dmg = int(rng.integers(1, 5))
            lbl_pre[h0:h0 + hh, w0:w0 + ww] = 1
            lbl_post[h0:h0 + hh, w0:w0 + ww] = dmg
        base = f"synth-{split}_{i:08d}"
        Image.fromarray(img_pre).save(os.path.join(img_dir, f"{base}_pre_disaster.png"))
        Image.fromarray(img_post).save(os.path.join(img_dir, f"{base}_post_disaster.png"))
        Image.fromarray(lbl_pre).save(os.path.join(tgt_dir, f"{base}_pre_disaster.png"))
        Image.fromarray(lbl_post).save(os.path.join(tgt_dir, f"{base}_post_disaster.png"))
    return os.path.join(root, split)


def make_synthetic_dataset(root: str, *, n_train: int = 4, n_val: int = 2,
                           n_test: int = 2, size: int = 1024, seed: int = 0) -> str:
    make_synthetic_split(root, "train", n_train, size=size, seed=seed)
    make_synthetic_split(root, "test", n_val, size=size, seed=seed + 1)
    make_synthetic_split(root, "holdout", n_test, size=size, seed=seed + 2)
    return root
