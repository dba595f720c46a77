"""Train-index builder: ``index.csv`` generation (a copy of
``xview2_tpu/data/index.py`` on the standard library: ``csv`` and a thread
pool in place of pandas and joblib).

Equivalent of the reference's ``utils/generate_idx.py``: for every pre/post
image pair, drop excluded indices, drop tiles whose pre-AND-post foreground
bounding box is smaller than 512 px in either dimension, and record per-image
presence flags for damage classes 1-4.  The CSV drives train-set selection
(pre: all rows; post: rows with any damage flag).
"""

from __future__ import annotations

import csv
import glob
import json
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from xview2_tpu_torch.data.exclude_list import default_excluded

COLUMNS = ("idx", "1", "2", "3", "4")


def _foreground_box(img_pre: np.ndarray, img_post: np.ndarray):
    """Intersection bbox of the non-black regions of the pair."""
    h_pre, w_pre = np.where(img_pre.max(axis=-1) > 0)
    h_post, w_post = np.where(img_post.max(axis=-1) > 0)
    if h_pre.size == 0 or h_post.size == 0:
        return 0, 0, 0, 0
    return (max(h_pre.min(), h_post.min()), min(h_pre.max(), h_post.max()),
            max(w_pre.min(), w_post.min()), min(w_pre.max(), w_post.max()))


def build_row(idx: int, img_pre_path: str, img_post_path: str, lbl_post_path: str,
              excluded: set, min_size: Optional[int] = 512) -> Optional[Dict[str, int]]:
    """One index row; ``min_size=None`` scales the reference's 512-px
    foreground threshold (designed for 1024^2 tiles) to half the tile height."""
    if idx in excluded:
        return None
    img_pre = np.asarray(Image.open(img_pre_path).convert("RGB"))
    img_post = np.asarray(Image.open(img_post_path).convert("RGB"))
    if min_size is None:
        min_size = 512 * img_pre.shape[0] // 1024
    min_h, max_h, min_w, max_w = _foreground_box(img_pre, img_post)
    if (max_h - min_h) < min_size or (max_w - min_w) < min_size:
        return None
    present = set(np.unique(np.asarray(Image.open(lbl_post_path))).tolist())
    row = {"idx": idx}
    for c in (1, 2, 3, 4):
        row[str(c)] = 1 if c in present else 0
    return row


def generate_index(data_dir: str, out_csv: str, exclude_path: Optional[str] = None,
                   n_jobs: int = 8, min_size: Optional[int] = 512) -> List[Dict[str, int]]:
    imgs_pre = sorted(glob.glob(os.path.join(data_dir, "images", "*pre*")))
    imgs_post = sorted(glob.glob(os.path.join(data_dir, "images", "*post*")))
    lbls_post = sorted(glob.glob(os.path.join(data_dir, "targets", "*post*")))
    if not imgs_pre or not len(imgs_pre) == len(imgs_post) == len(lbls_post):
        raise FileNotFoundError(f"unpaired data under {data_dir}")
    if exclude_path and os.path.exists(exclude_path):
        with open(exclude_path) as f:
            excluded = set(json.load(f))
    else:
        # the bundled exclude indices apply only when the tree is xBD-shaped
        excluded = set(default_excluded(len(imgs_pre)))
    with ThreadPoolExecutor(max_workers=max(n_jobs, 1)) as pool:
        rows = list(pool.map(
            lambda i: build_row(i, imgs_pre[i], imgs_post[i], lbls_post[i], excluded, min_size),
            range(len(imgs_pre))))
    rows = [r for r in rows if r is not None]
    if not rows:
        # do NOT write an empty index: a later run would silently reuse it
        raise RuntimeError(f"train index is empty: every tile under {data_dir} was excluded "
                           "or failed the foreground-size filter")
    out_dir = os.path.dirname(os.path.abspath(out_csv))
    os.makedirs(out_dir, exist_ok=True)
    # atomic publish: readers never observe a partially written index
    fd, tmp = tempfile.mkstemp(prefix=".index.", suffix=".csv", dir=out_dir)
    try:
        with os.fdopen(fd, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=COLUMNS)
            writer.writeheader()
            writer.writerows(rows)
        os.replace(tmp, out_csv)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return rows


def read_index_csv(path: str, task_type: str) -> List[int]:
    """Train-index selection (reference pytorch_loader.py:64-65, 101-107):
    pre trains on all rows, post on the rows with any damage-class flag."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if task_type == "pre":
        return [int(r["idx"]) for r in rows]
    return sorted({int(r["idx"]) for r in rows
                   if any(int(float(r[c])) == 1 for c in ("1", "2", "3", "4"))})


def ensure_index(cfg) -> str:
    """Resolve the train index for a run, generating it when absent.

    The reference always restricts training through ``utils/index.csv``.  On
    first train with no ``--index_csv`` it is built once under ``--results``
    with the same foreground-bbox filter (threshold scaled to the tile size)
    and class-presence flags.  Exclusion precedence: an explicit
    ``--exclude`` JSON file, else ``{data}/train/exclude.txt`` when present,
    else the bundled reference list (applied only on xBD-shaped trees)."""
    if cfg.index_csv:
        if not os.path.exists(cfg.index_csv):
            raise FileNotFoundError(f"--index_csv {cfg.index_csv} does not exist")
        return cfg.index_csv
    out_csv = os.path.join(cfg.results, "index.csv")
    if not os.path.exists(out_csv):
        exclude = cfg.exclude
        if exclude and not os.path.exists(exclude):
            raise FileNotFoundError(f"--exclude {exclude} does not exist")
        train_dir = os.path.join(cfg.data, "train")
        if not exclude:
            tree_exclude = os.path.join(train_dir, "exclude.txt")
            exclude = tree_exclude if os.path.exists(tree_exclude) else None
        print(f"generating train index {out_csv} (no --index_csv given)", flush=True)
        generate_index(train_dir, out_csv, exclude_path=exclude, n_jobs=cfg.num_workers,
                       min_size=None)
    return out_csv
