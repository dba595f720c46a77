"""Offline prediction post-processing (the port's copy of
``xview2_tpu/utils/post_process.py``): eval dumps -> prediction PNGs.

* pairs the sorted ``probs/*localization*`` and ``probs/*damage*`` dumps,
* damage labels: argmax + 1 of a 4-channel (softmax) dump, else the dump as
  it is (the CORAL and MSE heads dump labels),
* building mask ``loc > 0.3 OR (loc > 0.1 AND damage > 1)``, which gates the
  damage labels,
* ``--components``: each connected building takes its majority label
  (``scipy.ndimage.label``; one count over all components at once),
* ``--dilate``: a square maximum filter of ``--dilation_rate`` on both maps,
* writes ``{dump name}_prediction.png`` into ``RESULTS/predictions``, which
  is emptied first (stale predictions of a larger run would pair up in the
  scorer's sorted glob).

The pairs run on a thread pool (the JAX module uses joblib, which the
port does not need).

``python -m xview2_tpu_torch.utils.post_process --results RESULTS
[--components] [--dilate] [--dilation_rate 3]``
"""

from __future__ import annotations

import os
import shutil
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np
from PIL import Image
from scipy import ndimage

LOC_THRESH_HIGH = 0.3
LOC_THRESH_LOW = 0.1


def _majority_per_component(labels: np.ndarray) -> np.ndarray:
    """Each connected component of ``labels > 0`` takes its most frequent
    label, the smallest on a tie: the JAX module's loop over components
    (``np.unique`` then ``argmax``) as one count over (component, label)."""
    comp, n = ndimage.label(labels > 0)
    if n == 0:
        return labels
    inside = comp > 0
    vals, idx = np.unique(labels[inside], return_inverse=True)
    counts = np.bincount(comp[inside].astype(np.int64) * len(vals) + idx,
                         minlength=(n + 1) * len(vals)).reshape(n + 1, len(vals))
    out = labels.copy()
    out[inside] = vals[np.argmax(counts, axis=1)][comp[inside]]
    return out


def process_pair(loc_path: str, dmg_path: str, out_dir: str, *,
                 components: bool = False, dilate: bool = False,
                 dilation_rate: int = 3) -> None:
    loc = np.load(loc_path)
    dmg = np.load(dmg_path)
    dmg_labels = np.argmax(dmg, axis=0) + 1 if dmg.ndim == 3 and dmg.shape[0] == 4 else dmg

    building = np.zeros(loc.shape, np.float64)
    building[(loc > LOC_THRESH_HIGH) | ((loc > LOC_THRESH_LOW) & (dmg_labels > 1))] = 1
    dmg_labels = dmg_labels * building

    if components:
        dmg_labels = _majority_per_component(dmg_labels)
    if dilate:
        building = ndimage.maximum_filter(building, size=dilation_rate)
        dmg_labels = ndimage.maximum_filter(dmg_labels, size=dilation_rate)

    for arr, src in ((building, loc_path), (dmg_labels, dmg_path)):
        name = os.path.basename(src).replace(".npy", "_prediction.png")
        Image.fromarray(arr.astype(np.uint8)).save(os.path.join(out_dir, name))


def post_process_dir(results: str, *, components: bool = False, dilate: bool = False,
                     dilation_rate: int = 3, workers: int = 0) -> str:
    """Post-process every dump pair under ``results/probs``; returns the
    predictions directory.  ``workers``: threads (0: one per CPU)."""
    out_dir = os.path.join(results, "predictions")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    loc_paths = sorted(glob(os.path.join(results, "probs", "*localization*")))
    dmg_paths = sorted(glob(os.path.join(results, "probs", "*damage*")))
    with ThreadPoolExecutor(workers or os.cpu_count()) as pool:
        list(pool.map(lambda pair: process_pair(*pair, out_dir, components=components,
                                                dilate=dilate, dilation_rate=dilation_rate),
                      zip(loc_paths, dmg_paths)))
    return out_dir


def main(argv=None) -> int:
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter)
    arg = parser.add_argument
    arg("--results", type=str, default="/results", help="Results root directory")
    arg("--components", action="store_true",
        help="Enable connected component analysis for post disaster")
    arg("--dilate", action="store_true", help="Dilate pre and post images")
    arg("--dilation_rate", type=int, default=3, help="Dilation rate")
    args = parser.parse_args(argv)
    post_process_dir(args.results, components=args.components, dilate=args.dilate,
                     dilation_rate=args.dilation_rate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
