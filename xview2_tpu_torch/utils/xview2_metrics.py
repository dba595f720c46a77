"""The official xView2 scorer (the port's copy of
``xview2_tpu/utils/xview2_metrics.py``): prediction PNGs -> score JSON.

* strict input validation: 1024x1024 uint8 PNGs with values in {0..4},
* per image, TP/FN/FP of localization (class 1 of the binarized maps) and
  of damage classes 1..4, scored only where the TARGET damage map has
  buildings, the damage prediction gated by the PREDICTED localization,
* the damage F1 is the harmonic mean of the four, each term guarded by
  1e-6; the score is ``0.3 * localization F1 + 0.7 * damage F1``,
* the JSON keys of the reference.

Images are scored on a thread pool.

``python -m xview2_tpu_torch.utils.xview2_metrics PRED_DIR TARG_DIR OUT_JSON``
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image


def load_and_validate(path: Path) -> np.ndarray:
    assert path.is_file(), f"file '{path}' does not exist or is not a file"
    img = np.array(Image.open(path))
    assert img.dtype == np.uint8, f"{path.name} is of wrong format {img.dtype} - should be np.uint8"
    assert set(np.unique(img)) <= {0, 1, 2, 3, 4}, \
        f"values must ints 0-4, found {np.unique(img)}, path: {path}"
    assert img.shape == (1024, 1024), f"{path} must be a 1024x1024 image"
    return img


def tp_fn_fp(pred: np.ndarray, targ: np.ndarray, c: int) -> List[int]:
    tp = int(np.logical_and(pred == c, targ == c).sum())
    fn = int(np.logical_and(pred != c, targ == c).sum())
    fp = int(np.logical_and(pred == c, targ != c).sum())
    return [tp, fn, fp]


def image_rows(paths: Tuple[str, str, str, str]) -> Tuple[List[int], List[int]]:
    """(localization row, damage row) of one image quadruple (loc pred,
    damage pred, loc target, damage target)."""
    lp, dp, lt, dt = (load_and_validate(Path(p)) for p in paths)
    lp_b = (lp > 0).astype(lp.dtype)
    lt_b = (lt > 0).astype(lt.dtype)
    sel = (dt > 0)
    dp = dp * lp_b
    lrow = tp_fn_fp(lp_b, lt_b, 1)
    drow: List[int] = []
    for c in range(1, 5):
        drow += tp_fn_fp(dp[sel], dt[sel], c)
    return lrow, drow


def f1_from_counts(tp: int, fp: int, fn: int) -> float:
    if tp == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    if precision == 0 or recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def harmonic_mean(xs) -> float:
    return len(xs) / sum((x + 1e-6) ** -1 for x in xs)


def discover_pairs(pred_dir: str, targ_dir: str) -> List[Tuple[str, str, str, str]]:
    """One quadruple per ``*_localization_*_target.png`` in ``targ_dir``."""
    pred_dir_p, targ_dir_p = Path(pred_dir), Path(targ_dir)
    assert pred_dir_p.is_dir(), f"Could not find prediction directory: '{pred_dir}'"
    assert targ_dir_p.is_dir(), f"Could not find target directory: '{targ_dir}'"
    quads = []
    for path in sorted(targ_dir_p.glob("*.png")):
        test_hold, loc_dmg, img_id, target = path.name.rstrip(".png").split("_")
        assert loc_dmg in ("localization", "damage"), \
            f"target filenames must have 'localization' or 'damage' in filename, got {path}"
        assert target == "target", f"{target} should equal 'target' when getting path handlers"
        if loc_dmg != "localization":
            continue
        quads.append((
            str(pred_dir_p / f"{test_hold}_localization_{img_id}_prediction.png"),
            str(pred_dir_p / f"{test_hold}_damage_{img_id}_prediction.png"),
            str(targ_dir_p / f"{test_hold}_localization_{img_id}_target.png"),
            str(targ_dir_p / f"{test_hold}_damage_{img_id}_target.png"),
        ))
    return quads


def compute_score(pred_dir: str, targ_dir: str, out_fp: str, *,
                  workers: int = 0) -> Dict[str, float]:
    """Score the predictions, write the JSON to ``out_fp`` and return it.
    ``workers``: threads (0: one per CPU)."""
    quads = discover_pairs(pred_dir, targ_dir)
    with ThreadPoolExecutor(workers or os.cpu_count()) as pool:
        rows = list(pool.map(image_rows, quads))

    lsum = np.array([lrow for lrow, _ in rows]).sum(axis=0) if rows else np.zeros(3, int)
    loc_f1 = f1_from_counts(lsum[0], lsum[2], lsum[1])
    dsum = np.array([drow for _, drow in rows]).sum(axis=0) if rows else np.zeros(12, int)
    dmg_f1s = [f1_from_counts(dsum[3 * i], dsum[3 * i + 2], dsum[3 * i + 1]) for i in range(4)]
    dmg_f1 = harmonic_mean(dmg_f1s)

    d = {
        "score": 0.3 * loc_f1 + 0.7 * dmg_f1,
        "damage_f1": dmg_f1,
        "localization_f1": loc_f1,
        "damage_f1_no_damage": dmg_f1s[0],
        "damage_f1_minor_damage": dmg_f1s[1],
        "damage_f1_major_damage": dmg_f1s[2],
        "damage_f1_destroyed": dmg_f1s[3],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_fp)), exist_ok=True)
    with open(out_fp, "w") as f:
        json.dump(d, f)
    print(f"Wrote metrics to {out_fp}")
    return d


def main(argv=None) -> int:
    parser = ArgumentParser(description="xView2 metric scorer")
    parser.add_argument("pred_dir")
    parser.add_argument("targ_dir")
    parser.add_argument("out_fp")
    args = parser.parse_args(argv)
    compute_score(args.pred_dir, args.targ_dir, args.out_fp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
