"""The port's offline tools against the JAX package's: ``post_process``
(dumps -> prediction PNGs), the xView2 scorer (PNGs -> score JSON) and
``convert2png`` (label JSONs -> target PNGs).  The PNG pixels and the score
JSON must be EQUAL: on ``tests/test_scorer.py``'s cases and on seeded random
dumps (softmax, CORAL and MSE damage dumps), plain and with ``--components
--dilate``; the masks on ``tests/test_offline_tools.py``'s polygons and on
seeded random simple polygons, concave ones included, against the JAX
module's ``cv2.fillPoly``.  Polygons that cross the image's right or bottom
border, or cross themselves, are counted, not held equal (ROADMAP Queue 3)."""

import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from xview2_tpu.data import convert2png as jax_c2p
from xview2_tpu.utils import post_process as jax_pp
from xview2_tpu.utils import xview2_metrics as jax_metrics
from xview2_tpu_torch.data import convert2png as c2p
from xview2_tpu_torch.utils import post_process as pp
from xview2_tpu_torch.utils import xview2_metrics as metrics

N = 1024


def _png(arr, path):
    Image.fromarray(np.asarray(arr).astype(np.uint8)).save(path)


def _read(path):
    return np.array(Image.open(path))


def _dumps_thresholds(rng):
    loc = np.zeros((N, N), np.float32)
    loc[0:100, 0:100] = 0.5
    loc[200:300, 0:100] = 0.2
    loc[400:500, 0:100] = 0.2
    dmg = np.zeros((4, N, N), np.float32)
    dmg[0] += 1.0
    dmg[2, 200:300, 0:100] = 9.0
    return [(loc, dmg)]


def _dumps_vote(rng):
    loc = np.zeros((N, N), np.float32)
    loc[0:10, 0:10] = 0.9
    dmg = np.zeros((4, N, N), np.float32)
    dmg[0] += 1.0
    dmg[:, 0:10, 0:10] = 0.0
    dmg[1, 0:6, 0:10] = 9.0
    dmg[3, 6:10, 0:10] = 9.0
    return [(loc, dmg)]


def _blobs(rng, n=40):
    """Random rectangles of buildings (0/1) and their damage classes 1..4."""
    loc = np.zeros((N, N), np.uint8)
    cls = np.zeros((N, N), np.uint8)
    for _ in range(n):
        y, x = rng.integers(0, N - 40, 2)
        h, w = rng.integers(3, 40, 2)
        loc[y:y + h, x:x + w] = 1
        cls[y:y + h, x:x + w] = rng.integers(1, 5)
    return loc, cls


def _loc_probs(rng, loc):
    """Sigmoid-like probabilities around the buildings: ~0.6 on them, ~0.02
    off them, so both thresholds (0.3, 0.1) cut through the noise at a few
    pixels only (each isolated pixel is a component of its own)."""
    return np.clip(loc * 0.6 + rng.normal(0.02, 0.025, (N, N)), 0, 1).astype(np.float32)


def _dumps_softmax(rng):
    out = []
    for _ in range(3):
        loc, cls = _blobs(rng)
        p = _loc_probs(rng, loc)
        logits = rng.normal(0, 1, (4, N, N)) + 3.0 * np.eye(4)[np.maximum(cls, 1) - 1].transpose(
            2, 0, 1)
        e = np.exp(logits - logits.max(0))
        out.append((p, (e / e.sum(0)).astype(np.float32)))
    return out


def _dumps_labels(rng):
    """CORAL and MSE heads dump the class, (H, W) float32 in 1..4."""
    out = []
    for _ in range(2):
        loc, cls = _blobs(rng)
        p = _loc_probs(rng, loc)
        lab = np.where(rng.random((N, N)) < 0.8, np.maximum(cls, 1),
                       rng.integers(1, 5, (N, N))).astype(np.float32)
        out.append((p, lab))
    return out


DUMPS = {"thresholds": _dumps_thresholds, "vote": _dumps_vote, "softmax": _dumps_softmax,
         "labels": _dumps_labels}


def _write_dumps(root, pairs, stale=True):
    os.makedirs(os.path.join(root, "probs"))
    for i, (loc, dmg) in enumerate(pairs):
        np.save(os.path.join(root, "probs", f"test_localization_{i:05d}.npy"), loc)
        np.save(os.path.join(root, "probs", f"test_damage_{i:05d}.npy"), dmg)
    if stale:  # a larger earlier run's prediction, which the wipe removes
        os.makedirs(os.path.join(root, "predictions"))
        _png(np.ones((N, N)), os.path.join(root, "predictions",
                                             "test_localization_00009_prediction.png"))


@pytest.mark.parametrize("flags", [[], ["--components", "--dilate"]], ids=["plain", "cc-dilate"])
@pytest.mark.parametrize("case", list(DUMPS))
def test_post_process_and_score_equal_jax(case, flags, tmp_path):
    pairs = DUMPS[case](np.random.default_rng(len(case)))
    roots = {}
    for who in ("jax", "port"):
        roots[who] = str(tmp_path / who)
        _write_dumps(roots[who], pairs)
    jax_pp.post_process_dir(roots["jax"], components=bool(flags), dilate=bool(flags), n_jobs=1)
    assert pp.main(["--results", roots["port"]] + flags) == 0
    names = sorted(os.listdir(os.path.join(roots["jax"], "predictions")))
    assert names == sorted(os.listdir(os.path.join(roots["port"], "predictions")))
    assert len(names) == 2 * len(pairs)
    for name in names:
        want = _read(os.path.join(roots["jax"], "predictions", name))
        got = _read(os.path.join(roots["port"], "predictions", name))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)

    # the targets: the dumps' own ground truth, and the score of each side
    targ = tmp_path / "targets"
    targ.mkdir()
    rng = np.random.default_rng(7)
    for i in range(len(pairs)):
        loc, cls = _blobs(rng)
        _png(loc, targ / f"test_localization_{i:05d}_target.png")
        _png(cls, targ / f"test_damage_{i:05d}_target.png")
    want = jax_metrics.compute_score(os.path.join(roots["jax"], "predictions"), str(targ),
                                     str(tmp_path / "jax.json"), processes=1)
    out = str(tmp_path / "port.json")
    assert metrics.main([os.path.join(roots["port"], "predictions"), str(targ), out]) == 0
    with open(out) as f:
        got = json.load(f)
    with open(tmp_path / "jax.json") as f:
        assert got == json.load(f) == want
    assert 0.0 <= got["score"] <= 1.0


@pytest.mark.parametrize("labels", ["softmax", "classes"])
def test_component_vote_equals_jax_on_many_components(labels, tmp_path):
    """Thousands of speckled components (the port counts them all at once,
    the JAX module loops over them), on 256^2 maps: ``process_pair`` takes
    any size."""
    rng = np.random.default_rng(9)
    loc = (rng.random((256, 256)) * 0.43).astype(np.float32)  # 30% above 0.3: speckle
    dmg = (rng.random((4, 256, 256)) if labels == "softmax"
           else rng.integers(1, 7, (256, 256))).astype(np.float32)
    np.save(tmp_path / "x_localization.npy", loc)
    np.save(tmp_path / "x_damage.npy", dmg)
    for who, process in (("jax", jax_pp.process_pair), ("port", pp.process_pair)):
        (tmp_path / who).mkdir()
        process(str(tmp_path / "x_localization.npy"), str(tmp_path / "x_damage.npy"),
                str(tmp_path / who), components=True)
    for name in ("x_localization_prediction.png", "x_damage_prediction.png"):
        np.testing.assert_array_equal(_read(tmp_path / "port" / name),
                                      _read(tmp_path / "jax" / name), err_msg=name)


def _scorer_tree(tmp_path, pred, targ):
    preds, targs = tmp_path / "predictions", tmp_path / "targets"
    preds.mkdir()
    targs.mkdir()
    for d, (loc, dmg), suffix in ((preds, pred, "prediction"), (targs, targ, "target")):
        _png(loc, d / f"test_localization_00000_{suffix}.png")
        _png(dmg, d / f"test_damage_00000_{suffix}.png")
    return str(preds), str(targs)


def _perfect():
    loc = np.zeros((N, N), np.uint8)
    loc[10:200, 10:200] = 1
    dmg = np.zeros((N, N), np.uint8)
    dmg[10:200, 10:100] = 2
    dmg[10:200, 100:200] = 4
    return (loc, dmg), (loc, dmg)


def _gated():
    lt = np.zeros((N, N), np.uint8)
    lt[0:10, 0:10] = 1
    return (np.zeros((N, N), np.uint8), lt.copy()), (lt, lt.copy())


@pytest.mark.parametrize("case", ["perfect", "gated"])
def test_scorer_cases_equal_jax(case, tmp_path):
    pred, targ = {"perfect": _perfect, "gated": _gated}[case]()
    preds, targs = _scorer_tree(tmp_path, pred, targ)
    want = jax_metrics.compute_score(preds, targs, str(tmp_path / "j.json"), processes=1)
    got = metrics.compute_score(preds, targs, str(tmp_path / "p.json"), workers=1)
    assert got == want
    if case == "perfect":
        assert got["localization_f1"] == 1.0
        assert got["damage_f1"] == metrics.harmonic_mean([0.0, 1.0, 0.0, 1.0])
    else:
        assert got["damage_f1_no_damage"] == 0.0


@pytest.mark.parametrize("bad", ["size", "values", "dtype"])
def test_scorer_validates_like_jax(bad, tmp_path):
    img = {"size": np.ones((512, 512)), "values": np.full((N, N), 7),
           "dtype": np.ones((N, N))}[bad]
    preds, targs = _scorer_tree(tmp_path, (img, img), (img, img))
    if bad == "dtype":
        Image.fromarray(np.ones((N, N), np.uint16)).save(
            os.path.join(preds, "test_damage_00000_prediction.png"))
    for compute in (lambda: jax_metrics.compute_score(preds, targs, str(tmp_path / "j"),
                                                      processes=1),
                    lambda: metrics.compute_score(preds, targs, str(tmp_path / "p"))):
        with pytest.raises(AssertionError):
            compute()


def test_f1_and_harmonic_mean_equal_jax():
    for counts in ((0, 0, 0), (10, 0, 0), (5, 5, 5), (3, 0, 9), (7, 2, 0)):
        assert metrics.f1_from_counts(*counts) == jax_metrics.f1_from_counts(*counts)
    for xs in ([0.0, 1.0, 0.0, 1.0], [0.3, 0.5, 0.7, 0.9], [1.0] * 4):
        assert metrics.harmonic_mean(xs) == jax_metrics.harmonic_mean(xs)


# ---------------------------------------------------------------- convert2png

def _label(path, polys, subtypes=None):
    feats = [{"wkt": "POLYGON ((" + ", ".join(f"{x} {y}" for x, y in list(p) + [p[0]]) + "))",
              "properties": {"subtype": (subtypes or ["no-damage"] * len(polys))[i]}}
             for i, p in enumerate(polys)]
    with open(path, "w") as f:
        json.dump({"features": {"xy": feats}}, f)


def _star(rng, lo=0, hi=N - 1, clip=(0, N - 1)):
    """A simple polygon (star-shaped around a random centre in [lo, hi],
    concave for most draws), its vertices rounded and clipped to ``clip``."""
    n = int(rng.integers(3, 16))
    cx, cy = rng.uniform(lo, hi, 2)
    r = rng.uniform(1, 200)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * rng.uniform(0.2, 1.0, n)
    pts = np.round(np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1))
    return (pts if clip is None else np.clip(pts, *clip)).astype(np.int32)


def test_convert_label_equals_jax_on_the_offline_tool_polygons(tmp_path):
    square = [(10, 10), (30, 10), (30, 30), (10, 30)]
    cases = [([square], ["major-damage"], 64), ([square], ["un-classified"], 64),
             ([[(1.4, 2.6), (3.5, 0.2), (0.0, 0.0)]], ["destroyed"], 64),
             ([square, [(20, 5), (60, 25), (25, 60)]], ["minor-damage", "no-damage"], 64)]
    for k, (polys, subtypes, size) in enumerate(cases):
        path = str(tmp_path / f"t{k}_post_disaster.json")
        _label(path, polys, subtypes)
        for mode in ("pre", "post"):
            outs = []
            for conv, who in ((jax_c2p.convert_label, "jax"), (c2p.convert_label, "port")):
                d = tmp_path / f"{who}{k}{mode}"
                d.mkdir()
                conv(path, mode, str(d), size=size)
                outs.append(_read(d / f"t{k}_post_disaster.png"))
            np.testing.assert_array_equal(outs[1], outs[0], err_msg=f"{k} {mode}")
            assert outs[1].any()


def test_convert_dataset_equals_jax_on_random_polygons(tmp_path):
    """240 seeded random simple polygons (12 a label file, later ones over
    earlier ones) through both modules' ``convert_dataset``, the port's by its
    CLI: the target PNGs are equal."""
    rng = np.random.default_rng(11)
    subtypes = list(c2p.DAMAGE_DICT)
    for who in ("jax", "port"):
        (tmp_path / who / "labels").mkdir(parents=True)
    for i in range(20):
        mode = "pre" if i % 2 else "post"
        polys = [_star(rng) for _ in range(12)]
        kinds = [subtypes[j] for j in rng.integers(0, len(subtypes), 12)]
        for who in ("jax", "port"):
            _label(str(tmp_path / who / "labels" / f"x_{i:02d}_{mode}_disaster.json"), polys,
                   kinds)
    jax_c2p.convert_dataset(str(tmp_path / "jax"), n_jobs=1)
    assert c2p.main(["--data", str(tmp_path / "port"), "--n_jobs", "2"]) == 0
    names = sorted(os.listdir(tmp_path / "jax" / "targets"))
    assert len(names) == 20 and names == sorted(os.listdir(tmp_path / "port" / "targets"))
    for name in names:
        np.testing.assert_array_equal(_read(tmp_path / "port" / "targets" / name),
                                      _read(tmp_path / "jax" / "targets" / name), err_msg=name)


def _differing_pixels(ring):
    """(pixels that differ, of them in the last row or column, filled)."""
    want = np.zeros((N, N), np.uint8)
    cv2.fillPoly(want, [ring], 1)
    got = np.zeros((N, N), np.uint8)
    c2p.fill_poly(got, ring, 1)
    differ = got != want
    return int(differ.sum()), int(differ[-1].sum() + differ[:-1, -1].sum()), int(want.sum())


def test_fill_equals_cv2_on_simple_polygons_inside_the_image():
    rng = np.random.default_rng(5)
    for k in range(300):
        ring = _star(rng)
        assert _differing_pixels(ring)[0] == 0, (k, ring.tolist())


def test_fill_differences_outside_that_class_are_counted():
    """The classes ROADMAP Queue 3 lists: simple polygons whose vertices
    reach x or y = 1024 or beyond (OpenCV clips their edges to the image in
    a way not reproduced here), and self-intersecting ones (the order of
    crossing edges in OpenCV's active list).  Their differing pixels are
    printed and stay a small share of the filled ones."""
    rng = np.random.default_rng(6)
    classes = {
        "to 1024": lambda: _star(rng, N - 200, N + 100, clip=(0, N)),
        "across the border": lambda: _star(rng, N - 124, N + 76, clip=None),
        "self-intersecting": lambda: np.round(
            rng.uniform(50, 970, 2) + rng.uniform(-50, 50, (int(rng.integers(4, 12)), 2))
        ).astype(np.int32)}
    for name, draw in classes.items():
        diff = edge = filled = polys = 0
        for _ in range(300):
            d, e, f = _differing_pixels(draw())
            diff, edge, filled, polys = diff + d, edge + e, filled + f, polys + (d > 0)
        print(f"{name}: {polys} of 300 polygons differ, {diff} of {filled} pixels, {edge} of "
              "them in the last row or column")
        assert diff <= 1e-3 * filled, name

