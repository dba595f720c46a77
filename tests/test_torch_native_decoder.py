"""The port's native PNG decoder (``xview2_tpu_torch/csrc/decoder.cpp``, built
with ``g++`` at first use by ``xview2_tpu_torch/data/native.py``) against the
port's PIL path and the JAX package's ``Loader`` on the same synthetic xBD
tree: RGB tiles, gray masks, ``--type post`` pairs, two ranks' rows of the
global batch.  The JAX package's own library is not built here, so its
``Loader`` decodes with PIL.  Every batch is EQUAL.

Formats on which the native decoder and PIL differ (the JAX package's two
decoders differ the same way; ROADMAP, reference behaviour): a palette mask
(native: the gray level of the palette colour; PIL: the palette index) and
a 16-bit gray mask (native: the high byte; PIL: the low byte)."""

import os

import numpy as np
import pytest
from PIL import Image

from xview2_tpu.data import native as jax_native
from xview2_tpu.data.pipeline import Loader as JaxLoader
from xview2_tpu.data.pipeline import XView2Dataset as JaxDataset
from xview2_tpu_torch.data import native, pipeline
from xview2_tpu_torch.data.synthetic import make_synthetic_dataset

SIZE, N, B = 96, 5, 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("xbd"))
    make_synthetic_dataset(root, n_train=N, n_val=1, n_test=N, size=SIZE, seed=3)
    return os.path.join(root, "holdout")


def _batches(loader):
    return [(b.image, b.mask, b.valid) for b in loader]


def _port(split, task, rank=0, world=1, pil=False, monkeypatch=None):
    loader = pipeline.Loader(pipeline.XView2Dataset(split, task), B, shuffle=False,
                             drop_last=False, num_workers=2, rank=rank, world=world)
    if pil:
        monkeypatch.setattr(native, "is_available", lambda: False)
    try:
        return _batches(loader)
    finally:
        if pil:
            monkeypatch.undo()


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_the_decoder_builds_and_probes(tree):
    assert native.is_available(), native.status()
    assert native.status().startswith("native")
    first = sorted(os.listdir(os.path.join(tree, "images")))[0]
    assert native.probe_png(os.path.join(tree, "images", first)) == (SIZE, SIZE)
    assert not jax_native.is_available()  # the JAX Loader below runs PIL


@pytest.mark.parametrize("task", ["pre", "post"])
def test_native_batches_equal_pil_and_the_jax_loader(tree, task, monkeypatch):
    got = _port(tree, task)
    _equal(got, _port(tree, task, pil=True, monkeypatch=monkeypatch))
    want = _batches(JaxLoader(JaxDataset(tree, task, False), B, shuffle=False, drop_last=False,
                              num_workers=2))
    _equal(got, want)
    assert got[0][0].shape == (B, SIZE, SIZE, 3 if task == "pre" else 6)


def test_two_ranks_take_their_rows_of_the_global_batch(tree, monkeypatch):
    """Each rank decodes its rows of the global batch of 2B natively, as its
    PIL path does and as the JAX Loader's global batch holds them; the rank
    past the data gets padding."""
    want = _batches(JaxLoader(JaxDataset(tree, "post", False), 2 * B, shuffle=False,
                              drop_last=False, num_workers=2))
    for rank in (0, 1):
        got = _port(tree, "post", rank, 2)
        _equal(got, _port(tree, "post", rank, 2, pil=True, monkeypatch=monkeypatch))
        for (img, msk, valid), (wi, wm, wv) in zip(got, want):
            rows = slice(rank * B, rank * B + B)
            n = len(wi[rows])
            assert np.array_equal(img[:n], wi[rows]) and np.array_equal(msk[:n], wm[rows])
            assert np.array_equal(valid[:n], wv[rows]) and not valid[n:].any()


def test_a_corrupt_file_raises_naming_it_and_the_loader_falls_back(tree, tmp_path,
                                                                   monkeypatch):
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"not a png" * 8)
    good = os.path.join(tree, "images", sorted(os.listdir(os.path.join(tree, "images")))[0])
    with pytest.raises(IOError, match="bad.png"):
        native.decode_batch([good, bad], SIZE, SIZE, 3)
    with pytest.raises(IOError, match="bad.png"):
        native.decode_image(bad, SIZE, SIZE, 3)
    calls = []

    def failing(paths, *a, **kw):
        calls.append(paths)
        raise IOError(f"native decode failed (-3) for {paths[:1]}")

    want = _port(tree, "pre", pil=True, monkeypatch=monkeypatch)
    monkeypatch.setattr(native, "decode_batch", failing)
    got = _port(tree, "pre")
    assert calls  # the native path was tried, then PIL decoded the batch
    _equal(got, want)


def test_the_raw_cache_skips_the_native_path(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "decode_batch", lambda *a, **kw: pytest.fail("decoded"))
    ds = pipeline.XView2Dataset(tree, "pre", cache_dir=str(tmp_path / "cache"))
    got = _batches(pipeline.Loader(ds, B, shuffle=False, drop_last=False, num_workers=2))
    monkeypatch.undo()
    _equal(got, _port(tree, "pre"))


def _write(path, arr, mode=None):
    Image.fromarray(arr, mode).save(path)
    return path


def test_formats_native_against_pil(tmp_path):
    """EQUAL on RGB, RGBA (alpha dropped), gray read as RGB and gray masks;
    the palette mask and the 16-bit gray mask differ (see the docstring)."""
    rng = np.random.default_rng(0)
    g = rng.integers(0, 5, (32, 48), np.uint8)
    same = {
        "rgb": (_write(tmp_path / "rgb.png", rng.integers(0, 256, (32, 48, 3), np.uint8)), 3),
        "rgba": (_write(tmp_path / "rgba.png", rng.integers(0, 256, (32, 48, 4), np.uint8),
                        "RGBA"), 3),
        "gray as rgb": (_write(tmp_path / "gray3.png", g, "L"), 3),
        "gray mask": (_write(tmp_path / "gray.png", g, "L"), 1),
    }
    for name, (path, c) in same.items():
        pil = pipeline._decode_image(str(path)) if c == 3 else pipeline._decode_mask(str(path))
        nat = native.decode_image(str(path), 32, 48, c)
        assert np.array_equal(nat if c == 3 else nat[..., 0], pil), name
    palette = Image.fromarray(g, "P")
    palette.putpalette([(i * 40) % 256 for i in range(15)] + [0] * (768 - 15))
    palette.save(tmp_path / "palette.png")
    g16 = _write(tmp_path / "g16.png", (g.astype(np.uint16) * 300))
    for name, path in (("palette mask", tmp_path / "palette.png"), ("16-bit gray mask", g16)):
        nat = native.decode_image(str(path), 32, 48, 1)[..., 0]
        assert not np.array_equal(nat, pipeline._decode_mask(str(path))), name


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The binding with no library loaded yet and its own build directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path


def test_missing_headers_fall_back_to_pil_and_say_why(fresh_native, monkeypatch):
    """A build that cannot find png.h (here: an empty include path only)."""
    src = fresh_native / "decoder.cpp"
    src.write_text("#include <png.h>\n")
    (fresh_native / "include").mkdir()
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "FLAGS",
                        native.FLAGS + ("-nostdinc", f"-I{fresh_native / 'include'}"))
    assert not native.is_available()
    assert native.status() == ("PIL: the native decoder is not available (the libpng/libjpeg "
                               "headers are missing (png.h))")
    with pytest.raises(RuntimeError, match="png.h"):
        native.probe_png("any.png")


def test_a_library_that_does_not_load_falls_back_to_pil(fresh_native, monkeypatch):
    """A library built elsewhere, against shared libraries this machine lacks."""
    os.makedirs(native.BUILD_DIR)
    with open(native._lib_path(), "wb") as f:
        f.write(b"not an ELF file")
    assert not native.is_available()
    assert native.status().startswith("PIL: the native decoder is not available (the built "
                                      "library does not load")
