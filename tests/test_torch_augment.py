"""The port's train augmentation, APPLIED with the JAX package's own draws.

The test replays the key schedule of ``augment_sample`` (``jax.random.split``
as in ``xview2_tpu/ops/augment.py:84, 112, 124, 133, 141, 165``) to get each
sample's random numbers, hands them to ``apply_augment`` and compares with
``augment_sample`` on the same key.  Covered: the cubic zoom on and off,
both flips, noise and brightness/contrast on and off, a crop window clipped
at each image edge, and an empty mask.

Tolerances (normalized pixels; one grey level is 0.017): labels equal; the
image at atol 1e-4 without the zoom (the weight matrices are then exact
one-hot copies) and 5e-3 with it (the sample position is computed in float32
in both packages and may differ by an ulp of a coordinate near 100, which
the cubic weights turn into up to 1e-3 of 255)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xview2_tpu.ops import augment as jaug
from xview2_tpu_torch.ops import augment as taug

SIZE, CROP = 96, 48


def jax_draws(key, mask, crop):
    """The random numbers ``augment_sample(key, ...)`` draws for a 3-channel
    sample, by the same splits."""
    k_crop, k_flip, k_int_pre, _ = jax.random.split(key, 4)
    k_zoom_p, k_zoom_s, k_pix, k_offy, k_offx = jax.random.split(k_crop, 5)
    yn, xn = jaug._sample_nonzero_pixel(k_pix, jnp.asarray(mask))
    kh, kv = jax.random.split(k_flip)
    k_noise_chain, k_bc_chain = jax.random.split(k_int_pre)
    kn_p, kn_var, kn_noise = jax.random.split(k_noise_chain, 3)
    kb_p, kb_a, kb_b = jax.random.split(k_bc_chain, 3)
    return dict(
        do_zoom=jax.random.bernoulli(k_zoom_p, 0.2), zoom_u=jax.random.uniform(k_zoom_s),
        pix_y=yn, pix_x=xn,
        off_y=jax.random.randint(k_offy, (), 0, crop), off_x=jax.random.randint(k_offx, (), 0, crop),
        flip_h=jax.random.bernoulli(kh, 0.33), flip_v=jax.random.bernoulli(kv, 0.33),
        noise_do=jax.random.bernoulli(kn_p, 0.1),
        noise_var=jax.random.uniform(kn_var, (), minval=10.0, maxval=50.0),
        noise=jax.random.normal(kn_noise, (crop, crop, 3)),
        bc_do=jax.random.bernoulli(kb_p, 0.2),
        alpha=1.0 + jax.random.uniform(kb_a, (), minval=-0.2, maxval=0.2),
        beta=jax.random.uniform(kb_b, (), minval=-0.2, maxval=0.2))


def _arrays(draws):
    fields = {}
    for name in draws[0]:
        arr = np.stack([np.asarray(d[name]) for d in draws])
        fields[name] = torch.from_numpy(arr.astype(np.int64) if arr.dtype.kind == "i" else arr)
    return fields


def _stack(draws, post=None):
    """``AugmentDraws`` from per-sample ``jax_draws`` and, for a 6-channel
    pair, the post half's per-sample intensity draws."""
    fields = _arrays(draws)
    pre = taug.IntensityDraws(**{f.name: fields.pop(f.name)
                                 for f in dataclasses.fields(taug.IntensityDraws)})
    return taug.AugmentDraws(**fields, pre=pre,
                             post=None if post is None else taug.IntensityDraws(**_arrays(post)))


def _tile(rng, mask_kind):
    img = rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    if mask_kind == "blobs":
        for _ in range(3):
            y, x = rng.integers(0, SIZE - 12, 2)
            mask[y:y + 12, x:x + 9] = rng.integers(1, 3)
    elif mask_kind == "top-left":
        mask[1, 2] = 1
    elif mask_kind == "bottom-right":
        mask[SIZE - 1, SIZE - 2] = 1
    return img, mask  # "empty": all zeros


def _first_seed(pred, mask, start=0):
    for seed in range(start, start + 400):
        d = jax_draws(jax.random.PRNGKey(seed), mask, CROP)
        if pred(d):
            return seed
    raise AssertionError("no seed found")


CASES = [
    ("zoom", "blobs", lambda d: bool(d["do_zoom"])),
    ("no-zoom", "blobs", lambda d: not bool(d["do_zoom"]) and not bool(d["noise_do"])),
    ("zoom+flips", "blobs", lambda d: bool(d["do_zoom"]) and bool(d["flip_h"]) and bool(d["flip_v"])),
    ("noise", "blobs", lambda d: bool(d["noise_do"])),
    ("brightness", "blobs", lambda d: bool(d["bc_do"]) and not bool(d["do_zoom"])),
    ("edge-top-left", "top-left", lambda d: True),
    ("edge-bottom-right-zoom", "bottom-right", lambda d: bool(d["do_zoom"])),
    ("empty-mask", "empty", lambda d: True),
    ("empty-mask-zoom", "empty", lambda d: bool(d["do_zoom"])),
]


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    aug = jax.jit(functools.partial(jaug.augment_sample, crop=CROP))
    imgs, masks, draws, want = [], [], [], []
    for i, (_, kind, pred) in enumerate(CASES):
        img, mask = _tile(rng, kind)
        seed = _first_seed(pred, mask, start=37 * i)
        key = jax.random.PRNGKey(seed)
        imgs.append(img)
        masks.append(mask)
        draws.append(jax_draws(key, mask, CROP))
        want.append(tuple(np.asarray(a) for a in aug(key, jnp.asarray(img), jnp.asarray(mask))))
    d = _stack(draws)
    got = taug.apply_augment(torch.from_numpy(np.stack(imgs)), torch.from_numpy(np.stack(masks)),
                             d, crop=CROP)
    return d, got, want


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_apply_matches_jax_augment_sample(batch, i):
    d, (x, y), want = batch
    wx, wy = want[i]
    assert x.shape[1:] == (CROP, CROP, 3) and x.dtype == torch.float32
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y[i].numpy(), wy)
    atol = 5e-3 if bool(d.do_zoom[i]) else 1e-4
    np.testing.assert_allclose(x[i].numpy(), wx, rtol=0, atol=atol)


def test_cases_cover_what_they_claim(batch):
    d, (_, y), _ = batch
    assert d.do_zoom.any() and (~d.do_zoom).any() and d.flip_h.any() and d.flip_v.any()
    assert d.pre.noise_do.any() and d.pre.bc_do.any()
    assert int(d.pix_y[5]) == 1 and int(d.pix_x[5]) == 2       # window clipped at 0
    assert int(d.pix_y[6]) == SIZE - 1                         # clipped at the far edge
    assert y[5].sum() > 0 and y[6].sum() > 0                   # the pixel is inside the crop
    assert y[7].sum() == 0


def test_cubic_weights_are_the_keys_kernel_renormalized_at_the_edges():
    """a = -0.5 (not torch's bicubic a = -0.75); rows sum to one even where
    taps fall outside the input; identity at scale 1 and integer shifts."""
    s = torch.tensor([1.0, 1.25])
    w = taug.cubic_weight_matrix(16, 8, s, torch.tensor([-3.0, 0.0]))
    assert w.shape == (2, 16, 8)
    np.testing.assert_allclose(w.sum(dim=1).numpy(), 1.0, atol=1e-6)
    eye = np.zeros((16, 8), np.float32)
    eye[np.arange(8) + 3, np.arange(8)] = 1.0
    np.testing.assert_array_equal(w[0].numpy(), eye)
    # first output of the zoomed row samples at 0.5/1.25 - 0.5 = -0.1: taps
    # -2 and -1 are outside, the rest renormalized
    x = np.abs(-0.1 - np.arange(16))
    k = np.where(x < 1, (1.5 * x - 2.5) * x * x + 1, np.where(x < 2, ((-0.5 * x + 2.5) * x - 4) * x + 2, 0))
    np.testing.assert_allclose(w[1, :, 0].numpy(), k / k.sum(), atol=1e-6)


def test_draws_come_from_the_generator_alone():
    masks = torch.zeros((3, SIZE, SIZE), dtype=torch.uint8)
    masks[0, 10:20, 30:40] = 1
    masks[1, 5, 7] = 2
    a = taug.draw_augment(torch.Generator().manual_seed(5), masks, CROP)
    b = taug.draw_augment(torch.Generator().manual_seed(5), masks, CROP)
    c = taug.draw_augment(torch.Generator().manual_seed(6), masks, CROP)
    for name in ("zoom_u", "pix_y", "off_x"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(a.pre.noise, b.pre.noise) and torch.equal(a.pre.alpha, b.pre.alpha)
    assert not torch.equal(a.pre.noise, c.pre.noise)
    assert 10 <= int(a.pix_y[0]) < 20 and 30 <= int(a.pix_x[0]) < 40   # a non-zero pixel
    assert (int(a.pix_y[1]), int(a.pix_x[1])) == (5, 7)
    assert a.pre.noise.shape == (3, CROP, CROP, 3) and a.off_y.max() < CROP
    assert a.post is None and bool(((a.pre.alpha >= 0.8) & (a.pre.alpha < 1.2)).all())
    x, y = taug.augment_batch(torch.Generator().manual_seed(5), torch.zeros(
        (3, SIZE, SIZE, 3), dtype=torch.uint8), masks, CROP)
    assert x.shape == (3, CROP, CROP, 3) and y.shape == (3, CROP, CROP)
