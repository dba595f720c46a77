"""The port's AutoAugment against the JAX module, with the JAX module forced
onto its TPU branch (the Pallas row-shift kernel in interpret mode and the
three-shear rotation), which is the one form the port implements.

Inputs are uint8 grey levels made from a seed with numpy and masks with
labels 0..2.  Covered: each of the 14 ops through JAX ``_apply_op`` at every
magnitude and sign the policy table can give it, on 3 and on 6 channels;
``autoaugment_sample`` with JAX's own draws (its key schedule replayed), one
sample per subpolicy that fires a spatial op and some that fire none, applied
as ONE batch so that the grouping by op is exercised; and the
``use_autoaugment`` branch of ``augment_sample`` (crop, AutoAugment,
normalize), on 3 channels and on 6-channel pre/post pairs.  The static form
(``apply_autoaugment_static``, the CUDA graph's) is held EQUAL to the grouped
form on the same batches, on pairs and on every subpolicy x fires pattern x
sign, and to JAX under the same tolerances; equalize's fixed-size histogram
EQUAL to ``bincount``'s.

Tolerances, on the uint8 scale.  Masks: EQUAL everywhere.  Translations,
rotations (nearest taps only), posterize, solarize, invert, autocontrast and
equalize: EQUAL.  Shears: 1e-4 (the lerp, which XLA contracts into an FMA on
the CPU: one float32 ulp, see ``test_torch_rowshift.py``).  Color, contrast,
brightness: 1e-4 (a blend whose multiply-add XLA may contract).  Sharpness:
1e-3 (a 9-term float32 sum in another order than XLA's convolution).  In a
whole sample, an op that rounds its input after an inexact one may move a
few pixels by a grey level (``_assert_policy_close`` states the allowance).
The six rotation angles of the table (10, 26.67 and 30 degrees, both signs)
come out EQUAL at this size, image and mask: the port's shear factors are
bit-equal to XLA's (``test_rotate_shear_factors_equal_xla``)."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_variables import one_torch_thread  # noqa: F401
from xview2_tpu.ops import augment as jaug
from xview2_tpu.ops import autoaugment as jaa
from xview2_tpu_torch.ops import augment as taug
from xview2_tpu_torch.ops import autoaugment as taa
from xview2_tpu_torch.ops import rowshift

SIZE = 64
EXACT = (taa.TRANS_X, taa.TRANS_Y, taa.ROTATE, taa.POSTERIZE, taa.SOLARIZE, taa.INVERT,
         taa.AUTOCONTRAST, taa.EQUALIZE)
ATOL = {taa.SHEAR_X: 1e-4, taa.SHEAR_Y: 1e-4, taa.COLOR: 1e-4, taa.CONTRAST: 1e-4,
        taa.BRIGHTNESS: 1e-4, taa.SHARPNESS: 1e-3}
_NAMES = {v: k for k, v in taa._OP_NAMES.items()}


@pytest.fixture(autouse=True)
def tpu_branch(monkeypatch):
    monkeypatch.setattr(jaa, "force_pallas_interpret", True)


def _table_cases():
    """Every (op, signed magnitude) the policy table can produce."""
    seen = set()
    for ops, mags in ((taa._OP1, taa._M1), (taa._OP2, taa._M2)):
        for op, m in zip(ops.tolist(), mags.tolist()):
            for sign in ((1.0, -1.0) if op in taa._SIGNED and m != 0 else (1.0,)):
                seen.add((op, float(np.float32(m) * np.float32(sign))))
    return sorted(seen)


CASES = _table_cases()


def _sample(seed, channels, size=SIZE):
    """Smooth-ish uint8 image (so equalize and autocontrast see real
    histograms) and a mask of a few labelled blocks."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(20, 200, size)[None, :, None] + np.linspace(0, 40, size)[:, None, None]
    img = np.clip(ramp + rng.normal(0, 25, (size, size, channels)), 0, 255).astype(np.uint8)
    mask = np.zeros((size, size), np.uint8)
    for _ in range(4):
        y, x = rng.integers(0, size - 10, 2)
        mask[y:y + 10, x:x + 7] = rng.integers(1, 3)
    return img.astype(np.float32), mask


@functools.lru_cache(maxsize=None)
def _jax_apply_op():
    return jax.jit(jaa._apply_op)


def _compare(op, got_img, got_mask, want_img, want_mask):
    np.testing.assert_array_equal(got_mask, want_mask)
    if op in EXACT:
        np.testing.assert_array_equal(got_img, want_img)
    else:
        np.testing.assert_allclose(got_img, want_img, rtol=0, atol=ATOL[op])


def test_tables_are_the_jax_tables():
    for name in ("_P1", "_OP1", "_M1", "_P2", "_OP2", "_M2"):
        np.testing.assert_array_equal(getattr(taa, name), getattr(jaa, name))
    assert taa._SIGNED == jaa._SIGNED and taa._SPATIAL == jaa._SPATIAL
    assert taa.N_POLICIES == jaa.N_POLICIES == 25
    ops = {op for op, _ in CASES}
    assert ops == set(range(14)) - {taa.SHEAR_Y, taa.TRANS_X, taa.TRANS_Y, taa.BRIGHTNESS}


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("op,mag", CASES, ids=[f"{_NAMES[o]}{m:+.3g}" for o, m in CASES])
def test_op_matches_jax_apply_op(op, mag, channels):
    img, mask = _sample(op * 7 + channels, channels)
    want_img, want_mask = _jax_apply_op()(jnp.int32(op), jnp.float32(mag), jnp.asarray(img),
                                          jnp.asarray(mask))
    got_img, got_mask = taa.apply_op(op, [mag], torch.from_numpy(img)[None],
                                     torch.from_numpy(mask)[None])
    assert got_mask.dtype == torch.uint8 and got_img.dtype == torch.float32
    _compare(op, got_img[0].numpy(), got_mask[0].numpy(), np.asarray(want_img),
             np.asarray(want_mask))
    if op in taa._SPATIAL:
        assert not np.array_equal(got_mask[0].numpy(), mask)  # the mask moved with the image


# ops the ImageNet table never draws, at magnitudes of their ranges
OFF_TABLE = [(taa.SHEAR_Y, 0.2), (taa.SHEAR_Y, -0.3), (taa.TRANS_X, 150 / 331 / 3),
             (taa.TRANS_X, -150 / 331), (taa.TRANS_Y, 0.25), (taa.TRANS_Y, -0.1),
             (taa.BRIGHTNESS, 0.5), (taa.BRIGHTNESS, -0.7), (taa.ROTATE, 16.666666),
             (taa.ROTATE, -3.3333333)]


@pytest.mark.parametrize("op,mag", OFF_TABLE, ids=[f"{_NAMES[o]}{m:+.3g}" for o, m in OFF_TABLE])
def test_ops_outside_the_table_match_too(op, mag):
    mag = float(np.float32(mag))
    img, mask = _sample(100 + op, 3)
    want_img, want_mask = _jax_apply_op()(jnp.int32(op), jnp.float32(mag), jnp.asarray(img),
                                          jnp.asarray(mask))
    got_img, got_mask = taa.apply_op(op, [mag], torch.from_numpy(img)[None],
                                     torch.from_numpy(mask)[None])
    _compare(op, got_img[0].numpy(), got_mask[0].numpy(), np.asarray(want_img),
             np.asarray(want_mask))


def test_rotate_shear_factors_equal_xla():
    """``a = -tan(theta/2)`` and ``b = sin(theta)`` bit-equal to XLA's float32
    results at every magnitude of the rotate range, both signs (an ulp would
    move whole lines by a pixel where a shift's fraction sits at 0.5)."""
    mags = np.concatenate([jaa._RANGES[jaa.ROTATE], -jaa._RANGES[jaa.ROTATE]]).astype(np.float32)
    theta = jnp.deg2rad(jnp.asarray(mags))
    a, b = taa.rotate_shear_factors(mags)
    np.testing.assert_array_equal(a, np.asarray(-jnp.tan(theta / 2.0)))
    np.testing.assert_array_equal(b, np.asarray(jnp.sin(theta)))


def test_a_group_takes_one_magnitude_per_sample():
    """Three rotations of different angles and signs as one group equal the
    three applied one by one."""
    mags = [10.0, float(np.float32(-26.666666)), 30.0]
    samples = [_sample(40 + i, 3) for i in range(3)]
    img = torch.from_numpy(np.stack([s[0] for s in samples]))
    mask = torch.from_numpy(np.stack([s[1] for s in samples]))
    got_img, got_mask = taa.apply_op(taa.ROTATE, mags, img, mask)
    for i, m in enumerate(mags):
        one_img, one_mask = taa.apply_op(taa.ROTATE, [m], img[i:i + 1], mask[i:i + 1])
        assert torch.equal(got_img[i], one_img[0]) and torch.equal(got_mask[i], one_mask[0])


def test_equalize_leaves_a_flat_channel_alone_and_sharpness_keeps_the_border():
    img = np.full((1, 16, 16, 3), 77.0, np.float32)
    img[0, :, :, 1] = np.arange(256, dtype=np.float32).reshape(16, 16)
    out, _ = taa.apply_op(taa.EQUALIZE, [0.0], torch.from_numpy(img), torch.zeros(1, 16, 16))
    want, _ = _jax_apply_op()(jnp.int32(taa.EQUALIZE), jnp.float32(0), jnp.asarray(img[0]),
                              jnp.zeros((16, 16), jnp.uint8))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want))
    assert (out[0, :, :, 0] == 77).all()
    x, _ = _sample(3, 3, 16)
    out, _ = taa.apply_op(taa.SHARPNESS, [0.7], torch.from_numpy(x)[None], torch.zeros(1, 16, 16))
    border = np.ones((16, 16), bool)
    border[1:-1, 1:-1] = False
    np.testing.assert_array_equal(out[0].numpy()[border], x[border])
    assert not np.array_equal(out[0].numpy()[~border], x[~border])


# ---------------------------------------------------------------- the policy

def jax_aa_draws(key):
    """The numbers ``autoaugment_sample(key, ...)`` draws, by the same splits."""
    k_policy, k_p1, k_p2, k_s1, k_s2 = jax.random.split(key, 5)
    return dict(policy=jax.random.randint(k_policy, (), 0, jaa.N_POLICIES),
                u1=jax.random.uniform(k_p1), u2=jax.random.uniform(k_p2),
                neg1=jax.random.bernoulli(k_s1), neg2=jax.random.bernoulli(k_s2))


def _stack(draws, cls):
    fields = {}
    for name in draws[0]:
        arr = np.stack([np.asarray(d[name]) for d in draws])
        fields[name] = torch.from_numpy(arr.astype(np.int64) if arr.dtype.kind == "i" else arr)
    return cls(**fields)


def _fires(d):
    """Which of the two slots fire for these draws, and their ops."""
    pol = int(d["policy"])
    do1, do2 = float(d["u1"]) < jaa._P1[pol], float(d["u2"]) < jaa._P2[pol]
    return (int(jaa._OP1[pol]) if do1 else None), (int(jaa._OP2[pol]) if do2 else None)


def _seed_for(pred, start):
    for seed in range(start, start + 3000):
        d = jax_aa_draws(jax.random.PRNGKey(seed))
        if pred(d, _fires(d)):
            return seed
    raise AssertionError("no seed found")


_SPATIAL_POLICIES = [i for i in range(jaa.N_POLICIES)
                     if jaa._OP1[i] in jaa._SPATIAL or jaa._OP2[i] in jaa._SPATIAL]


def _spatial_fires(pol):
    def pred(d, fired):
        return int(d["policy"]) == pol and any(o in jaa._SPATIAL for o in fired if o is not None)
    return pred


POLICY_CASES = [(f"policy{p}-spatial", _spatial_fires(p)) for p in _SPATIAL_POLICIES] + [
    ("nothing-fires", lambda d, fired: fired == (None, None)),
    ("two-equalizes", lambda d, fired: fired == (taa.EQUALIZE, taa.EQUALIZE)),
    ("color-then-contrast", lambda d, fired: fired == (taa.COLOR, taa.CONTRAST)),
    ("sharpness-then-invert", lambda d, fired: fired == (taa.SHARPNESS, taa.INVERT)),
    ("solarize-then-autocontrast", lambda d, fired: fired == (taa.SOLARIZE, taa.AUTOCONTRAST)),
    ("negative-sign", lambda d, fired: fired[0] == taa.COLOR and bool(d["neg1"])
     and int(d["policy"]) == 16),
]


ROUNDING = (taa.POSTERIZE, taa.SOLARIZE, taa.EQUALIZE, taa.AUTOCONTRAST, taa.CONTRAST)


def _assert_policy_close(got, want, fired, unit=1.0):
    """EQUAL if every fired op is exact.  Else the loosest op's tolerance
    (autocontrast counts 1e-4 here: inside the whole-sample program XLA
    evaluates its ``(v - lo) * (255 / (hi - lo))`` in another association
    than alone).  Where an op that ROUNDS its input follows an inexact one,
    a value within an ulp of .5 rounds to the other grey level: at most 1% of
    the pixels may then differ, by at most 3 grey levels (equalize maps
    neighbouring levels up to that far apart at this size).  ``unit`` is one
    grey level in the compared scale."""
    ops = [o for o in fired if o is not None]
    if all(o in EXACT for o in ops) and not (len(ops) == 2 and ops[1] == taa.AUTOCONTRAST):
        np.testing.assert_array_equal(got, want)
        return
    atol = max([ATOL.get(o, 0.0) for o in ops] + [1e-4]) * unit
    if len(ops) == 2 and ops[0] not in EXACT and ops[1] in ROUNDING:
        off = np.abs(got - want) > atol
        assert off.mean() <= 0.01 and np.abs(got - want).max() <= 3.001 * unit, \
            (off.mean(), np.abs(got - want).max())
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def policy_batch():
    jaa.force_pallas_interpret = True
    try:
        sample = jax.jit(jaa.autoaugment_sample)
        imgs, masks, draws, want = [], [], [], []
        for i, (_, pred) in enumerate(POLICY_CASES):
            seed = _seed_for(pred, 101 * i)
            key = jax.random.PRNGKey(seed)
            img, mask = _sample(200 + i, 3)
            imgs.append(img)
            masks.append(mask)
            draws.append(jax_aa_draws(key))
            want.append(tuple(np.asarray(a) for a in sample(key, jnp.asarray(img),
                                                            jnp.asarray(mask))))
    finally:
        jaa.force_pallas_interpret = False
    d = _stack(draws, taa.AutoAugmentDraws)
    got = taa.apply_autoaugment(torch.from_numpy(np.stack(imgs)),
                                torch.from_numpy(np.stack(masks)), d)
    return draws, got, want, (np.stack(imgs), np.stack(masks))


@pytest.mark.parametrize("i", range(len(POLICY_CASES)), ids=[c[0] for c in POLICY_CASES])
def test_batch_matches_jax_autoaugment_sample(policy_batch, i):
    draws, (img, mask), want, (img0, mask0) = policy_batch
    fired = _fires(draws[i])
    np.testing.assert_array_equal(mask[i].numpy(), want[i][1])
    _assert_policy_close(img[i].numpy(), want[i][0], fired)
    if fired == (None, None):
        np.testing.assert_array_equal(img[i].numpy(), img0[i])
        np.testing.assert_array_equal(mask[i].numpy(), mask0[i])


@pytest.fixture(scope="module")
def static_batch(policy_batch):
    """The static form on the policy batch's draws: on its 3-channel samples,
    and (with the grouped form beside it) on 6-channel pairs whose post half
    is the pre half upside down."""
    draws, _, _, (img0, mask0) = policy_batch
    d = _stack(draws, taa.AutoAugmentDraws)
    mask = torch.from_numpy(mask0)
    pairs = torch.from_numpy(np.concatenate([img0, img0[:, ::-1]], axis=-1))
    return {3: taa.apply_autoaugment_static(torch.from_numpy(img0), mask, d),
            6: taa.apply_autoaugment_static(pairs, mask, d),
            "grouped 6": taa.apply_autoaugment(pairs, mask, d)}


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("i", range(len(POLICY_CASES)), ids=[c[0] for c in POLICY_CASES])
def test_static_form_equals_the_grouped_form(policy_batch, static_batch, i, channels):
    """``apply_autoaugment_static`` (fixed shapes, device ops only: the CUDA
    graph's form) EQUAL to ``apply_autoaugment`` (grouped by op on the host)
    on the same draws, image and mask, in the same row-major layout."""
    _, grouped, _, _ = policy_batch
    img, mask = static_batch[channels]
    want_img, want_mask = grouped if channels == 3 else static_batch["grouped 6"]
    assert img.shape == want_img.shape and img.is_contiguous() and mask.dtype == want_mask.dtype
    assert torch.equal(mask[i], want_mask[i])
    assert torch.equal(img[i], want_img[i])


@pytest.mark.parametrize("i", range(len(POLICY_CASES)), ids=[c[0] for c in POLICY_CASES])
def test_static_form_matches_jax_autoaugment_sample(policy_batch, static_batch, i):
    draws, _, want, _ = policy_batch
    img, mask = static_batch[3]
    np.testing.assert_array_equal(mask[i].numpy(), want[i][1])
    _assert_policy_close(img[i].numpy(), want[i][0], _fires(draws[i]))


def _every_draw_pattern():
    """Draws of every subpolicy with each slot firing or not and each sign."""
    pol, u1, u2, neg1, neg2 = zip(*itertools.product(
        range(taa.N_POLICIES), (0.0, 0.999), (0.0, 0.999), (False, True), (False, True)))
    return taa.AutoAugmentDraws(torch.tensor(pol), torch.tensor(u1), torch.tensor(u2),
                                torch.tensor(neg1), torch.tensor(neg2))


@pytest.mark.parametrize("channels", [3, 6])
def test_static_form_equals_the_grouped_form_on_every_draw_pattern(channels, monkeypatch):
    """Every subpolicy x fires pattern x sign (400 samples of 32^2) through
    both forms: EQUAL.  The static form makes seven row-shift passes, each
    on the whole batch: slot 1's column draws shearX (one pass along W) and
    rotate (three), slot 2's rotate (three)."""
    passes = []

    def counted(x, shift, sel, axis=2):
        passes.append((tuple(x.shape), axis))
        return rowshift.row_shift(x, shift, sel, axis)

    d = _every_draw_pattern()
    gen = torch.Generator().manual_seed(9)
    n = d.policy.shape[0]
    img = torch.randint(0, 256, (n, 32, 32, channels), generator=gen).float()
    mask = torch.randint(0, 5, (n, 32, 32), generator=gen).to(torch.uint8)
    want_img, want_mask = taa.apply_autoaugment(img, mask, d)
    monkeypatch.setattr(taa, "row_shift", counted)
    got_img, got_mask = taa.apply_autoaugment_static(img, mask, d)
    wide = 32 + 2 * 7  # the rotation's widened map: mx = ceil(0.268 * 31 / 2) + 2
    assert passes == [((n, 32, 32, channels + 1), 2)] + [
        ((n, 32, wide, channels + 1), a) for a in (2, 1, 2)] * 2
    assert torch.equal(got_mask, want_mask) and torch.equal(got_img, want_img)


def test_equalize_histogram_equals_bincount():
    """The fixed-size ``scatter_add_`` histogram EQUAL to ``bincount``'s,
    with a flat plane, one that holds every level and an empty level 0."""
    rng = np.random.default_rng(12)
    planes = torch.from_numpy(rng.integers(1, 256, (5, 777)))
    planes[1] = 77
    planes[2, :256] = torch.arange(256)
    want = torch.bincount((planes + torch.arange(5)[:, None] * 256).reshape(-1),
                          minlength=5 * 256).reshape(5, 256)
    got = taa.histogram256(planes)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert got[1, 77] == 777 and got[0, 0] == 0 and bool((got[2] > 0).all())


def test_six_channel_pair_gets_the_same_ops_on_both_halves():
    """A pre/post pair through a subpolicy with a rotation and a color op:
    equal to JAX, and the two halves, fed the same image, stay identical."""
    jit = jax.jit(jaa.autoaugment_sample)
    seed = _seed_for(lambda d, fired: fired == (taa.ROTATE, taa.COLOR), 7)
    key = jax.random.PRNGKey(seed)
    img3, mask = _sample(300, 3)
    img = np.concatenate([img3, img3], axis=-1)
    want_img, want_mask = jit(key, jnp.asarray(img), jnp.asarray(mask))
    d = _stack([jax_aa_draws(key)], taa.AutoAugmentDraws)
    got_img, got_mask = taa.apply_autoaugment(torch.from_numpy(img)[None],
                                              torch.from_numpy(mask)[None], d)
    np.testing.assert_array_equal(got_mask[0].numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_img[0].numpy(), np.asarray(want_img), rtol=0, atol=1e-4)
    assert torch.equal(got_img[0, ..., :3], got_img[0, ..., 3:])


def test_draws_come_from_the_generator_alone():
    a = taa.draw_autoaugment(torch.Generator().manual_seed(3), 64, "cpu")
    b = taa.draw_autoaugment(torch.Generator().manual_seed(3), 64, "cpu")
    c = taa.draw_autoaugment(torch.Generator().manual_seed(4), 64, "cpu")
    for name in ("policy", "u1", "u2", "neg1", "neg2"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.policy, c.policy)
    assert int(a.policy.min()) >= 0 and int(a.policy.max()) < 25 and a.neg1.dtype == torch.bool
    plan = taa.slot_plan(a)
    assert len(plan) == 2 and all(len(p) == 3 and p[0].shape == (64,) for p in plan)
    img = torch.from_numpy(np.stack([_sample(i, 3, 32)[0] for i in range(8)]))
    mask = torch.from_numpy(np.stack([_sample(i, 3, 32)[1] for i in range(8)]))
    out, m = taa.autoaugment_batch(torch.Generator().manual_seed(5), img, mask)
    assert out.shape == img.shape and m.shape == mask.shape and m.dtype == mask.dtype
    assert bool(torch.isfinite(out).all()) and not torch.equal(out, img)


# ------------------------------------------- augment_sample(use_autoaugment)

TILE, CROP = 96, 64


def jax_branch_draws(key, mask, crop):
    """The numbers ``augment_sample(key, ..., use_autoaugment=True)`` draws."""
    k_crop, k_aa = jax.random.split(key, 2)
    k_pix, k_offy, k_offx = jax.random.split(k_crop, 3)
    yn, xn = jaug._sample_nonzero_pixel(k_pix, jnp.asarray(mask))
    return dict(pix_y=yn, pix_x=xn, off_y=jax.random.randint(k_offy, (), 0, crop),
                off_x=jax.random.randint(k_offx, (), 0, crop)), jax_aa_draws(k_aa)


BRANCH_CASES = [
    ("rotate", "blobs", lambda fired: taa.ROTATE in fired),
    ("shear", "blobs", lambda fired: taa.SHEAR_X in fired),
    ("intensity-only", "blobs", lambda fired: fired == (taa.EQUALIZE, taa.EQUALIZE)),
    ("nothing-corner", "corner", lambda fired: fired == (None, None)),
    ("empty-mask", "empty", lambda fired: taa.SOLARIZE in fired),
]


def _branch_batch(cases, channels, labels):
    """The port's ``apply_augment_autoaugment`` on one batch of ``channels``
    tiles against JAX ``augment_sample(use_autoaugment=True)`` per sample, on
    JAX's draws; a seed per case whose draws fire the case's ops."""
    jaa.force_pallas_interpret = True
    try:
        aug = jax.jit(functools.partial(jaug.augment_sample, use_autoaugment=True, crop=CROP))
        rng = np.random.default_rng(9)
        imgs, masks, crops, aas, want = [], [], [], [], []
        for i, (_, kind, pred) in enumerate(cases):
            img = rng.integers(0, 256, (TILE, TILE, channels), np.uint8)
            mask = np.zeros((TILE, TILE), np.uint8)
            if kind == "blobs":
                for _ in range(3):
                    y, x = rng.integers(0, TILE - 12, 2)
                    mask[y:y + 12, x:x + 9] = rng.integers(1, labels + 1)
            elif kind == "corner":
                mask[TILE - 1, TILE - 2] = 1
            for seed in range(53 * i, 53 * i + 3000):
                key = jax.random.PRNGKey(seed)
                crop_d, aa_d = jax_branch_draws(key, mask, CROP)
                if pred(_fires(aa_d)):
                    break
            else:
                raise AssertionError("no seed found")
            imgs.append(img)
            masks.append(mask)
            crops.append(crop_d)
            aas.append(aa_d)
            want.append(tuple(np.asarray(a) for a in aug(key, jnp.asarray(img),
                                                         jnp.asarray(mask))))
    finally:
        jaa.force_pallas_interpret = False
    fields = {name: torch.from_numpy(np.stack([np.asarray(d[name]) for d in crops])
                                     .astype(np.int64)) for name in crops[0]}
    d = taug.AutoAugmentBranchDraws(aa=_stack(aas, taa.AutoAugmentDraws), **fields)
    images, labels = torch.from_numpy(np.stack(imgs)), torch.from_numpy(np.stack(masks))
    got = taug.apply_augment_autoaugment(images, labels, d, crop=CROP)
    static = taug.apply_augment_autoaugment(images, labels, d, crop=CROP, static=True)
    return d, got, want, aas, static


@pytest.fixture(scope="module")
def branch_batch():
    return _branch_batch(BRANCH_CASES, 3, 2)


@pytest.mark.parametrize("i", range(len(BRANCH_CASES)), ids=[c[0] for c in BRANCH_CASES])
def test_autoaugment_branch_matches_jax_augment_sample(branch_batch, i):
    """Normalized pixels (one grey level is 1 / 255 / 0.224 = 0.0175): labels
    EQUAL; the image at 1e-5 (the normalization's float32 division), with the
    allowance of ``_assert_policy_close`` where equalize follows the shear."""
    d, (x, y), want, aas, _ = branch_batch
    wx, wy = want[i]
    assert x.shape[1:] == (CROP, CROP, 3) and x.dtype == torch.float32 and y.dtype == torch.int32
    np.testing.assert_array_equal(y[i].numpy(), wy)
    fired = _fires(aas[i])
    if fired[0] is not None and fired[0] not in EXACT and fired[1] in ROUNDING:
        _assert_policy_close(x[i].numpy(), wx, fired, unit=1 / 255 / 0.224)
    else:
        np.testing.assert_allclose(x[i].numpy(), wx, rtol=0, atol=1e-5)
    if i == 3:  # the window is clipped at the far edge and holds the pixel
        assert int(d.pix_y[i]) == TILE - 1 and y[i].sum() > 0
    if i == 4:
        assert y[i].sum() == 0


def test_augment_batch_takes_the_flag():
    masks = torch.zeros((3, TILE, TILE), dtype=torch.uint8)
    masks[0, 10:20, 30:40] = 1
    images = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, TILE, TILE, 3),
                                                                np.uint8))
    x, y = taug.augment_batch(torch.Generator().manual_seed(5), images, masks, CROP,
                              use_autoaugment=True)
    x2, y2 = taug.augment_batch(torch.Generator().manual_seed(5), images, masks, CROP,
                                use_autoaugment=True)
    assert x.shape == (3, CROP, CROP, 3) and y.shape == (3, CROP, CROP) and y.dtype == torch.int32
    assert torch.equal(x, x2) and torch.equal(y, y2)
    x3, _ = taug.augment_batch(torch.Generator().manual_seed(5), images, masks, CROP)
    assert not torch.equal(x, x3)


# --autoaugment on 6-channel pre/post pairs with damage labels 1..4: a shear
# and a rotation (one signed draw for both halves and the mask), intensity
# ops acting on each half with one magnitude, and a draw that fires nothing
PAIR_CASES = [
    ("rotate", "blobs", lambda fired: taa.ROTATE in fired),
    ("shear", "blobs", lambda fired: taa.SHEAR_X in fired or taa.SHEAR_Y in fired),
    ("intensity-only", "blobs",
     lambda fired: None not in fired and not set(fired) & set(taa._SPATIAL)
     and taa.EQUALIZE not in fired),
    ("nothing", "blobs", lambda fired: fired == (None, None)),
]


@pytest.fixture(scope="module")
def pair_batch():
    return _branch_batch(PAIR_CASES, 6, 4)


@pytest.mark.parametrize("i", range(len(PAIR_CASES)), ids=[c[0] for c in PAIR_CASES])
def test_autoaugment_branch_on_pairs_matches_jax_augment_sample(pair_batch, i):
    """The crop and one AutoAugment draw per pair against JAX
    ``augment_sample(use_autoaugment=True)`` on 6 channels, under
    ``test_autoaugment_branch_matches_jax_augment_sample``'s tolerances."""
    d, (x, y), want, aas, _ = pair_batch
    wx, wy = want[i]
    assert x.shape[1:] == (CROP, CROP, 6) and y.dtype == torch.int32
    np.testing.assert_array_equal(y[i].numpy(), wy)
    fired = _fires(aas[i])
    if fired[0] is not None and fired[0] not in EXACT and fired[1] in ROUNDING:
        _assert_policy_close(x[i].numpy(), wx, fired, unit=1 / 255 / 0.224)
    else:
        np.testing.assert_allclose(x[i].numpy(), wx, rtol=0, atol=1e-5)
    if i == 3:  # nothing fired: the crop of the raw pair, normalized
        assert y[i].max() > 0


@pytest.mark.parametrize("batch", ["branch_batch", "pair_batch"])
def test_static_route_of_the_branch_equals_the_grouped_route(batch, request):
    """``apply_augment_autoaugment(static=True)`` (the crop, AutoAugment's
    static form, the normalization) EQUAL to the grouped route on the same
    draws, on 3-channel tiles and on 6-channel pairs."""
    _, (x, y), _, _, (xs, ys) = request.getfixturevalue(batch)
    assert torch.equal(xs, x) and torch.equal(ys, y) and xs.is_contiguous()


@pytest.mark.parametrize("i", range(len(PAIR_CASES)), ids=[c[0] for c in PAIR_CASES])
def test_static_route_on_pairs_matches_jax_augment_sample(pair_batch, i):
    """The static route on 6-channel pairs against JAX ``augment_sample(
    use_autoaugment=True)``, under the grouped route's tolerances."""
    _, _, want, aas, (x, y) = pair_batch
    wx, wy = want[i]
    np.testing.assert_array_equal(y[i].numpy(), wy)
    fired = _fires(aas[i])
    if fired[0] is not None and fired[0] not in EXACT and fired[1] in ROUNDING:
        _assert_policy_close(x[i].numpy(), wx, fired, unit=1 / 255 / 0.224)
    else:
        np.testing.assert_allclose(x[i].numpy(), wx, rtol=0, atol=1e-5)
