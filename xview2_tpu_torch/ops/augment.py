"""Input normalization and the on-device training augmentations (port of
``xview2_tpu/ops/augment.py``).

The host feeds raw uint8 tiles; the whole chain runs on the device inside
the train step, batched by hand (the JAX package vmaps a per-sample
function):

1. RandomScale (p=0.2, zoom 1.0-1.3, cubic) fused with the crop: a
   ``crop / s`` window is resized to ``crop`` through separable weight
   matrices (Keys cubic kernel a = -0.5, half-pixel centres, weights
   renormalized over the in-bounds taps, as ``jax.image.scale_and_translate``
   builds them; ``F.interpolate(mode="bicubic")`` uses a = -0.75 and clamps,
   so it is not the same function).
2. CropNonEmptyMaskIfExists: a random non-zero mask pixel and a random offset
   place the window to contain it.
3. HFlip / VFlip p=0.33 each.
4. GaussNoise p=0.1 (var U(10, 50), per-channel, uint8 scale, clipped).
5. RandomBrightnessContrast p=0.2 (alpha 1 +- 0.2, beta +- 0.2 of 255).
6. Normalize: (img/255 - imagenet_mean)/imagenet_std.

A 6-channel pre/post pair shares every spatial draw (zoom, crop, flips);
the intensity chain (4, 5) is drawn independently for each half, as two
albumentations calls would be (reference pytorch_loader.py:45-50).

DRAWING the random numbers (:func:`draw_augment`, from a ``torch.Generator``
on the device) is split from APPLYING them (:func:`apply_augment`), so a test
can hand the JAX package's own draws to the port.  Every per-sample value is
drawn for the GLOBAL batch of a data-parallel step (``world`` ranks of ``B``
rows each), and each rank keeps its own ``B`` rows: a sample's draws do not
depend on how the batch is split, so N ranks reproduce the single-device
step on the global batch.

With ``--autoaugment`` the chain is the other branch of JAX
``augment_sample``: the non-empty-mask crop WITHOUT the zoom, one ImageNet
AutoAugment draw (``ops/autoaugment.py``) and the normalization; flips, noise
and brightness/contrast are not applied (:func:`draw_augment_autoaugment`,
:func:`apply_augment_autoaugment`).  A 6-channel pair takes one draw per
sample: a spatial op, with its sign, moves both halves and the mask alike,
and an intensity op acts on each half with the same magnitude.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from xview2_tpu_torch.ops import autoaugment

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

CROP = 512


def normalize(img: torch.Tensor, channels: int = 3, bgr: bool = False) -> torch.Tensor:
    """A.Normalize semantics: (img/255 - mean)/std, per 3-channel group.

    ``bgr=True`` reverses each RGB triple first, reproducing the reference's
    ``cv2.imread`` channel order (``pytorch_loader.py:39-42``)."""
    img = img.to(torch.float32) / 255.0
    reps = channels // 3
    if bgr:
        img = img.reshape(img.shape[:-1] + (reps, 3)).flip(-1).reshape(img.shape)
    mean, std = _imagenet(img.device, reps)
    return (img - mean) / std


@functools.lru_cache(maxsize=16)
def _imagenet(device: torch.device, reps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std of ``reps`` RGB groups on ``device``, copied
    once (a CUDA graph of train steps cannot replay a host copy)."""
    with torch.inference_mode(False):  # made under the eval step, read by autograd too
        return tuple(torch.tensor(v, dtype=torch.float32, device=device).repeat(reps)
                     for v in (IMAGENET_MEAN, IMAGENET_STD))


def eval_batch(images: torch.Tensor, bgr: bool = False) -> torch.Tensor:
    """Eval-time: normalize only, full tiles (reference pytorch_loader.py:151-171)."""
    return normalize(images, images.shape[-1], bgr)


@dataclasses.dataclass
class IntensityDraws:
    """The random numbers of one 3-channel half's intensity chain, one entry
    per sample."""

    noise_do: torch.Tensor   # (B,) bool (p = 0.1)
    noise_var: torch.Tensor  # (B,) f32 U[10, 50)
    noise: torch.Tensor      # (B, crop, crop, 3) f32 standard normal
    bc_do: torch.Tensor      # (B,) bool (p = 0.2)
    alpha: torch.Tensor      # (B,) f32 U[0.8, 1.2)
    beta: torch.Tensor       # (B,) f32 U[-0.2, 0.2)


@dataclasses.dataclass
class AugmentDraws:
    """The random numbers of one batch's augmentation, one entry per sample
    (the draws of JAX ``augment_sample``): the spatial draws, shared by both
    halves of a 6-channel pair, and each half's intensity chain (``post``
    None for 3 channels)."""

    do_zoom: torch.Tensor    # (B,) bool: RandomScale fires (p = 0.2)
    zoom_u: torch.Tensor     # (B,) f32 U[0, 1): zoom s = 1 + 0.3 * u when it fires
    pix_y: torch.Tensor      # (B,) int: row of the sampled non-zero mask pixel
    pix_x: torch.Tensor      # (B,) int: its column
    off_y: torch.Tensor      # (B,) int in [0, crop): window offset above the pixel
    off_x: torch.Tensor      # (B,) int in [0, crop)
    flip_h: torch.Tensor     # (B,) bool (p = 0.33): reverse the W axis
    flip_v: torch.Tensor     # (B,) bool (p = 0.33): reverse the H axis
    pre: IntensityDraws
    post: Optional[IntensityDraws] = None


def sample_nonzero_pixel(masks: torch.Tensor,
                         u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sample, a uniformly drawn non-zero mask pixel ``(row, col)`` by
    the inverse CDF: sample i takes the ``floor(u[i] * count_i)``-th
    non-zero pixel of its own mask in row-major order (``u``: (B,) uniforms
    in [0, 1); the product is exact in float64), found in an integer
    cumulative sum; uniform over the whole tile where the mask is empty."""
    b, h, w = masks.shape
    nonzero = masks.reshape(b, h * w) > 0
    count = nonzero.sum(dim=1)
    empty = count == 0
    nonzero = nonzero | empty[:, None]
    count = torch.where(empty, torch.full_like(count, h * w), count)
    k = torch.floor(u.to(torch.float64) * count).to(torch.int32)
    cumsum = torch.cumsum(nonzero, dim=1, dtype=torch.int32)
    idx = torch.searchsorted(cumsum, k[:, None], right=True)[:, 0]
    return idx // w, idx % w


def draw_augment(gen: torch.Generator, masks: torch.Tensor, crop: int = CROP,
                 channels: int = 3, rank: int = 0, world: int = 1) -> AugmentDraws:
    """Draw one batch's random numbers on ``masks``'s device from ``gen``;
    ``channels=6`` also draws the post half's intensity chain.  ``masks``
    holds this rank's ``B`` rows of a global batch of ``world * B``: every
    value is drawn for the global batch and the rank keeps rows ``rank * B``
    to ``rank * B + B - 1``."""
    b, dev = masks.shape[0], masks.device
    g, own = b * world, slice(rank * b, rank * b + b)

    def uniform(lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        return torch.rand((g,), generator=gen, device=dev)[own] * (hi - lo) + lo

    def bernoulli(p: float) -> torch.Tensor:
        return uniform() < p

    def intensity() -> IntensityDraws:
        noise_do, noise_var = bernoulli(0.1), uniform(10.0, 50.0)
        noise = torch.randn((g, crop, crop, 3), generator=gen, device=dev)[own]
        return IntensityDraws(noise_do, noise_var, noise, bernoulli(0.2), uniform(0.8, 1.2),
                              uniform(-0.2, 0.2))

    do_zoom, zoom_u = bernoulli(0.2), uniform()
    pix_y, pix_x = sample_nonzero_pixel(masks, uniform())
    off_y, off_x = (torch.randint(0, crop, (g,), generator=gen, device=dev)[own]
                    for _ in range(2))
    flip_h, flip_v = bernoulli(0.33), bernoulli(0.33)
    pre = intensity()
    return AugmentDraws(do_zoom, zoom_u, pix_y, pix_x, off_y, off_x, flip_h, flip_v, pre,
                        intensity() if channels == 6 else None)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel with a = -0.5 (``jax.image``'s "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def cubic_weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                        translation: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) resampling weights of ``jax.image.
    scale_and_translate(method="cubic", antialias=False)`` along one axis:
    output ``o`` samples the input at ``(o + 0.5) / scale - translation /
    scale - 0.5``; the weights of the taps that fall inside the input are
    renormalized to sum to one, and an output whose sample lies outside the
    input gets zeros."""
    dev = scale.device
    inv = 1.0 / scale
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (out_pos[None, :] + 0.5) * inv[:, None] - (translation * inv)[:, None] - 0.5
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    weights = _keys_cubic(torch.abs(sample[:, None, :] - in_pos[None, :, None]))
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def _zoom_crop(images: torch.Tensor, masks: torch.Tensor, d: AugmentDraws,
               crop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused RandomScale + CropNonEmptyMaskIfExists -> (B, crop, crop, .)."""
    b, h, w = masks.shape
    dev = masks.device
    one = torch.ones((b,), dtype=torch.float32, device=dev)
    s = torch.where(d.do_zoom, 1.0 + d.zoom_u.to(torch.float32) * 0.3, one)
    # albumentations: window start = nonzero pixel - U{0..crop-1}, clipped,
    # in SCALED coordinates
    zero = torch.zeros_like(s)
    y_min = torch.clamp(d.pix_y.to(torch.float32) * s - d.off_y.to(torch.float32), zero,
                        h * s - crop)
    x_min = torch.clamp(d.pix_x.to(torch.float32) * s - d.off_x.to(torch.float32), zero,
                        w * s - crop)
    wy = cubic_weight_matrix(h, crop, s, -y_min)
    wx = cubic_weight_matrix(w, crop, s, -x_min)
    out = torch.einsum("bhwc,bho->bowc", images.to(torch.float32), wy)
    out = torch.einsum("bowc,bwp->bopc", out, wx)
    out = torch.clamp(out, 0.0, 255.0)

    # nearest-sample the mask at the same source coordinates
    o = torch.arange(crop, dtype=torch.float32, device=dev)[None, :]
    src_y = torch.clamp(torch.round((o + 0.5 + y_min[:, None]) / s[:, None] - 0.5), 0, h - 1)
    src_x = torch.clamp(torch.round((o + 0.5 + x_min[:, None]) / s[:, None] - 0.5), 0, w - 1)
    rows = torch.gather(masks, 1, src_y.long()[:, :, None].expand(b, crop, w))
    return out, torch.gather(rows, 2, src_x.long()[:, None, :].expand(b, crop, crop))


def _intensity(img: torch.Tensor, d: IntensityDraws) -> torch.Tensor:
    """GaussNoise, then RandomBrightnessContrast, on one 3-channel half."""

    def per_sample(v: torch.Tensor) -> torch.Tensor:
        return v[:, None, None, None]

    noisy = torch.clamp(img + d.noise * per_sample(torch.sqrt(d.noise_var)), 0.0, 255.0)
    img = torch.where(per_sample(d.noise_do), noisy, img)
    bright = torch.clamp(img * per_sample(d.alpha) + per_sample(d.beta) * 255.0, 0.0, 255.0)
    return torch.where(per_sample(d.bc_do), bright, img)


def apply_augment(images: torch.Tensor, masks: torch.Tensor, d: AugmentDraws,
                  crop: int = CROP, bgr: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one batch's draws: raw uint8 ``images`` (B, H, W, 3|6) and
    ``masks`` (B, H, W) -> normalized float32 (B, crop, crop, 3|6) crops and
    int32 (B, crop, crop) labels."""
    c = images.shape[-1]
    if (c == 6) != (d.post is not None):
        raise ValueError(f"{c}-channel images need the draws of {c} channels")
    img, mask = _zoom_crop(images, masks, d, crop)
    # flips are selects: both branches have the same shape
    fh, fv = d.flip_h[:, None, None], d.flip_v[:, None, None]
    img = torch.where(fh[..., None], img.flip(2), img)
    mask = torch.where(fh, mask.flip(2), mask)
    img = torch.where(fv[..., None], img.flip(1), img)
    mask = torch.where(fv, mask.flip(1), mask)
    if c == 3:
        img = _intensity(img, d.pre)
    else:
        img = torch.cat([_intensity(img[..., :3], d.pre), _intensity(img[..., 3:], d.post)],
                        dim=-1)
    return normalize(img, c, bgr), mask.to(torch.int32)


@dataclasses.dataclass
class AutoAugmentBranchDraws:
    """The random numbers of one batch's ``--autoaugment`` chain (the draws
    of JAX ``augment_sample(use_autoaugment=True)``)."""

    pix_y: torch.Tensor  # (B,) int: row of the sampled non-zero mask pixel
    pix_x: torch.Tensor  # (B,) int: its column
    off_y: torch.Tensor  # (B,) int in [0, crop): window offset above the pixel
    off_x: torch.Tensor  # (B,) int in [0, crop)
    aa: autoaugment.AutoAugmentDraws


def draw_augment_autoaugment(gen: torch.Generator, masks: torch.Tensor, crop: int = CROP,
                             rank: int = 0, world: int = 1) -> AutoAugmentBranchDraws:
    """Draw one batch's ``--autoaugment`` numbers on ``masks``'s device, for
    the global batch as :func:`draw_augment` draws them."""
    b, dev = masks.shape[0], masks.device
    g, own = b * world, slice(rank * b, rank * b + b)
    pix_y, pix_x = sample_nonzero_pixel(masks, torch.rand((g,), generator=gen, device=dev)[own])
    off_y, off_x = (torch.randint(0, crop, (g,), generator=gen, device=dev)[own]
                    for _ in range(2))
    aa = autoaugment.draw_autoaugment(gen, g, dev)
    aa = dataclasses.replace(aa, **{f.name: getattr(aa, f.name)[own]
                                    for f in dataclasses.fields(aa)})
    return AutoAugmentBranchDraws(pix_y, pix_x, off_y, off_x, aa)


def _crop_noscale(images: torch.Tensor, masks: torch.Tensor, d: AutoAugmentBranchDraws,
                  crop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """CropNonEmptyMaskIfExists without the zoom: the window starts at the
    sampled pixel minus the offset, clipped into the tile."""
    b, h, w = masks.shape
    y0 = torch.clamp(d.pix_y - d.off_y, 0, h - crop)
    x0 = torch.clamp(d.pix_x - d.off_x, 0, w - crop)
    o = torch.arange(crop, device=masks.device)
    batch = torch.arange(b, device=masks.device)[:, None, None]
    rows = (y0[:, None] + o)[:, :, None]
    cols = (x0[:, None] + o)[:, None, :]
    return images[batch, rows, cols].to(torch.float32), masks[batch, rows, cols]


def apply_augment_autoaugment(images: torch.Tensor, masks: torch.Tensor,
                              d: AutoAugmentBranchDraws, crop: int = CROP,
                              bgr: bool = False, static: bool = False,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one batch's ``--autoaugment`` draws: raw uint8 ``images`` (B, H,
    W, 3|6) and ``masks`` (B, H, W) -> normalized float32 (B, crop, crop, C)
    crops and int32 (B, crop, crop) labels.  ``static`` takes AutoAugment's
    static form (fixed shapes, the draws' device tensors only: what a CUDA
    graph holds) instead of the grouped one; the numbers are the same."""
    img, mask = _crop_noscale(images, masks, d, crop)
    form = autoaugment.apply_autoaugment_static if static else autoaugment.apply_autoaugment
    img, mask = form(img, mask, d.aa)
    return normalize(img, img.shape[-1], bgr), mask.to(torch.int32)


def augment_batch(gen: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                  crop: int = CROP, bgr: bool = False, use_autoaugment: bool = False,
                  rank: int = 0, world: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw and apply: the train step's augmentation of a batch of raw tiles
    (this rank's rows of a global batch of ``world`` ranks)."""
    if use_autoaugment:
        d = draw_augment_autoaugment(gen, masks, crop, rank, world)
        return apply_augment_autoaugment(images, masks, d, crop, bgr)
    d = draw_augment(gen, masks, crop, images.shape[-1], rank, world)
    return apply_augment(images, masks, d, crop, bgr)
