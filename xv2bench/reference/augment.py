"""Plain reference of the train step's augmentation: the random draws of one
step from its seeded generator, and their application to raw uint8 tiles.

The draws must be the program's bit for bit, so their order and their calls
on the generator are the program's own, written out here again: a
``torch.Generator`` on the tiles' device seeded by :func:`step_seed`, per batch
the non-empty-mask pixel, the window offsets and then either one ImageNet
AutoAugment draw per sample (Cubuk et al. 2019, arXiv:1805.09501) or the
albumentations chain of the xView2 reference (RandomScale p 0.2 with a Keys
cubic resample, flips p 0.33, GaussNoise p 0.1, RandomBrightnessContrast p
0.2).  AutoAugment is applied in its per-batch select form: every op of a
slot's column runs on the whole batch and is kept where it fired; spatial ops
are line shifts by two gathers (the rotation as three shears), with the mask
riding along as the last channel and always taking the nearest tap.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def step_seed(seed: int, step: int) -> int:
    """The seed of train step ``step``'s generator."""
    return (((seed ^ 0x5EED) & 0xFFFFFFFF) << 31) ^ step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step))
    return gen


def normalize(img: torch.Tensor) -> torch.Tensor:
    """(img / 255 - mean) / std per RGB triple of the channels."""
    reps = img.shape[-1] // 3
    mean = torch.tensor(IMAGENET_MEAN, device=img.device).repeat(reps)
    std = torch.tensor(IMAGENET_STD, device=img.device).repeat(reps)
    return (img.to(torch.float32) / 255.0 - mean) / std


def nonzero_pixel(masks: torch.Tensor, u: torch.Tensor):
    """The ``floor(u * count)``-th non-zero mask pixel of each sample in
    row-major order; any pixel where the mask is empty."""
    b, h, w = masks.shape
    nz = masks.reshape(b, h * w) > 0
    count = nz.sum(dim=1)
    empty = count == 0
    nz = nz | empty[:, None]
    count = torch.where(empty, torch.full_like(count, h * w), count)
    k = torch.floor(u.to(torch.float64) * count).to(torch.int32)
    idx = torch.searchsorted(torch.cumsum(nz, dim=1, dtype=torch.int32), k[:, None],
                             right=True)[:, 0]
    return idx // w, idx % w


# ------------------------------------------------------------ AutoAugment

SHEAR_X, SHEAR_Y, TRANS_X, TRANS_Y, ROTATE = 0, 1, 2, 3, 4
COLOR, POSTERIZE, SOLARIZE, CONTRAST, SHARPNESS = 5, 6, 7, 8, 9
BRIGHTNESS, AUTOCONTRAST, EQUALIZE, INVERT = 10, 11, 12, 13
SPATIAL = (SHEAR_X, SHEAR_Y, TRANS_X, TRANS_Y, ROTATE)
SIGNED = (SHEAR_X, SHEAR_Y, TRANS_X, TRANS_Y, COLOR, CONTRAST, SHARPNESS, BRIGHTNESS)
OPS = {"shearX": SHEAR_X, "shearY": SHEAR_Y, "translateX": TRANS_X, "translateY": TRANS_Y,
       "rotate": ROTATE, "color": COLOR, "posterize": POSTERIZE, "solarize": SOLARIZE,
       "contrast": CONTRAST, "sharpness": SHARPNESS, "brightness": BRIGHTNESS,
       "autocontrast": AUTOCONTRAST, "equalize": EQUALIZE, "invert": INVERT}
RANGES = {SHEAR_X: np.linspace(0, 0.3, 10), SHEAR_Y: np.linspace(0, 0.3, 10),
          TRANS_X: np.linspace(0, 150 / 331, 10), TRANS_Y: np.linspace(0, 150 / 331, 10),
          ROTATE: np.linspace(0, 30, 10), COLOR: np.linspace(0.0, 0.9, 10),
          POSTERIZE: np.round(np.linspace(8, 4, 10), 0), SOLARIZE: np.linspace(256, 0, 10),
          CONTRAST: np.linspace(0.0, 0.9, 10), SHARPNESS: np.linspace(0.0, 0.9, 10),
          BRIGHTNESS: np.linspace(0.0, 0.9, 10), AUTOCONTRAST: np.zeros(10),
          EQUALIZE: np.zeros(10), INVERT: np.zeros(10)}
# the 25 ImageNet subpolicies: (p1, op1, m1, p2, op2, m2)
POLICIES = [
    (0.4, "posterize", 8, 0.6, "rotate", 9), (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.8, "equalize", 8, 0.6, "equalize", 3), (0.6, "posterize", 7, 0.6, "posterize", 6),
    (0.4, "equalize", 7, 0.2, "solarize", 4), (0.4, "equalize", 4, 0.8, "rotate", 8),
    (0.6, "solarize", 3, 0.6, "equalize", 7), (0.8, "posterize", 5, 1.0, "equalize", 2),
    (0.2, "rotate", 3, 0.6, "solarize", 8), (0.6, "equalize", 8, 0.4, "posterize", 6),
    (0.8, "rotate", 8, 0.4, "color", 0), (0.4, "rotate", 9, 0.6, "equalize", 2),
    (0.0, "equalize", 7, 0.8, "equalize", 8), (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8), (0.8, "rotate", 8, 1.0, "color", 2),
    (0.8, "color", 8, 0.8, "solarize", 7), (0.4, "sharpness", 7, 0.6, "invert", 8),
    (0.6, "shearX", 5, 1.0, "equalize", 9), (0.4, "color", 0, 0.6, "equalize", 3),
    (0.4, "equalize", 7, 0.2, "solarize", 4), (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.6, "invert", 4, 1.0, "equalize", 8), (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
]


def slot_columns():
    """Per slot: (op, magnitude, probability) arrays over the 25 policies."""
    cols = []
    for o, m, pr in ((1, 2, 0), (4, 5, 3)):
        op = np.array([OPS[q[o]] for q in POLICIES], np.int64)
        mag = np.array([RANGES[OPS[q[o]]][q[m]] for q in POLICIES], np.float32)
        cols.append((op, mag, np.array([q[pr] for q in POLICIES], np.float32)))
    return cols


@dataclasses.dataclass
class AADraws:
    pix_y: torch.Tensor
    pix_x: torch.Tensor
    off_y: torch.Tensor
    off_x: torch.Tensor
    policy: torch.Tensor
    u1: torch.Tensor
    u2: torch.Tensor
    neg1: torch.Tensor
    neg2: torch.Tensor


def draw_autoaugment_step(gen: torch.Generator, masks: torch.Tensor, crop: int) -> AADraws:
    b, dev = masks.shape[0], masks.device
    pix_y, pix_x = nonzero_pixel(masks, torch.rand((b,), generator=gen, device=dev))
    off_y = torch.randint(0, crop, (b,), generator=gen, device=dev)
    off_x = torch.randint(0, crop, (b,), generator=gen, device=dev)
    policy = torch.randint(0, len(POLICIES), (b,), generator=gen, device=dev)
    u = torch.rand((4, b), generator=gen, device=dev)
    return AADraws(pix_y, pix_x, off_y, off_x, policy, u[0], u[1], u[2] < 0.5, u[3] < 0.5)


def shift_lines(x: torch.Tensor, shift: torch.Tensor, lerp: torch.Tensor, axis: int):
    """``out[b, i, j] = x[b, i, j + shift[b, i]]`` along W (``axis`` 2) or H
    (``axis`` 1): the lerp of the two taps where ``lerp[b]`` is set, else the
    nearest (half-up); the last channel always the nearest; zero outside."""
    if axis == 1:
        return shift_lines(x.transpose(1, 2), shift, lerp, 2).transpose(1, 2)
    b, h, w, c = x.shape
    k = torch.floor(shift)
    f = (shift - k)[:, :, None, None]
    lo_idx = torch.arange(w, device=x.device)[None, None, :] + k.long()[:, :, None]

    def tap(idx):
        got = torch.gather(x, 2, idx.clamp(0, w - 1)[..., None].expand(b, h, w, c))
        return torch.where(((idx >= 0) & (idx < w))[..., None], got, torch.zeros_like(got))

    lo, hi = tap(lo_idx), tap(lo_idx + 1)
    near = torch.where(f >= 0.5, hi, lo)
    out = torch.where(lerp.bool()[:, None, None, None], lo * (1.0 - f) + hi * f, near)
    out = torch.cat([out[..., :-1], near[..., -1:]], dim=-1)
    src = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :] + shift[:, :, None]
    return torch.where(((src >= 0) & (src <= w - 1))[..., None], out, torch.zeros_like(out))


def rotation_shears(mag: np.ndarray):
    """``-tan(theta / 2)`` and ``sin(theta)`` of ``mag`` degrees, float32."""
    theta = (np.asarray(mag, np.float32) * np.float32(np.pi / 180)).astype(np.float64)
    return (-np.tan(theta / 2.0)).astype(np.float32), np.sin(theta).astype(np.float32)


def rotate(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation by three nearest-tap shears on a map widened by the largest
    overhang (30 degrees)."""
    n, h, w, _ = x.shape
    dev = x.device
    mx = int(np.ceil(0.2680 * (h - 1) / 2.0)) + 2
    wp = w + 2 * mx
    nearest = torch.zeros((n,), dtype=torch.int32, device=dev)
    sa = a[:, None] * (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0)[None]
    sb = b[:, None] * (torch.arange(wp, dtype=torch.float32, device=dev)
                       - (mx + (w - 1) / 2.0))[None]
    x = torch.nn.functional.pad(x, (0, 0, mx, mx))
    x = shift_lines(x, sa, nearest, 2)
    x = shift_lines(x, sb, nearest, 1)
    x = shift_lines(x, sa, nearest, 2)
    return x[:, :, mx:mx + w]


def _ps(v):
    return v[:, None, None, None]


def _gray(img):
    div = torch.tensor(1000.0, device=img.device)
    return (img[..., 0] * 299 + img[..., 1] * 587 + img[..., 2] * 114) / div


def _blend(a, b, f):
    return a + _ps(f) * (b - a)


def _color(img, f):
    return torch.clamp(_blend(_gray(img)[..., None].expand_as(img), img, f), 0, 255)


def _contrast(img, f):
    v = torch.round(img).to(torch.int64)
    num = (v[..., 0] * 299 + v[..., 1] * 587 + v[..., 2] * 114).sum(dim=(1, 2))
    den = 1000 * img.shape[1] * img.shape[2]
    mean = torch.div(2 * num + den, 2 * den, rounding_mode="floor").to(img.dtype)
    return torch.clamp(_blend(_ps(mean).expand_as(img), img, f), 0, 255)


def _sharpness(img, f):
    h, w = img.shape[1], img.shape[2]
    kern = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    smooth = img.clone()
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = img[:, dy:dy + h - 2, dx:dx + w - 2] * float(kern[dy, dx])
            acc = term if acc is None else acc + term
    smooth[:, 1:-1, 1:-1] = acc
    return torch.clamp(_blend(smooth, img, f), 0, 255)


def _posterize(img, bits):
    shift = _ps(torch.round(torch.pow(2.0, 8 - bits)))
    return torch.clamp(torch.floor(torch.round(img) / shift) * shift, 0, 255)


def _solarize(img, thr):
    v = torch.round(img)
    return torch.where(v < _ps(thr), v, 255.0 - v)


def _autocontrast(img, _):
    v = torch.round(img)
    lo = v.amin(dim=(1, 2), keepdim=True)
    hi = v.amax(dim=(1, 2), keepdim=True)
    out = torch.where(hi > lo, (v - lo) * (255.0 / torch.clamp(hi - lo, min=1e-9)), v)
    return torch.clamp(out, 0, 255)


def _equalize(img, _):
    """PIL's equalize per (sample, channel), in integers."""
    n, h, w, c = img.shape
    v = torch.round(img).to(torch.int64).clamp(0, 255)
    planes = v.permute(0, 3, 1, 2).reshape(n * c, h * w)
    hist = torch.zeros((n * c, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, planes, torch.ones_like(planes))
    bins = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, bins, torch.zeros_like(bins)).amax(dim=1, keepdim=True)
    step = (hist.sum(dim=1, keepdim=True) - torch.gather(hist, 1, last)) // 255
    lut = torch.clamp((torch.cumsum(hist, dim=1) - hist + step // 2)
                      // torch.clamp(step, min=1), 0, 255)
    mapped = torch.gather(lut, 1, planes).to(img.dtype).reshape(n, c, h, w).permute(0, 2, 3, 1)
    return torch.where((step > 0).reshape(n, 1, 1, c), mapped, img)


INTENSITY = {COLOR: lambda x, m: _color(x, 1.0 + m), POSTERIZE: _posterize,
             SOLARIZE: _solarize, CONTRAST: lambda x, m: _contrast(x, 1.0 + m),
             SHARPNESS: lambda x, m: _sharpness(x, 1.0 + m),
             BRIGHTNESS: lambda x, m: torch.clamp(x * _ps(1.0 + m), 0, 255),
             AUTOCONTRAST: _autocontrast, EQUALIZE: _equalize, INVERT: lambda x, m: 255.0 - x}


def _per_half(op, img, mag):
    fn = INTENSITY[op]
    if img.shape[-1] == 6:
        return torch.cat([fn(img[..., :3], mag), fn(img[..., 3:], mag)], dim=-1)
    return fn(img, mag)


def autoaugment(img: torch.Tensor, mask: torch.Tensor, d: AADraws):
    """Both slots of each sample's subpolicy on float32 uint8-scale crops."""
    dev = img.device
    signed = torch.tensor([o in SIGNED for o in range(14)], device=dev)
    pol = d.policy.to(torch.int64)
    for (ops, mags, probs), u, neg in zip(slot_columns(), (d.u1, d.u2), (d.neg1, d.neg2)):
        op = torch.from_numpy(ops).to(dev)[pol]
        fires = u < torch.from_numpy(probs).to(dev)[pol]
        flip = signed[op] & neg
        m = torch.from_numpy(mags).to(dev)[pol]
        mag = torch.where(flip, -m, m)
        column = sorted(set(ops.tolist()))
        if set(column) & set(SPATIAL):
            n, h, w = mask.shape
            packed = torch.cat([img, mask.to(img.dtype)[..., None]], dim=-1)
            for shear, trans, axis in ((SHEAR_X, TRANS_X, 2), (SHEAR_Y, TRANS_Y, 1)):
                if shear not in column and trans not in column:
                    continue
                lines, length = (h, w) if axis == 2 else (w, h)
                is_shear = fires & (op == shear)
                ar = torch.arange(lines, dtype=torch.float32, device=dev)[None, :]
                shift = torch.where(is_shear[:, None], mag[:, None] * ar,
                                    (mag[:, None] * length).expand(n, lines))
                takes = is_shear | (fires & (op == trans))
                shift = torch.where(takes[:, None], shift, torch.zeros_like(shift))
                packed = shift_lines(packed, shift, is_shear.to(torch.int32), axis)
            if ROTATE in column:
                ra, rb = (torch.from_numpy(v).to(dev) for v in rotation_shears(mags))
                rot = fires & (op == ROTATE)
                a, b = (torch.where(rot, torch.where(flip, -t[pol], t[pol]), torch.zeros_like(m))
                        for t in (ra, rb))
                packed = rotate(packed, a, b)
            img, mask = packed[..., :-1], packed[..., -1].to(mask.dtype)
        for o in column:
            if o not in SPATIAL:
                img = torch.where(_ps(fires & (op == o)), _per_half(o, img, mag), img)
    return img.contiguous(), mask


def crop_window(images, masks, d, crop):
    b, h, w = masks.shape
    y0 = torch.clamp(d.pix_y - d.off_y, 0, h - crop)
    x0 = torch.clamp(d.pix_x - d.off_x, 0, w - crop)
    o = torch.arange(crop, device=masks.device)
    batch = torch.arange(b, device=masks.device)[:, None, None]
    rows = (y0[:, None] + o)[:, :, None]
    cols = (x0[:, None] + o)[:, None, :]
    return images[batch, rows, cols].to(torch.float32), masks[batch, rows, cols]


# ---------------------------------------------------- the albumentations chain


@dataclasses.dataclass
class Intensity:
    noise_do: torch.Tensor
    noise_var: torch.Tensor
    noise: torch.Tensor
    bc_do: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor


@dataclasses.dataclass
class ChainDraws:
    do_zoom: torch.Tensor
    zoom_u: torch.Tensor
    pix_y: torch.Tensor
    pix_x: torch.Tensor
    off_y: torch.Tensor
    off_x: torch.Tensor
    flip_h: torch.Tensor
    flip_v: torch.Tensor
    pre: Intensity
    post: Optional[Intensity]


def draw_chain_step(gen: torch.Generator, masks: torch.Tensor, crop: int,
                    channels: int) -> ChainDraws:
    b, dev = masks.shape[0], masks.device

    def uniform(lo=0.0, hi=1.0):
        return torch.rand((b,), generator=gen, device=dev) * (hi - lo) + lo

    def intensity():
        do, var = uniform() < 0.1, uniform(10.0, 50.0)
        noise = torch.randn((b, crop, crop, 3), generator=gen, device=dev)
        return Intensity(do, var, noise, uniform() < 0.2, uniform(0.8, 1.2), uniform(-0.2, 0.2))

    do_zoom, zoom_u = uniform() < 0.2, uniform()
    pix_y, pix_x = nonzero_pixel(masks, uniform())
    off_y, off_x = (torch.randint(0, crop, (b,), generator=gen, device=dev) for _ in range(2))
    flip_h, flip_v = uniform() < 0.33, uniform() < 0.33
    pre = intensity()
    return ChainDraws(do_zoom, zoom_u, pix_y, pix_x, off_y, off_x, flip_h, flip_v, pre,
                      intensity() if channels == 6 else None)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def cubic_weights(in_size, out_size, scale, translation):
    """(B, in, out) weights of a Keys cubic (a = -0.5) resample with
    half-pixel centres, renormalized over the taps inside the input."""
    dev = scale.device
    inv = 1.0 / scale
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (o[None, :] + 0.5) * inv[:, None] - (translation * inv)[:, None] - 0.5
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    wts = _keys_cubic(torch.abs(sample[:, None, :] - i[None, :, None]))
    total = wts.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total, torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], wts, torch.zeros_like(wts))


def _zoom_crop(images, masks, d: ChainDraws, crop):
    b, h, w = masks.shape
    dev = masks.device
    s = torch.where(d.do_zoom, 1.0 + d.zoom_u.to(torch.float32) * 0.3,
                    torch.ones((b,), dtype=torch.float32, device=dev))
    zero = torch.zeros_like(s)
    y_min = torch.clamp(d.pix_y.to(torch.float32) * s - d.off_y.to(torch.float32), zero,
                        h * s - crop)
    x_min = torch.clamp(d.pix_x.to(torch.float32) * s - d.off_x.to(torch.float32), zero,
                        w * s - crop)
    out = torch.einsum("bhwc,bho->bowc", images.to(torch.float32),
                       cubic_weights(h, crop, s, -y_min))
    out = torch.einsum("bowc,bwp->bopc", out, cubic_weights(w, crop, s, -x_min))
    out = torch.clamp(out, 0.0, 255.0)
    o = torch.arange(crop, dtype=torch.float32, device=dev)[None, :]
    src_y = torch.clamp(torch.round((o + 0.5 + y_min[:, None]) / s[:, None] - 0.5), 0, h - 1)
    src_x = torch.clamp(torch.round((o + 0.5 + x_min[:, None]) / s[:, None] - 0.5), 0, w - 1)
    rows = torch.gather(masks, 1, src_y.long()[:, :, None].expand(b, crop, w))
    return out, torch.gather(rows, 2, src_x.long()[:, None, :].expand(b, crop, crop))


def _intensity(img, d: Intensity):
    noisy = torch.clamp(img + d.noise * _ps(torch.sqrt(d.noise_var)), 0.0, 255.0)
    img = torch.where(_ps(d.noise_do), noisy, img)
    bright = torch.clamp(img * _ps(d.alpha) + _ps(d.beta) * 255.0, 0.0, 255.0)
    return torch.where(_ps(d.bc_do), bright, img)


def chain(images, masks, d: ChainDraws, crop):
    img, mask = _zoom_crop(images, masks, d, crop)
    fh, fv = d.flip_h[:, None, None], d.flip_v[:, None, None]
    img = torch.where(fh[..., None], img.flip(2), img)
    mask = torch.where(fh, mask.flip(2), mask)
    img = torch.where(fv[..., None], img.flip(1), img)
    mask = torch.where(fv, mask.flip(1), mask)
    if img.shape[-1] == 3:
        img = _intensity(img, d.pre)
    else:
        img = torch.cat([_intensity(img[..., :3], d.pre), _intensity(img[..., 3:], d.post)],
                        dim=-1)
    return img, mask


def augment_step(seed: int, step: int, images: torch.Tensor, masks: torch.Tensor, crop: int,
                 use_autoaugment: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train step ``step``'s augmented batch: normalized float32 (B, crop,
    crop, C) crops and int64 labels."""
    gen = step_generator(seed, step, masks.device)
    if use_autoaugment:
        d = draw_autoaugment_step(gen, masks, crop)
        img, mask = crop_window(images, masks, d, crop)
        img, mask = autoaugment(img, mask, d)
    else:
        img, mask = chain(images, masks, draw_chain_step(gen, masks, crop, images.shape[-1]),
                          crop)
    return normalize(img), mask.to(torch.int64)
