"""ImageNet AutoAugment policy on the device (port of
``xview2_tpu/ops/autoaugment.py``): 25 subpolicies of two ops each over a
14-op table (Cubuk et al., 2019), applied to float images holding uint8-scale
values and, for the spatial ops, jointly to the mask.

The JAX module is a per-sample function under ``vmap``, where the two
``lax.cond``/``lax.switch`` levels become selects and all 14 ops run for every
sample.  Here the batch is handled by hand, in one of two forms that compute
the same numbers:

* GROUPED (:func:`apply_autoaugment`, the eager train step's): the draws
  (:class:`AutoAugmentDraws`) come to the host once per batch, and for each of
  the two slots the samples are grouped by the op they drew; an op runs once
  on its group with per-sample magnitudes and the result is written back.
  Samples whose slot does not fire are left alone.
* STATIC (:func:`apply_autoaugment_static`, the CUDA graph's): JAX's select
  form written for a batch, with fixed shapes and device operations only.
  Per slot, each op of the slot's column of the policy table runs on the
  whole batch and is kept where a sample's fired op is that op; a spatial
  family runs as row-shift passes over the whole batch in which a sample
  that does not take it gets shift 0 and the nearest tap, an exact copy.

The JAX module has two forms of the spatial ops and picks by backend; the
port has one, the TPU's, on both devices: shears and translations are one
:func:`~xview2_tpu_torch.ops.rowshift.row_shift` pass, and a rotation is three
shear passes (Paeth 1986) through the same kernel.  The exact per-pixel rotate
and the affine-matrix helpers of the JAX module are its fallback and its test
oracles and are not carried over (ROADMAP).

Semantics kept from the JAX module: spatial ops resample the mask with the
nearest tap and zero fill; the random sign of an op is shared by both halves
of a pre/post pair and the mask; shears sample the image bilinearly,
translations and rotations nearest (half-up); ``round`` is half-to-even.
Sharpness's SMOOTH filter is nine shifted adds in float32, never a library
convolution (which would run in TF32 on the card at ``--precision 16``), so
the card and the CPU agree.  Contrast's mean grey level is exact (integer
sums), so it does not depend on the device or on how many samples share a
call.  Equalize builds its histogram with an integer ``scatter_add_`` into a
buffer of fixed size (``bincount`` reads its input's maximum back to the
host) and applies the LUT with a gather.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from xview2_tpu_torch.ops.rowshift import row_shift
from xview2_tpu_torch.utils.spans import span

# op ids
SHEAR_X, SHEAR_Y, TRANS_X, TRANS_Y, ROTATE = 0, 1, 2, 3, 4
COLOR, POSTERIZE, SOLARIZE, CONTRAST, SHARPNESS = 5, 6, 7, 8, 9
BRIGHTNESS, AUTOCONTRAST, EQUALIZE, INVERT = 10, 11, 12, 13

_SPATIAL = (SHEAR_X, SHEAR_Y, TRANS_X, TRANS_Y, ROTATE)
_SIGNED = (SHEAR_X, SHEAR_Y, TRANS_X, TRANS_Y, COLOR, CONTRAST, SHARPNESS, BRIGHTNESS)

_OP_NAMES = {
    "shearX": SHEAR_X, "shearY": SHEAR_Y, "translateX": TRANS_X,
    "translateY": TRANS_Y, "rotate": ROTATE, "color": COLOR,
    "posterize": POSTERIZE, "solarize": SOLARIZE, "contrast": CONTRAST,
    "sharpness": SHARPNESS, "brightness": BRIGHTNESS,
    "autocontrast": AUTOCONTRAST, "equalize": EQUALIZE, "invert": INVERT,
}

_RANGES = {
    SHEAR_X: np.linspace(0, 0.3, 10), SHEAR_Y: np.linspace(0, 0.3, 10),
    TRANS_X: np.linspace(0, 150 / 331, 10), TRANS_Y: np.linspace(0, 150 / 331, 10),
    ROTATE: np.linspace(0, 30, 10), COLOR: np.linspace(0.0, 0.9, 10),
    POSTERIZE: np.round(np.linspace(8, 4, 10), 0),
    SOLARIZE: np.linspace(256, 0, 10), CONTRAST: np.linspace(0.0, 0.9, 10),
    SHARPNESS: np.linspace(0.0, 0.9, 10), BRIGHTNESS: np.linspace(0.0, 0.9, 10),
    AUTOCONTRAST: np.zeros(10), EQUALIZE: np.zeros(10), INVERT: np.zeros(10),
}

# the 25 ImageNet subpolicies: (p1, op1, m1, p2, op2, m2)
_POLICIES_RAW = [
    (0.4, "posterize", 8, 0.6, "rotate", 9),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
    (0.6, "posterize", 7, 0.6, "posterize", 6),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.4, "equalize", 4, 0.8, "rotate", 8),
    (0.6, "solarize", 3, 0.6, "equalize", 7),
    (0.8, "posterize", 5, 1.0, "equalize", 2),
    (0.2, "rotate", 3, 0.6, "solarize", 8),
    (0.6, "equalize", 8, 0.4, "posterize", 6),
    (0.8, "rotate", 8, 0.4, "color", 0),
    (0.4, "rotate", 9, 0.6, "equalize", 2),
    (0.0, "equalize", 7, 0.8, "equalize", 8),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "rotate", 8, 1.0, "color", 2),
    (0.8, "color", 8, 0.8, "solarize", 7),
    (0.4, "sharpness", 7, 0.6, "invert", 8),
    (0.6, "shearX", 5, 1.0, "equalize", 9),
    (0.4, "color", 0, 0.6, "equalize", 3),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
]

N_POLICIES = len(_POLICIES_RAW)
_P1 = np.array([p[0] for p in _POLICIES_RAW], np.float32)
_OP1 = np.array([_OP_NAMES[p[1]] for p in _POLICIES_RAW], np.int32)
_M1 = np.array([_RANGES[_OP_NAMES[p[1]]][p[2]] for p in _POLICIES_RAW], np.float32)
_P2 = np.array([p[3] for p in _POLICIES_RAW], np.float32)
_OP2 = np.array([_OP_NAMES[p[4]] for p in _POLICIES_RAW], np.int32)
_M2 = np.array([_RANGES[_OP_NAMES[p[4]]][p[5]] for p in _POLICIES_RAW], np.float32)


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


# --------------------------------------------------------------------------
# intensity ops on (n, H, W, 3) float32 images holding uint8-scale values,
# with one parameter per sample
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _luma_divisor(device: torch.device) -> torch.Tensor:
    """1000.0 on ``device``, made once (a CUDA graph cannot replay a host copy)."""
    with torch.inference_mode(False):
        return torch.tensor(1000.0, dtype=torch.float32, device=device)


def _grayscale(img3: torch.Tensor) -> torch.Tensor:
    """PIL convert('L') luma (ITU-R 601-2).  The divisor is a tensor on the
    image's device: PyTorch's CUDA kernels divide by a Python scalar as a
    multiplication by its reciprocal, which is an ulp off the division the
    CPU (and the JAX module) performs, and a later ``round`` turns that ulp
    into a grey level."""
    return (img3[..., 0] * 299 + img3[..., 1] * 587 + img3[..., 2] * 114) / \
        _luma_divisor(img3.device)


def _blend(a: torch.Tensor, b: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL Image.blend as ImageEnhance uses it: a + factor*(b - a)."""
    return a + _per_sample(factor) * (b - a)


def _op_color(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    gray = _grayscale(img)[..., None].expand_as(img)
    return torch.clamp(_blend(gray, img, factor), 0, 255)


def _op_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend with the mean grey level, ``floor(mean luma + 0.5)`` of the
    rounded image.  The mean is exact: the luma numerators are integers,
    summed in int64 and divided once (JAX's float32 mean rounds on the way);
    a float32 sum's order would depend on the device and on the batch."""
    v = torch.round(img).to(torch.int64)
    num = (v[..., 0] * 299 + v[..., 1] * 587 + v[..., 2] * 114).sum(dim=(1, 2))
    den = 1000 * img.shape[1] * img.shape[2]
    mean = torch.div(2 * num + den, 2 * den, rounding_mode="floor").to(img.dtype)
    return torch.clamp(_blend(_per_sample(mean).expand_as(img), img, factor), 0, 255)


def _op_brightness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img * _per_sample(factor), 0, 255)


_SMOOTH_KERNEL = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0


def _op_sharpness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL SMOOTH filter blended with the image; ImageFilter leaves the
    border pixels untouched.  Nine shifted float32 adds over the interior."""
    h, w = img.shape[1], img.shape[2]
    smooth = img.clone()
    if h > 2 and w > 2:
        acc = None
        for dy in range(3):
            for dx in range(3):
                term = img[:, dy:dy + h - 2, dx:dx + w - 2] * float(_SMOOTH_KERNEL[dy, dx])
                acc = term if acc is None else acc + term
        smooth[:, 1:-1, 1:-1] = acc
    return torch.clamp(_blend(smooth, img, factor), 0, 255)


def _op_posterize(img: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    shift = _per_sample(torch.round(torch.pow(2.0, 8 - bits)))  # exact whatever pow's last bit
    return torch.clamp(torch.floor(torch.round(img) / shift) * shift, 0, 255)


def _op_solarize(img: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    v = torch.round(img)
    return torch.where(v < _per_sample(threshold), v, 255.0 - v)


def _op_invert(img: torch.Tensor, _mag: torch.Tensor) -> torch.Tensor:
    return 255.0 - img


def _op_autocontrast(img: torch.Tensor, _mag: torch.Tensor) -> torch.Tensor:
    """Per-channel linear stretch to [0, 255] (PIL autocontrast, cutoff 0)."""
    v = torch.round(img)
    lo = v.amin(dim=(1, 2), keepdim=True)
    hi = v.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-9)
    out = torch.where(hi > lo, (v - lo) * scale, v)
    return torch.clamp(out, 0, 255)


def histogram256(planes: torch.Tensor) -> torch.Tensor:
    """The (P, 256) int64 histogram of each row of ``planes`` (P, N), int64
    grey levels in [0, 255]: one ``scatter_add_`` into a zeroed buffer of
    fixed size, with no read back to the host (so a CUDA graph can hold it;
    ``bincount`` sizes its output by the input's maximum)."""
    hist = torch.zeros((planes.shape[0], 256), dtype=torch.int64, device=planes.device)
    return hist.scatter_add_(1, planes, torch.ones_like(planes))


def _op_equalize(img: torch.Tensor, _mag: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.equalize per (sample, channel), in integers: a 256-bin
    histogram, ``step = (pixels - last non-zero bin) // 255``, the LUT
    ``(cumsum before the bin + step // 2) // step`` and a gather.  A channel
    with ``step == 0`` (one grey level) is left as it is."""
    n, h, w, c = img.shape
    v = torch.round(img).to(torch.int64).clamp(0, 255)
    planes = v.permute(0, 3, 1, 2).reshape(n * c, h * w)
    hist = histogram256(planes)
    bins = torch.arange(256, device=img.device)
    last_nz = torch.where(hist > 0, bins, torch.zeros_like(bins)).amax(dim=1, keepdim=True)
    hist_last = torch.gather(hist, 1, last_nz)
    step = (hist.sum(dim=1, keepdim=True) - hist_last) // 255
    shifted = torch.cumsum(hist, dim=1) - hist
    lut = torch.clamp((shifted + step // 2) // torch.clamp(step, min=1), 0, 255)
    mapped = torch.gather(lut, 1, planes).to(img.dtype)
    mapped = mapped.reshape(n, c, h, w).permute(0, 2, 3, 1)
    return torch.where((step > 0).reshape(n, 1, 1, c), mapped, img)


_INTENSITY = {
    COLOR: lambda x, m: _op_color(x, 1.0 + m),
    POSTERIZE: _op_posterize,
    SOLARIZE: _op_solarize,
    CONTRAST: lambda x, m: _op_contrast(x, 1.0 + m),
    SHARPNESS: lambda x, m: _op_sharpness(x, 1.0 + m),
    BRIGHTNESS: lambda x, m: _op_brightness(x, 1.0 + m),
    AUTOCONTRAST: _op_autocontrast,
    EQUALIZE: _op_equalize,
    INVERT: _op_invert,
}


# --------------------------------------------------------------------------
# spatial ops: per-line shifts of (image ++ mask) packed into one map
# --------------------------------------------------------------------------

def rotate_shear_factors(mag: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``a = -tan(theta/2)``, ``b = sin(theta)`` in float32 for rotations by
    ``mag`` degrees.  ``theta`` is the float32 product the JAX module forms;
    ``tan`` and ``sin`` are evaluated in float64 and rounded once, which is
    what XLA's float32 functions return at every angle of the table.  An ulp
    here moves a whole line by a pixel where a shift's fraction sits at 0.5,
    so the factors are computed on the host, the same for the card and the
    CPU."""
    theta = (np.asarray(mag, np.float32) * np.float32(np.pi / 180)).astype(np.float64)
    return (-np.tan(theta / 2.0)).astype(np.float32), np.sin(theta).astype(np.float32)


def _rotate_3shear(packed: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotate each sample by the angle whose shear factors are ``a``, ``b``
    ((n,) float32 on the map's device, :func:`rotate_shear_factors`; PIL
    counter-clockwise) as three shear passes.  The dst->src rotation matrix
    factors exactly as ``Sx(a) @ Sy(b) @ Sx(a)``, so rotation is a row
    shift, a column shift and a row shift, each taking the nearest tap (PIL
    rotates NEAREST); taps can drift up to about 1.5 px from the one-gather
    rotation near the largest angles, the same for image and mask.  The
    width is widened by the worst-case overhang of the first shear (30
    degrees, the table's maximum) so corner content survives the
    intermediate passes; the height needs no widening.  A sample with ``a =
    b = 0`` is copied exactly (shift 0, the nearest tap)."""
    n, h, w, _ = packed.shape
    dev = packed.device
    mx = int(np.ceil(0.2680 * (h - 1) / 2.0)) + 2  # tan(15 deg) * h/2
    wp = w + 2 * mx
    cy = (h - 1) / 2.0
    cxp = mx + (w - 1) / 2.0
    x1 = torch.nn.functional.pad(packed, (0, 0, mx, mx))
    nearest = torch.zeros((n,), dtype=torch.int32, device=dev)
    shift_a = a[:, None] * (torch.arange(h, dtype=torch.float32, device=dev) - cy)[None, :]
    shift_b = b[:, None] * (torch.arange(wp, dtype=torch.float32, device=dev) - cxp)[None, :]
    x1 = row_shift(x1, shift_a, nearest, axis=2)
    x2 = row_shift(x1, shift_b, nearest, axis=1)
    x3 = row_shift(x2, shift_a, nearest, axis=2)
    return x3[:, :, mx:mx + w]


def _warp_packed(op: int, mag: np.ndarray, img: torch.Tensor,
                 mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial op ``op`` on a group: the mask rides as the last float32
    channel (always the nearest tap) and is cast back.  Shears lerp the image
    channels, translations take the nearest tap."""
    n, h, w = mask.shape
    dev = img.device
    packed = torch.cat([img, mask.to(img.dtype)[..., None]], dim=-1)
    if op == ROTATE:
        out = _rotate_3shear(packed, *(torch.from_numpy(v).to(dev)
                                       for v in rotate_shear_factors(mag)))
    else:
        m = torch.from_numpy(np.asarray(mag, np.float32)).to(dev)[:, None]
        horizontal = op in (SHEAR_X, TRANS_X)
        lines, length = (h, w) if horizontal else (w, h)
        if op in (SHEAR_X, SHEAR_Y):  # src = pos + m * line
            shift = m * torch.arange(lines, dtype=torch.float32, device=dev)[None, :]
        else:                         # src = pos + m * length
            shift = (m * length).expand(n, lines).contiguous()
        sel = torch.full((n,), int(op in (SHEAR_X, SHEAR_Y)), dtype=torch.int32, device=dev)
        out = row_shift(packed, shift, sel, axis=2 if horizontal else 1)
    return out[..., :-1], out[..., -1].to(mask.dtype)


def apply_op(op: int, mag, img: torch.Tensor,
             mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply op ``op`` with per-sample signed magnitudes ``mag`` (n,) to a
    group ``img`` (n, H, W, 3|6) float32, ``mask`` (n, H, W).  Spatial ops
    transform the image (or pair) and the mask jointly; intensity ops act on
    each 3-channel half with the same parameters and leave the mask alone."""
    mag = np.asarray(mag, np.float32).reshape(-1)
    if img.shape[0] != mag.shape[0] or img.shape[-1] not in (3, 6):
        raise ValueError(f"apply_op: img must be ({mag.shape[0]}, H, W, 3|6), got "
                         f"{tuple(img.shape)}")
    if op in _SPATIAL:
        return _warp_packed(op, mag, img, mask)
    return _intensity(op, img, torch.from_numpy(mag).to(img.device)), mask


def _intensity(op: int, img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Intensity op ``op`` with magnitudes ``m`` (n,) on each 3-channel half."""
    fn = _INTENSITY[op]
    if img.shape[-1] == 6:
        return torch.cat([fn(img[..., :3], m), fn(img[..., 3:], m)], dim=-1)
    return fn(img, m)


# --------------------------------------------------------------------------
# the policy: draws and their application
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AutoAugmentDraws:
    """The random numbers of one batch's AutoAugment, one entry per sample
    (the draws of JAX ``autoaugment_sample``)."""

    policy: torch.Tensor  # (B,) int in [0, 25): the subpolicy
    u1: torch.Tensor      # (B,) f32 U[0, 1): slot 1 fires when u1 < p1[policy]
    u2: torch.Tensor      # (B,) f32 U[0, 1): slot 2 fires when u2 < p2[policy]
    neg1: torch.Tensor    # (B,) bool (p = 0.5): negate slot 1's magnitude if its op is signed
    neg2: torch.Tensor    # (B,) bool (p = 0.5): the same for slot 2


def draw_autoaugment(gen: torch.Generator, b: int, device) -> AutoAugmentDraws:
    """Draw one batch's AutoAugment numbers on ``device`` from ``gen``."""
    policy = torch.randint(0, N_POLICIES, (b,), generator=gen, device=device)
    u = torch.rand((4, b), generator=gen, device=device)
    return AutoAugmentDraws(policy, u[0], u[1], u[2] < 0.5, u[3] < 0.5)


def slot_plan(d: AutoAugmentDraws):
    """The two slots' per-sample ``(op, signed magnitude, fires)`` as numpy
    arrays, from the draws.  This brings the draws to the host (one
    synchronisation per batch, the span ``augment.sync``): the grouping
    needs them there."""
    with span("augment.sync", d.policy.device):
        host = torch.stack([d.policy.to(torch.float32), d.u1, d.u2, d.neg1.to(torch.float32),
                            d.neg2.to(torch.float32)]).cpu().numpy()
    pol = host[0].astype(np.int64)
    plan = []
    for ops, mags, probs, u, neg in ((_OP1, _M1, _P1, host[1], host[3]),
                                     (_OP2, _M2, _P2, host[2], host[4])):
        op = ops[pol]
        sign = np.where(np.isin(op, _SIGNED) & (neg > 0), np.float32(-1.0), np.float32(1.0))
        plan.append((op, (mags[pol] * sign).astype(np.float32), u < probs[pol]))
    return plan


def apply_autoaugment(img: torch.Tensor, mask: torch.Tensor,
                      d: AutoAugmentDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one batch's draws to ``img`` (B, H, W, 3|6) float32 in uint8
    scale and ``mask`` (B, H, W); 6-channel pairs get identical ops on both
    halves.  Returns new tensors of the same shapes and types."""
    img, mask = img.clone(), mask.clone()
    for op, mag, fires in slot_plan(d):
        for o in np.unique(op[fires]):
            rows = np.nonzero(fires & (op == o))[0]
            idx = torch.from_numpy(rows).to(img.device)
            new_img, new_mask = apply_op(int(o), mag[rows], img[idx], mask[idx])
            img[idx] = new_img
            if int(o) in _SPATIAL:
                mask[idx] = new_mask
    return img, mask


def autoaugment_batch(gen: torch.Generator, img: torch.Tensor,
                      mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw and apply: one ImageNet-AutoAugment draw per sample."""
    return apply_autoaugment(img, mask, draw_autoaugment(gen, img.shape[0], img.device))


# --------------------------------------------------------------------------
# the static form: fixed shapes, device operations only
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SlotTable:
    """One slot's column of the policy table on a device, indexed by policy."""

    op: torch.Tensor     # (25,) int64 op id
    mag: torch.Tensor    # (25,) f32 magnitude (unsigned)
    prob: torch.Tensor   # (25,) f32 probability of firing
    rot_a: torch.Tensor  # (25,) f32 rotate_shear_factors(mag)[0]
    rot_b: torch.Tensor  # (25,) f32 rotate_shear_factors(mag)[1]
    ops: Tuple[int, ...]  # the ops the column draws, in id order


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device) -> Tuple[torch.Tensor, Tuple[_SlotTable, ...]]:
    """The policy table on ``device``, made once: "signed" by op id, and the
    two slots' columns with their rotation factors (computed on the host by
    :func:`rotate_shear_factors`, so the card and the CPU shift the same
    lines)."""
    with torch.inference_mode(False):
        signed = torch.tensor([o in _SIGNED for o in range(len(_RANGES))], device=device)
        slots = []
        for ops, mags, probs in ((_OP1, _M1, _P1), (_OP2, _M2, _P2)):
            a, b = rotate_shear_factors(mags)
            slots.append(_SlotTable(
                *(torch.from_numpy(np.asarray(v)).to(device)
                  for v in (ops.astype(np.int64), mags, probs, a, b)),
                ops=tuple(sorted(set(ops.tolist())))))
    return signed, tuple(slots)


def _spatial_static(slot: _SlotTable, op: torch.Tensor, mag: torch.Tensor,
                    flip: torch.Tensor, fires: torch.Tensor, pol: torch.Tensor,
                    img: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spatial ops of one slot on the whole batch, as in
    :func:`_warp_packed`: the x family (shearX lerps by ``m*row``, translateX
    takes the nearest tap at ``m*W``) as one pass along W, the y family as one
    pass along H, the rotation as three nearest passes; each only where the
    slot's column draws it.  A sample that does not take a pass gets shift 0
    and the nearest tap, an exact copy, so no select follows."""
    n, h, w = mask.shape
    dev = img.device
    packed = torch.cat([img, mask.to(img.dtype)[..., None]], dim=-1)
    for shear, trans, axis in ((SHEAR_X, TRANS_X, 2), (SHEAR_Y, TRANS_Y, 1)):
        if shear not in slot.ops and trans not in slot.ops:
            continue
        lines, length = (h, w) if axis == 2 else (w, h)
        is_shear = fires & (op == shear)
        shift = torch.where(
            is_shear[:, None],
            mag[:, None] * torch.arange(lines, dtype=torch.float32, device=dev)[None, :],
            (mag[:, None] * length).expand(n, lines))
        takes = is_shear | (fires & (op == trans))
        shift = torch.where(takes[:, None], shift, torch.zeros_like(shift))
        packed = row_shift(packed, shift, is_shear.to(torch.int32), axis=axis)
    if ROTATE in slot.ops:
        rotates = fires & (op == ROTATE)
        a, b = (torch.where(rotates, torch.where(flip, -t[pol], t[pol]), torch.zeros_like(mag))
                for t in (slot.rot_a, slot.rot_b))
        packed = _rotate_3shear(packed, a, b)
    return packed[..., :-1], packed[..., -1].to(mask.dtype)


def apply_autoaugment_static(img: torch.Tensor, mask: torch.Tensor,
                             d: AutoAugmentDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_autoaugment` with fixed shapes and no host round trip
    (JAX's vmapped select form, written for a batch), so that a CUDA graph
    can hold it and a replay follows new draws.  Per slot: ``fires = u <
    p[policy]``, ``op = OP[policy]`` and the signed magnitude are lookups and
    selects on device tables; the spatial families of the slot's column run
    through K6 on the whole batch (:func:`_spatial_static`); each intensity op
    of the column runs on the whole batch and is kept, by one
    ``torch.where``, where the sample's fired op is that op.  The same
    numbers as :func:`apply_autoaugment`, bit for bit."""
    if img.shape[0] != mask.shape[0] or img.shape[-1] not in (3, 6):
        raise ValueError(f"apply_autoaugment_static: img must be ({mask.shape[0]}, H, W, 3|6), "
                         f"got {tuple(img.shape)}")
    signed, slots = _device_tables(img.device)
    pol = d.policy.to(torch.int64)
    for slot, u, neg in zip(slots, (d.u1, d.u2), (d.neg1, d.neg2)):
        op = slot.op[pol]
        fires = u < slot.prob[pol]
        flip = signed[op] & neg
        m = slot.mag[pol]
        mag = torch.where(flip, -m, m)
        if set(slot.ops) & set(_SPATIAL):
            img, mask = _spatial_static(slot, op, mag, flip, fires, pol, img, mask)
        for o in slot.ops:
            if o not in _SPATIAL:
                keep = _per_sample(fires & (op == o))
                img = torch.where(keep, _intensity(o, img, mag), img)
    # equalize's channel-major map leads torch.where's output layout; the
    # grouped form writes into a row-major copy, and a convolution's
    # algorithm (so its last bits) depends on the layout
    return img.contiguous(), mask
