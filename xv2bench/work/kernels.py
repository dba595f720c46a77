"""The work of each of the port's kernels K1-K6 at a call's shapes: its
operations and bytes, each input read once and each output written once,
and its least time on one H100, max(operations / peak, bytes / HBM rate).

``launch_plan`` lists the launches one step of a cell makes, from the
configuration and the cell's shapes alone; K6's depend on the step's
AutoAugment draws, which :func:`k6_plan` works out from them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor cores, no sparsity


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_BF16)


def k1(shape, itemsize: int) -> float:
    """Relayout: one read and one write of the tensor."""
    return bound_s(2 * float(np.prod(shape)) * itemsize)


def k2(b, h, w, c, co) -> float:
    """Fused BN-fold + LeakyReLU prologue, 3x3 conv and the output's channel
    sums: bf16 map in and out, bf16 kernel, float32 fold and sums."""
    flops = 2.0 * b * h * w * 9 * c * co
    return bound_s((b * h * w * (c + co) + 9 * c * co) * 2 + (3 * c + 2 * co) * 4, flops)


def k4(b, h, w, c, co) -> float:
    """Weight gradient of the fused conv: the map and the cotangent in,
    the float32 kernel gradient and fold out."""
    flops = 2.0 * b * h * w * 9 * c * co
    return bound_s(b * h * w * (c + co) * 2 + 9 * c * co * 4 + 3 * c * 4, flops)


def k5(b, h, w, c, co) -> float:
    """Input gradient through the conv, the fold and the activation."""
    flops = 2.0 * b * h * w * 9 * c * co
    return bound_s(b * h * w * (c + co) * 2 + (b * h * w * c + 9 * c * co) * 2 + 5 * c * 4,
                   flops)


def k3(npix, c, co) -> float:
    """Packed 1x1 head with the deferred fold: bf16 map in, bf16 logits out."""
    return bound_s(npix * c * 2 + npix * co * 2 + (c * co + co + 3 * c) * 4,
                   2.0 * npix * c * co)


def k6(n, h, w, c, lines) -> float:
    """One row-shift pass over (n, h, w, c) float32 with (n, lines) shifts."""
    return bound_s(2 * n * h * w * c * 4 + n * lines * 4 + n * 4)


def rotation_width(h: int, w: int) -> int:
    return w + 2 * (int(np.ceil(0.2680 * (h - 1) / 2.0)) + 2)


def k6_groups(n: int, crop: int, channels: int, op: str) -> List[float]:
    """The passes of one AutoAugment group of ``n`` samples: a shear or a
    translation is one pass, a rotation three on the widened map."""
    c = channels + 1   # the mask rides as a channel
    if op == "rotate":
        wp = rotation_width(crop, crop)
        return [k6(n, crop, wp, c, crop), k6(n, crop, wp, c, wp), k6(n, crop, wp, c, crop)]
    return [k6(n, crop, crop, c, crop)]


def k6_plan(groups: List[Tuple[str, int]], crop: int, channels: int) -> List[float]:
    """The eager (grouped) step's K6 launches from its spatial groups, (op
    name, samples) per slot and op."""
    return [b for op, n in groups for b in k6_groups(n, crop, channels, op)]


def decoder_layers(b: int, tile: int) -> List[Tuple[int, int, int, int, int]]:
    """(B, H, W, C, Co) of the fused convs of one decoder at a ``tile``^2
    input: dec_l2 and dec_l3 (both convs; their skips are the encoder's 512
    and 256 channels) and the s2d-packed dec_l5 (both convs)."""
    return [(b, tile // 8, tile // 8, 256 + 512, 256), (b, tile // 8, tile // 8, 256, 256),
            (b, tile // 4, tile // 4, 128 + 256, 128), (b, tile // 4, tile // 4, 128, 128),
            (b, tile // 2, tile // 2, 128, 128), (b, tile // 2, tile // 2, 128, 128)]


def launch_plan(spec: dict, kind: str, batch: int, tile: int) -> Dict[str, List[float]]:
    """Per kernel, the least time of each launch of one step (K6 aside).
    ``kind`` "train" (``tile`` the crop) or "eval" (``tile`` the tile, four
    flips in one forward)."""
    fused = spec["type"] == "post" and spec.get("dmg_model") == "fused"
    n_class = 2 if spec["type"] == "pre" else {"coral": 3, "mse": 1}.get(spec["loss_str"], 4)
    head_n = 1 if n_class == 3 else n_class
    b = batch * (4 if kind == "eval" else 1)
    layers = decoder_layers(b, tile) * (2 if fused else 1)
    if fused:   # the cross-fusion's packed group convs, over both branches
        layers += [(b, tile // 2, tile // 2, 256, 128)] * 2
    plan = {"K2 conv_bn_fused": [k2(*s) for s in layers]}
    branches = 2 if fused else 1
    npix = b * (tile // 2) ** 2
    plan["K3 head_conv_fused"] = [k3(npix, 128 * branches, 4 * head_n)]
    if kind == "train":
        plan["K4 conv_bn_wgrad"] = [k4(*s) for s in layers]
        plan["K5 conv_bn_dgrad"] = [k5(*s) for s in layers]
        half = (batch, tile // 2, 2 * tile)
        k1s = [k1(half, 4)]                                   # the labels' loss view
        outs = [half + (n_class,)]
        if spec.get("deep_supervision"):
            k1s.append(k1((batch, tile, tile), 4))            # the fine labels
            outs += [(batch, tile // 2, tile // 2, n_class), (batch, tile // 4, tile // 4, n_class)]
        k1s += [k1(o, 2) for o in outs] * 2                   # the logits and their cotangents
        plan["K1 relayout"] = k1s
    else:
        plan["K1 relayout"] = [k1((batch, tile, tile, n_class), 4)]
    return plan


def k6_step(seed: int, step: int, masks, crop: int, channels: int) -> List[float]:
    """The K6 launches of eager train step ``step`` under ``--autoaugment``:
    the step's AutoAugment draws (the reference works them out from the
    seeded stream), grouped as the grouped form groups them, one group per
    slot and spatial op that fires."""
    from xv2bench.reference import augment as A

    d = A.draw_autoaugment_step(A.step_generator(seed, step, masks.device), masks, crop)
    pol = d.policy.cpu().numpy()
    groups = []
    for (ops, _, probs), u in zip(A.slot_columns(), (d.u1, d.u2)):
        op = ops[pol]
        fires = u.cpu().numpy() < probs[pol]
        for o in np.unique(op[fires]):
            if o in A.SPATIAL:
                groups.append(("rotate" if o == A.ROTATE else "shift",
                               int((fires & (op == o)).sum())))
    return k6_plan(groups, crop, channels)
