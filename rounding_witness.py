#!/usr/bin/env python3
"""How far one float32 rounding of its weights moves a configuration's train
step and TTA eval step, in one process on one NVIDIA GPU.

Run from the root of a checkout on a machine with the card::

    python3 rounding_witness.py [--config C|D] [--residual_scale R]

Phase 14 of ``chip_smoke.py`` holds configurations C and D on two bands
against one process.  A gate below the distance that rounding alone makes
cannot see a fault of the bands.  This script measures that distance on the
phase's seeded weights, with every bottleneck's residual branch scaled at
its last BatchNorm by ``R`` (``chip_smoke._residual_scaled``; by default the
configuration's own scale in ``chip_smoke.SPO_CONFIGS``): each step against
the same step from the weights moved by about one float32 rounding
(``perturbed``).

- The train step on tiles of spread contrast and brightness (the
  gradients' relative L2 over all leaves, the loss's relative error, and
  the three leaves that make most of the distance): in float32 on the fused
  tail at batch 1 and 2 of 512^2 crops and at 4 and 8 of 256^2; in float64
  on the stock tail (the kernels take bf16 and float32) at batch 2 of
  512^2 and 4 of 256^2.
- The float32 TTA eval step on the fused tail on 4 tiles of 1024^2 (the
  logits' relative L2, the loss's relative error).

The last line is a JSON object of the readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def perturbed(state: dict, seed: int = 1) -> dict:
    """``state`` with every floating tensor moved by about one float32
    rounding (a relative N(0, 2^-24) draw)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {k: v * (1 + torch.randn(v.shape, generator=gen, dtype=v.dtype, device=v.device)
                    * 2 ** -24) if v.is_floating_point() else v for k, v in state.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=("C", "D"), default="C")
    parser.add_argument("--residual_scale", type=float, default=None,
                        help="scale of every bottleneck's residual branch (default: the "
                             "configuration's in chip_smoke.SPO_CONFIGS)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from xview2_tpu_torch.ops import cuda_build

    name = args.config
    _, batch, channels, scale, _, residual, _ = cs.SPO_CONFIGS[name]
    residual = residual if args.residual_scale is None else args.residual_scale
    cs.log(f"kernel build {cuda_build.build_all():.1f} s; configuration {name}, residual "
           f"branches x {residual}")
    seeded = cs._residual_scaled(cs.seeded_model(cs._spo_cfg(name, 32, batch), seed=0,
                                                 kernel_scale=scale, device="cuda").state_dict(),
                                 residual)
    moved = perturbed(seeded)
    readings = {}
    images, masks = cs._raw_train_batch(8, channels, spread=True)
    for precision, b, crop in ((32, 1, cs.CROP), (32, 2, cs.CROP), (32, 4, cs.CROP // 2),
                               (32, 8, cs.CROP // 2), (64, 2, cs.CROP), (64, 4, cs.CROP // 2)):
        cfg = cs._spo_cfg(name, precision, b, fused_tail=precision != 64)
        a, m = (cs._dp_steps(cfg, images[:b], masks[:b], 1, keep_grads=True, state=st, crop=crop)
                for st in (seeded, moved))
        diff = {k: float(((m["grads"][k] - a["grads"][k]) ** 2).sum()) for k in a["grads"]}
        norm = {k: float((a["grads"][k] ** 2).sum()) for k in a["grads"]}
        key = f"train_float{precision}_batch{b}_crop{crop}"
        readings[key] = {
            "grad_rel_l2": cs._rel_l2(m["grads"], a["grads"], list(a["grads"])),
            "loss_rel": abs(m["losses"][0] - a["losses"][0]) / abs(a["losses"][0]),
            # (leaf, its share of the distance's square, its own relative L2)
            "top_leaves": [(k, diff[k] / sum(diff.values()), (diff[k] / max(norm[k], 1e-300))
                            ** 0.5) for k in sorted(diff, key=diff.get, reverse=True)[:3]]}
        cs.log(f"{key}: {readings[key]}")
        del a, m
        torch.cuda.empty_cache()
    del images, masks
    cfg = cs._spo_cfg(name, 32, cs.VAL_BATCH, tta=True)
    a, m = (cs._sp_eval(cfg, keep_logits=True, state=st) for st in (seeded, moved))
    readings["eval_float32"] = {
        "logits_rel_l2": float((m["logits"] - a["logits"]).norm() / a["logits"].norm()),
        "loss_rel": abs(m["loss"] - a["loss"]) / abs(a["loss"])}
    cs.log(f"eval_float32: {readings['eval_float32']}")
    print(json.dumps({"config": name, "residual_scale": residual, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
