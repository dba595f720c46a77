#!/usr/bin/env python3
"""Eager optimizer cost on one NVIDIA GPU: ``opt.step()`` alone and the whole
train step, per optimizer, for the port in a given checkout.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 optimizer_step_time.py                      # this checkout's port
    python3 optimizer_step_time.py --tree OTHER_CHECKOUT  # another's (e.g. a parent commit)

The model is the headline ResNet-50 ``UNetLoc`` (batch 16 of 512^2 crops of
1024^2 tiles, bf16, the fused tail), from a fixed seed.  ``opt.step()`` is
timed on fixed gradients, each call between CUDA events, over 25 updates from
a fresh optimizer: the median of updates 1-5 and of 6-25 (RAdam rectifies
from the sixth).  The train step (``make_train_step``) is timed by CUDA
events, the median of 10 steps after 2 warm-ups, for the optimizers named by
``--steps``.  Compare two checkouts only within one run of the machine
(A, B, B, A).  Prints one JSON object."""

import argparse
import json
import os
import statistics
import sys

OPTIMIZERS = ("adamw", "sgd", "radam", "adabelief", "adabound", "adamp", "novograd")


def _events_ms(fn):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                        help="the checkout whose xview2_tpu_torch is timed")
    parser.add_argument("--steps", default="adamw,radam,adabound",
                        help="optimizers whose whole train step is timed")
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("optimizer_step_time.py needs a CUDA device", file=sys.stderr)
        return 1
    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.models.unet import build_model
    from xview2_tpu_torch.parallel import steps
    from xview2_tpu_torch.train.optimizers import build_optimizer

    import xview2_tpu_torch
    if not os.path.abspath(xview2_tpu_torch.__file__).startswith(tree):
        raise AssertionError(f"imported {xview2_tpu_torch.__file__}, not the port of {tree}")
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "opt_step_ms": {},
           "train_step_ms": {}}
    g = torch.Generator(device="cuda").manual_seed(13)
    images = torch.randint(0, 256, (16, 1024, 1024, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    masks = (torch.rand((16, 1024, 1024), generator=g, device="cuda") > 0.9).to(torch.uint8)
    for name in OPTIMIZERS:
        cfg = Config(type="pre", encoder="resnet50", fused_tail=True, batch_size=16,
                     optimizer=name, weight_decay=0.05)
        apply_precision(cfg)
        torch.manual_seed(0)
        model = build_model(cfg).cuda()
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g, device="cuda", dtype=p.dtype) * 1e-3
        opt = build_optimizer(cfg, model.parameters(), cfg.lr)
        times = [_events_ms(opt.step) for _ in range(25)]
        out["opt_step_ms"][name] = {"updates_1_5": statistics.median(times[:5]),
                                    "updates_6_25": statistics.median(times[5:])}
        if name in args.steps.split(","):
            for p in model.parameters():
                p.grad = None
            opt = build_optimizer(cfg, model.parameters(), cfg.lr)
            state = steps.init_train_state(model, opt, device="cuda")
            step = steps.make_train_step(cfg, model, opt, crop=512, device="cuda")

            def one():
                step(state, images, masks, steps.step_generator(cfg, state.step, "cuda"))

            times = [_events_ms(one) for _ in range(12)][2:]
            out["train_step_ms"][name] = statistics.median(times)
        del model, opt
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
