#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``xview2_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py            # build, check, time, drive the eval and train CLIs
    python3 chip_smoke.py --profile  # also print per-kernel profiles of the eval and train steps

Phases, each of which fails the script (non-zero exit, no result line):

1. the card's name and power limit (``nvidia-smi``) and the versions;
2. build every CUDA kernel of the port from ``xview2_tpu_torch/csrc``, one
   ``nvcc`` per source in parallel;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the eval path and the train path give it, and time the kernel, the
   plain version and one PyTorch library call computing the same function
   (the yardstick; the port never calls it); for K2, K3, K4 and K5 also name
   the kernel variant each shape takes (the dispatch inside the C entry
   point), failing if a path shape misses the redesigned kernel, with the
   TFLOP/s of the convolutions; hold ragged and half-tile shapes, K2's
   ``out``, K5's ``dx`` and K7's ``out`` EQUAL between two runs, the prologue
   inside K2 and K4 and the epilogue of K5 EQUAL to the plain ones, K8's dW
   EQUAL between two runs; K1 and K6 with the host time of one call beside
   ``clone`` (K1 on both of its paths byte for byte); K1, K3, K6, K7 and K8
   also by the profiler's device time (K1 and K6 also L2-cold, beside
   ``clone``);
4. the eval main path: a synthetic holdout of 8 tiles of 1024^2, a ResNet-50
   UNetLoc made from a fixed seed saved as a port checkpoint, and
   ``xview2_tpu_torch.main.main([... --exec_mode eval ...])`` with 4-flip TTA
   and the fused decoder tail, with every launch counter set to 0 just
   before and read just after; then the eval step's steady-state rate and
   peak memory, and the fused path against the stock (cuDNN) path;
5. the train main path: a synthetic train split of 32 tiles of 1024^2 and a
   small validation split, ``main([... --exec_mode train --fused_tail 1
   --batch_size 16 --epochs 1 ...])`` with the counters set to 0 just before
   and read just after (two train steps, validation, checkpoints); then the
   train step's steady state, fused tail against stock tail, and a small
   float32 train step on the card against the same step on the CPU;
6. the small-channel conv entry point: ``conv3x3_small`` forward and
   backward at (16, 512, 512, 32) -> 32 in bfloat16 with the counters set to
   0 just before (K7 twice, K8 once), its output and gradients held against
   autograd through the library convolution;
7. the ``--autoaugment`` train main path: ``main([... --exec_mode train
   --autoaugment ...])`` on the same train split with the counters set to 0
   just before and read just after (K6 and K1-K5); the AutoAugment chain on
   the card against the CPU on the same draws at full size; then the
   AutoAugment train step's steady state beside the plain-augmentation step;
8. the damage path, the README's pipeline at the CLI's defaults (ResNeSt-200
   at full width and depth, torch's initializers): A, ``main([--exec_mode
   train --type pre --fused_tail 1 ...])`` at batch 16; B, ``main([...
   --type post --dmg_model siamese --ckpt_pre <A's best> --loss_str
   ohem+dice ...])`` at batch 8 (K2, K4 and K5 twice per step, once per
   branch), its transplant watched (every ``unet.enc_l*`` tensor equal to
   A's); B's eval CLI with TTA and its (4, 1024, 1024) float32 damage dumps
   (classes summing to 1 within 1e-3); each with the counters from 0.  Then
   A's and B's train and eval steps by CUDA events with peak memory (A with
   the fused and the stock tail), and B's float32 eval and train steps on
   the card against the CPU (ResNeSt-50 Siamese, small).  Phase 3 also holds
   K1 at n = 4 and K3 at the Siamese head's C = 256, Co = 16 against their
   plain versions;
9. the damage variants path (reusing A's best checkpoint): configuration C,
   ``main([... --type post --dmg_model fused --loss_str coral --ckpt_pre <A's
   best> ...])`` at batch 8 (ResNeSt-200 at full width and depth; K2, K4 and
   K5 14 times per step: both branches' tails and the packed cross-fusion;
   K3 at C = 256, Co = 4), its transplant watched (every
   ``enc_fusion_i.pre_layer``/``.post_layer`` tensor equal to A's
   ``unet.enc_l{i+1}``), then its eval CLI with TTA and its (1024, 1024)
   float32 CORAL class dumps; C's train step (fused and stock tail) and eval
   step (fused against stock) by CUDA events; one train and one eval step of
   each of the six other variants and of ``cat`` with the MSE head (ResNet-50,
   2 pairs of 256^2); the fused variant's float32 train step on the card
   against the CPU; the --autoaugment chain on pairs against the CPU.  Phase
   3 also holds K1 at n = 3 and 1, K3 at Co = 4 (C = 256 and 128), K2, K4 and
   K5 at the cross-fusion's C = 256 -> 128, and K6 on 7-channel pairs;
10. the decoder options path: configuration D (BASELINE config 2),
   ``main([... --type pre --encoder resnest50 --attention --deep_supervision
   --autoaugment --fused_tail 1 ...])`` at batch 16 (K1 eight times a step:
   both label views, the three outputs [out, ds4, ds3] and their
   cotangents; K2, K4 and K5 six times; K3 once; K6), then its eval CLI
   with TTA on the 1024^2 holdout and its dumps, each with the counters from
   0; D's train (fused and stock tail) and eval steps (fused against stock)
   by CUDA events, its train-mode outputs finite, its float32 eval and train
   steps against the CPU; then one train and one TTA eval step each of
   ``--ppm``, ``--aspp --dilation 2``, ``--dec_interp``, ``--interpolate``
   (512^2 crops; its eval CLI too, dumps (1024, 1024)), ``parallelEnc
   --ppm --deep_supervision`` with CORAL and ``fused --dec_interp
   --attention --deep_supervision`` (ResNet-50, 2 tiles or pairs), each with
   its float32 eval step against the CPU.  Configuration C of phase 9 runs
   with ``--ppm``, config 4 as written (its tree held equal without it).
   Phase 3 also holds K1 at D's eight train launches;
11. the recipe and score path: A from ``--pretrained_enc`` (a ResNeSt-200
   release state dict drawn from a seed, converted by the port's converter;
   ``main([... --exec_mode train --pretrained_enc ...])`` at batch 16 with
   every grafted tensor held EQUAL to the ``.npz`` and the counters from 0),
   then A's eval CLI; the ResNet-50 train step (batch 16, fused tail) under
   each of the five other optimizers and each ``--remat`` mode (K2/K4/K5
   launches a step, peak memory), each optimizer's float32 update on the
   card against the CPU's, C under ``--remat full``, the running statistics
   after one float32 step under each mode against the step without remat
   (and the recomputed K2 EQUAL to the first forward's); ``--fold_eval_bn
   0`` against the fold on the ResNet-50 and D eval steps (bfloat16 and
   float32); the offline chain on the card's own dumps: A's localization
   with B's and with C's damage dumps through ``post_process`` (plain and
   ``--components --dilate``) and the scorer, printing the score JSON, and
   ``convert2png`` on label JSONs replaying the holdout's draws, equal to
   the eval's target PNGs;
12. the data parallel path (``--gpus N``, one process per GPU): two ranks
   on the one card over gloo (which carries the card's tensors through the
   host; NCCL refuses two ranks on one device), the ResNet-50 UNetLoc at
   full width, 512^2 crops of 1024^2 tiles, fused tail, global batch 16 = 2
   x 8, against the one-process batch-16 step on the same generator: float32
   within the float32 gates (loss 1e-4, gradients 5e-2 relative L2), bf16
   parameters and buffers bit-equal across the ranks after two steps, K2, K4
   and K5 six times per rank per step, collectives counted, the gloo step and
   its gradient all-reduce timed (not a scaling number); then the production
   NCCL path as a group of one rank (``torchrun``'s environment with
   ``WORLD_SIZE=1``): the train and eval CLIs (collectives counted, the
   checkpoint finite, moved and reloading, the metrics against the runs
   without a group) with the counters from 0, and the train step under the
   group against the plain one by CUDA events, in turns, with peak memory;
13. one JSON line listing every kernel, then the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TILE = 1024
N_TILES = 8
VAL_BATCH = 4
TRAIN_TILES = 32   # two steps at batch 16
TRAIN_BATCH = 16
TRAIN_VAL_TILES = 4
CROP = 512
DMG_A_BATCH = 16   # configuration A: ResNeSt-200 UNetLoc, the CLI's defaults
DMG_BATCH = 8      # configuration B: ResNeSt-200 Siamese, BASELINE's batch for the pair
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor core bf16; f32 without TF32


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of the kernels ``fn`` launches, by
    torch.profiler: the card's own time for the work, without the host's
    share, which for a call of 0.1 ms can be as large as the kernel (the
    host of a one-card machine is shared)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no kernel: profile again
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if kernels:
            return sum(e.self_device_time_total for e in kernels) / iters / 1e3
        log("the profiler saw no device time; profiling again")
    raise AssertionError("the profiler saw no device time in three sessions")


def bound_ms(nbytes: float, flops: float, dtype: str):
    """Least time for the work: max of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- kernels

def host_us(pieces: dict, calls: int) -> dict:
    """Host microseconds per call of each function in ``pieces``, by
    ``time.perf_counter`` over ``calls`` calls after one warm-up call, the
    card synchronised before and after each run."""
    import torch

    us = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return us


def relayout_host_breakdown(calls: int = 1000) -> dict:
    """Host microseconds of one ``relayout_cuda`` call beside ``clone``, and
    of its ctypes call without a launch (0 bytes) and with one, each by
    ``time.perf_counter`` over ``calls`` calls with the card otherwise idle,
    on a 4 KB tensor (the host's share does not depend on the size, and the
    card keeps up with the launches)."""
    import torch

    from xview2_tpu_torch.ops import cuda_build, layout

    x = torch.zeros(1024, device="cuda")
    out = torch.empty_like(x)
    flat = cuda_build.function("relayout", "relayout_flat", layout._FLAT_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    us = host_us({
        "ctypes_call_no_launch": lambda: flat(x.data_ptr(), out.data_ptr(), 0, stream),
        "ctypes_call_and_launch": lambda: flat(x.data_ptr(), out.data_ptr(), 4096, stream),
        "relayout_cuda": lambda: layout.relayout_cuda(x),
        "clone": lambda: x.clone(),
    }, calls)
    us["launch"] = us["ctypes_call_and_launch"] - us["ctypes_call_no_launch"]
    log("K1 host time per call (us, perf_counter over "
        f"{calls} calls of a 4 KB tensor): " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
    return us


def cold_copies(x, factor: int = 3) -> list:
    """``x`` and copies of it, together more than ``factor`` times the
    card's L2, for ``cold_device_ms``."""
    import torch

    l2 = getattr(torch.cuda.get_device_properties(x.device), "L2_cache_size", 0) or 50 << 20
    n = factor * l2 // (x.numel() * x.element_size()) + 2
    return [x] + [x.clone() for _ in range(n - 1)]


def cold_device_ms(fn, xs: list, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn(x)``, the L2 holding neither its
    source nor its output: the sources are taken in turn from ``xs``
    (``cold_copies``), every output is kept until the end so that each call
    writes fresh memory, and the calls are queued behind a sleep kernel so
    that they run back to back (CUDA events; no host gap in which the L2
    could write the last call's output back unseen)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for timed in (False, True):  # the first pass fills the allocator's cache
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000 + 200_000 * iters)  # about 1 ms + 0.1 ms a call
        start.record()
        outs = [fn(xs[i % len(xs)]) for i in range(iters)]
        end.record()
        torch.cuda.synchronize()
        del outs
    return start.elapsed_time(end) / iters


def check_relayout():
    """K1 on both of its paths at the eval logits' size, bit-exact in f32
    and bf16; timed on the contiguous logits (every call of the main paths
    is handed a contiguous tensor: the eval row), on an NCHW buffer viewed
    NHWC (``permuted_*`` keys, the strided path), and on the train step's
    three tensors (``train_*`` keys); by CUDA events, and by the profiler's
    device time of the call's kernels on one tensor called again and again
    (``device_ms``: a train tensor and its copy, 33.5 MB, then stay in the
    50 MB L2), and L2-cold on the contiguous and train rows
    (``cold_device_ms``, the one to hold against the HBM bound)."""
    import torch

    from xview2_tpu_torch.ops import layout

    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (VAL_BATCH, TILE, TILE, 2)
    x_c = torch.randn(shape, generator=gen, device="cuda")
    x_p = torch.randn((VAL_BATCH, 2, TILE, TILE), generator=gen, device="cuda").permute(0, 2, 3, 1)
    for dt in (torch.float32, torch.bfloat16):
        c, p = x_c.to(dt), x_p.to(dt).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        views = {"contiguous": (c, layout.FLAT), "misaligned": (c.view(-1)[1:], layout.FLAT),
                 "inner": (c[:, 1:-1], layout.STRIDED), "permuted": (p, layout.STRIDED),
                 "general": (p[:, ::2, ::2], layout.STRIDED)}
        for tag, (v, path) in views.items():
            plan = layout.relayout_plan(v.shape, v.stride())
            if plan[0] != path:
                raise AssertionError(f"relayout {tag} {dt}: path {plan[0]}, expected {path}")
            got = layout.relayout_cuda(v)
            torch.cuda.synchronize()
            if not (got.is_contiguous() and torch.equal(got.view(torch.uint8),
                                                         v.contiguous().view(torch.uint8))):
                raise AssertionError(f"relayout {tag} {dt}: not a bit-exact contiguous copy")
        del c, p, views
    log(f"K1 relayout {shape} f32 and bf16: bit-exact (tolerance 0) on both paths "
        "(contiguous and one element off its start: flat; [:, 1:-1], an NCHW buffer viewed "
        "NHWC and that view at [:, ::2, ::2]: strided)")
    rows = {}
    for tag, x in (("contiguous", x_c), ("permuted", x_p)):
        lib_fn = (lambda: x.clone()) if tag == "contiguous" else (lambda: x.contiguous())
        nbytes = 2 * x.numel() * x.element_size()
        b, by = bound_ms(nbytes, 0.0, "float32")
        r = dict(max_abs_err=0.0, ms=cuda_ms(lambda: layout.relayout_cuda(x), 20),
                 plain_ms=cuda_ms(lambda: layout.relayout_reference(x), 20),
                 library_ms=cuda_ms(lib_fn, 20), bound_ms=b, bound_by=by,
                 device_ms=device_ms(lambda: layout.relayout_cuda(x), 20),
                 library_device_ms=device_ms(lib_fn, 20))
        cold = ""
        if tag == "contiguous":
            xs = cold_copies(x)
            r["cold_device_ms"] = cold_device_ms(layout.relayout_cuda, xs)
            r["cold_library_device_ms"] = cold_device_ms(lambda t: t.clone(), xs)
            del xs
            cold = (f"; L2-cold device time {r['cold_device_ms']:.4f} ms, clone "
                    f"{r['cold_library_device_ms']:.4f} ms: "
                    f"{100 * b / r['cold_device_ms']:.0f}% of the bound")
        log(f"K1 relayout {tag} {tuple(x.shape)} f32: kernel {r['ms']:.4f} ms (device time "
            f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
            f"({'clone' if tag == 'contiguous' else '.contiguous()'}) {r['library_ms']:.4f} ms "
            f"(device time {r['library_device_ms']:.4f}), bound {b:.4f} ms ({by}): "
            f"{100 * b / r['device_ms']:.0f}% of the bound by device time{cold}")
        rows[tag] = r
    # the train step's three launches: the int32 labels and the bf16 logits
    # in the packed loss view, and the logits' cotangent (same shape and type),
    # each contiguous as the step hands it over
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, device_ms=0.0,
                 library_device_ms=0.0, cold_device_ms=0.0, cold_library_device_ms=0.0)
    lab = torch.randint(0, 2, (TRAIN_BATCH, CROP // 2, 2 * CROP), generator=gen, device="cuda",
                        dtype=torch.int32)
    logit = torch.randn((TRAIN_BATCH, CROP // 2, 2 * CROP, 2), generator=gen,
                        device="cuda").to(torch.bfloat16)
    warm_share, cold_share = [], []
    for x, count in ((lab, 1), (logit, 2)):
        got = layout.relayout_cuda(x)
        torch.cuda.synchronize()
        if not torch.equal(got, x):
            raise AssertionError(f"relayout {tuple(x.shape)} {x.dtype}: not bit-exact")
        b = bound_ms(2 * x.numel() * x.element_size(), 0.0, "float32")[0]
        dev = device_ms(lambda: layout.relayout_cuda(x), 20)
        xs = cold_copies(x)
        dev_cold = cold_device_ms(layout.relayout_cuda, xs)
        total["cold_library_device_ms"] += count * cold_device_ms(lambda t: t.clone(), xs)
        del xs
        warm_share.append(b / dev)
        cold_share.append(b / dev_cold)
        total["ms"] += count * cuda_ms(lambda: layout.relayout_cuda(x), 20)
        total["plain_ms"] += count * cuda_ms(lambda: layout.relayout_reference(x), 20)
        total["library_ms"] += count * cuda_ms(lambda: x.clone(), 20)
        total["bound_ms"] += count * b
        total["device_ms"] += count * dev
        total["cold_device_ms"] += count * dev_cold
        total["library_device_ms"] += count * device_ms(lambda: x.clone(), 20)
    log(f"K1 relayout per train step (3 launches: labels {tuple(lab.shape)} int32, logits and "
        f"cotangent {tuple(logit.shape)} bf16): bit-exact, kernel {total['ms']:.4f} ms (device "
        f"time {total['device_ms']:.4f}, L2-cold {total['cold_device_ms']:.4f}), plain "
        f"{total['plain_ms']:.4f} ms, library (clone) {total['library_ms']:.4f} ms (device time "
        f"{total['library_device_ms']:.4f}, L2-cold {total['cold_library_device_ms']:.4f}): "
        f"{total['ms'] / total['library_ms']:.2f}x clone by the events; bound "
        f"{total['bound_ms']:.4f} ms (bytes); each launch (labels, logits) at "
        f"{', '.join(f'{100 * s:.0f}%' for s in cold_share)} of its bound by L2-cold device "
        f"time ({', '.join(f'{100 * s:.0f}%' for s in warm_share)} with its source in the L2)")
    host = relayout_host_breakdown()
    return dict(rows["contiguous"], **{f"permuted_{k}": v for k, v in rows["permuted"].items()
                                       if k != "max_abs_err"},
                **{f"train_{k}": v for k, v in total.items()},
                **{f"host_us_{k}": v for k, v in host.items()})


# (name, B, H, W, C, Co): the six fused convs of one train step at batch 16
# on 512^2 crops; K4 and K5 run once behind each of them
TRAIN_PATH = [
    ("dec_l2.conv1", 16, 64, 64, 768, 256), ("dec_l2.conv2", 16, 64, 64, 256, 256),
    ("dec_l3.conv1", 16, 128, 128, 384, 128), ("dec_l3.conv2", 16, 128, 128, 128, 128),
    ("dec_l5.conv1", 16, 256, 256, 128, 128), ("dec_l5.conv2", 16, 256, 256, 128, 128),
]

# (B, H, W, C, Co) beside the path: W = 64 (a 4 x 64 tile, one strip of the
# weight gradient), a W that is no multiple of any tile width, an H that is no
# multiple of the rows per block, C = 768 with Co = 256, a W below the
# narrowest tile, and shapes that the dispatch hands to the earlier tiles
RAGGED = [(2, 64, 64, 768, 256), (3, 37, 200, 128, 256), (2, 13, 70, 256, 128),
          (2, 9, 7, 64, 128), (1, 5, 97, 192, 128), (1, 24, 136, 384, 192), (2, 9, 7, 32, 64)]

# (name, B, H, W, C, Co): the six fused convs of one eval step at
# --val_batch_size 4 with 4-flip TTA (16 images of 1024^2)
K2_PATH = [
    ("dec_l2.conv1", 16, 128, 128, 768, 256), ("dec_l2.conv2", 16, 128, 128, 256, 256),
    ("dec_l3.conv1", 16, 256, 256, 384, 128), ("dec_l3.conv2", 16, 256, 256, 128, 128),
    ("dec_l5.conv1", 16, 512, 512, 128, 128), ("dec_l5.conv2", 16, 512, 512, 128, 128),
]


def _k2_case(b, h, w, c, co, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, c, co), generator=gen, device="cuda") / math.sqrt(9 * c)).to(dtype)
    fold = (torch.randn(c, generator=gen, device="cuda") * 0.5,
            torch.rand(c, generator=gen, device="cuda") + 0.5,
            torch.randn(c, generator=gen, device="cuda") * 0.5)
    return x, k, fold


def _compare_conv(got, want, tag):
    """out: within one rounding of the output dtype plus 1e-3 of the scale
    (the f32 sums run in another order); s1 within 1e-3 of sum|out|; s2 at
    rtol 1e-3."""
    import torch

    out_k, s1_k, s2_k = got
    out_p, s1_p, s2_p = want
    ok, pk = out_k.float(), out_p.float()
    eps = torch.finfo(out_p.dtype).eps
    scale = pk.abs().max().item()
    err = (ok - pk).abs()
    tol = 2 * eps * pk.abs() + 1e-3 * scale
    if not bool((err <= tol).all()):
        raise AssertionError(f"{tag}: out disagrees, max abs err {err.max().item():.4g}")
    abs_sum = pk.abs().sum(dim=(0, 1, 2))
    e1 = (s1_k - s1_p).abs()
    if not bool((e1 <= 1e-3 * abs_sum + 1e-3).all()):
        raise AssertionError(f"{tag}: s1 disagrees, max abs err {e1.max().item():.4g}")
    e2 = (s2_k - s2_p).abs()
    if not bool((e2 <= 1e-3 * s2_p.abs() + 1e-3).all()):
        raise AssertionError(f"{tag}: s2 disagrees, max abs err {e2.max().item():.4g}")
    max_rel = (err / pk.abs().clamp_min(1e-3 * scale)).max().item()
    return err.max().item(), max_rel


def check_conv_bn_fused():
    import torch
    import torch.nn.functional as F

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    def run_path(path, tag, seed0):
        """Both fold variants of every layer against the plain version, then
        the path's variant timed; returns the sums over the path."""
        total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        bound_by = set()
        for i, (name, b, h, w, c, co) in enumerate(path):
            x, k, fold = _k2_case(b, h, w, c, co, torch.bfloat16, seed=seed0 + i)
            has_fold = name.endswith("conv2")  # the path: conv1 takes the input as it is
            f = fold if has_fold else None
            for hf in (True, False):
                got = pfc.conv_bn_fused(x, k, fold, hf)
                want = pfc.reference_conv_bn(x, k, fold if hf else None)
                torch.cuda.synchronize()
                err, rel = _compare_conv(got, want, f"{tag} {name} fold={hf}")
                total["max_abs_err"] = max(total["max_abs_err"], err)
                log(f"K2 {tag} {name} {(b, h, w, c)}->{co} bf16 fold={hf}: max abs err "
                    f"{err:.4g}, max rel err {rel:.4g}, tolerance 2*eps*|out| + 1e-3*max|out|")
            a = pfc.prologue(x, f)
            kc = k.permute(3, 2, 0, 1).contiguous()
            ms = cuda_ms(lambda: pfc.conv_bn_fused(x, k, fold, has_fold), 10)
            plain = cuda_ms(lambda: pfc.reference_conv_bn(x, k, f), 3)
            lib = cuda_ms(lambda: F.conv2d(a.permute(0, 3, 1, 2), kc, padding=1), 10)
            flops = 2.0 * b * h * w * 9 * c * co
            nbytes = (b * h * w * (c + co) + 9 * c * co) * 2 + (3 * c + 2 * co) * 4
            bnd, by = bound_ms(nbytes, flops, "bfloat16")
            bound_by.add(by)
            variant = pfc.kernel_variant("conv_bn_fused", h, w, c, co, torch.bfloat16)
            if "pipelined" not in variant:
                raise AssertionError(f"K2 {tag} {name}: the path shape took '{variant}'")
            log(f"K2 {tag} {name} timing [{variant}]: kernel {ms:.3f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.3f} ms, library (cuDNN conv) "
                f"{lib:.3f} ms, bound {bnd:.3f} ms ({by})")
            total["ms"] += ms
            total["plain_ms"] += plain
            total["library_ms"] += lib
            total["bound_ms"] += bnd
            del x, a, k, fold
        total["bound_by"] = "operations" if "operations" in bound_by else "bytes"
        log(f"K2 per {tag} step (6 launches): kernel {total['ms']:.3f} ms, plain "
            f"{total['plain_ms']:.3f} ms, library {total['library_ms']:.3f} ms, bound "
            f"{total['bound_ms']:.3f} ms")
        return total

    total = run_path(K2_PATH, "eval", 10)
    train = run_path(TRAIN_PATH, "train", 50)
    total["max_abs_err"] = max(total["max_abs_err"], train.pop("max_abs_err"))
    total.update({f"train_{k}": v for k, v in train.items() if k != "bound_by"})
    # ragged and half-tile shapes of the pipelined kernel, fold on and off, and
    # out EQUAL between two runs on the same input (no atomics touch it)
    for i, (b, h, w, c, co) in enumerate(RAGGED):
        x, k, fold = _k2_case(b, h, w, c, co, torch.bfloat16, seed=110 + i)
        variant = pfc.kernel_variant("conv_bn_fused", h, w, c, co, torch.bfloat16)
        for hf in (True, False):
            got = pfc.conv_bn_fused(x, k, fold, hf)
            again = pfc.conv_bn_fused(x, k, fold, hf)
            want = pfc.reference_conv_bn(x, k, fold if hf else None)
            torch.cuda.synchronize()
            err, rel = _compare_conv(got, want, f"K2 ragged {(b, h, w, c, co)} fold={hf}")
            if not torch.equal(got[0], again[0]):
                raise AssertionError(f"K2 {(b, h, w, c, co)} fold={hf}: out differs between "
                                     "two runs on the same input")
            total["max_abs_err"] = max(total["max_abs_err"], err)
            log(f"K2 ragged {(b, h, w, c)}->{co} bf16 fold={hf} [{variant}]: max abs err "
                f"{err:.4g}, max rel err {rel:.4g}; out bit-equal between two runs")
        del x, k, fold
    # one float32 case (--precision 32): the FMA kernel, no TF32
    x, k, fold = _k2_case(4, 256, 256, 128, 128, torch.float32, seed=30)
    with pfc.full_precision():
        got = pfc.conv_bn_fused(x, k, fold, True)
        want = pfc.reference_conv_bn(x, k, fold)
        torch.cuda.synchronize()
        err, rel = _compare_conv(got, want, "f32 case")
        ms = cuda_ms(lambda: pfc.conv_bn_fused(x, k, fold, True), 3)
        plain = cuda_ms(lambda: pfc.reference_conv_bn(x, k, fold), 3)
    log(f"K2 f32 (4, 256, 256, 128)->128 fold=True: max abs err {err:.4g}, max rel err "
        f"{rel:.4g}, kernel {ms:.3f} ms, plain {plain:.3f} ms (TF32 off)")
    return total


def check_prologue_bit_equal():
    """The prologue inside the pipelined K2 and K4 (packed bf16 arithmetic on
    the landed stage) against the plain one, EQUAL (tolerance 0): an identity
    centre tap makes K2's out the activated map itself, and a cotangent that
    is 1 at one pixel makes K4's dW the activated 3x3 neighbourhood of that
    pixel, zero in the SAME halo.  Inputs span 12 binades."""
    import torch

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    b, h, w, c = 2, 70, 200, 128
    gen = torch.Generator(device="cuda").manual_seed(140)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda")
    x = (x * torch.exp2(torch.randint(-6, 6, x.shape, generator=gen, device="cuda").float()))
    x = x.to(torch.bfloat16)
    _, _, fold = _k2_case(1, 1, 1, c, c, torch.bfloat16, seed=141)
    a = pfc.prologue(x, fold)
    k = torch.zeros((3, 3, c, c), device="cuda", dtype=torch.bfloat16)
    k[1, 1, torch.arange(c), torch.arange(c)] = 1
    out, _, _ = pfc.conv_bn_fused(x, k, fold, True)
    if not torch.equal(out, a):
        raise AssertionError("K2: the prologue inside the kernel is not bit-equal to the plain one")
    for y0, x0 in ((0, 0), (h - 1, w - 1), (h // 2, 63), (h // 2, 64)):
        g = torch.zeros((b, h, w, c), device="cuda", dtype=torch.bfloat16)
        g[1, y0, x0] = 1
        dw = pfc.conv_bn_wgrad(x, g, fold, True).reshape(3, 3, c, c)
        want = torch.nn.functional.pad(a[1].float(), (0, 0, 1, 1, 1, 1))[y0:y0 + 3, x0:x0 + 3]
        if not torch.equal(dw, want[..., None].expand(3, 3, c, c)):
            raise AssertionError(f"K4: the prologue inside the kernel is not bit-equal to the "
                                 f"plain one around pixel {(y0, x0)}")
    log(f"K2/K4 prologue inside the pipelined kernels vs the plain prologue at {(b, h, w, c)} "
        f"bf16 (identity centre tap; one-pixel cotangent at 4 places): bit-equal (tolerance 0)")


def check_dgrad_epilogue_bit_equal():
    """K5's epilogue (the gate, the scale by the unrounded mul and the
    roundings, on bf16 pairs) against the plain version, EQUAL (tolerance
    0): a flipped kernel that is the identity at its centre tap makes da = g
    exactly in both, so dx must agree bit for bit.  Inputs span 12 binades."""
    import torch

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    b, h, w, c = 2, 70, 200, 128
    gen = torch.Generator(device="cuda").manual_seed(142)

    def wide():
        t = torch.randn((b, h, w, c), generator=gen, device="cuda")
        e = torch.randint(-6, 6, t.shape, generator=gen, device="cuda").float()
        return (t * torch.exp2(e)).to(torch.bfloat16)

    x, g = wide(), wide()
    _, _, fold = _k2_case(1, 1, 1, c, c, torch.bfloat16, seed=143)
    kf = torch.zeros((9 * c, c), device="cuda", dtype=torch.bfloat16)
    kf[4 * c + torch.arange(c), torch.arange(c)] = 1
    variant = pfc.kernel_variant("conv_bn_dgrad", h, w, c, c, torch.bfloat16)
    dx, _, _ = pfc.conv_bn_dgrad(g, kf, x, fold, True)
    want, _, _ = pfc.reference_dgrad(g, kf, x, fold)
    if "pipelined" not in variant or not torch.equal(dx, want):
        raise AssertionError(f"K5 [{variant}]: the epilogue is not bit-equal to the plain one")
    log(f"K5 epilogue inside the pipelined kernel [{variant}] vs the plain version at "
        f"{(b, h, w, c)} bf16 (identity centre tap of the flipped kernel): dx bit-equal "
        f"(tolerance 0)")


def bwd_case(b, h, w, c, co, dtype, seed):
    """(x, g, kernel, fold) on the card for K4/K5 at (b, h, w, c) -> co."""
    import torch

    x, k, fold = _k2_case(b, h, w, c, co, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    g = torch.randn((b, h, w, co), generator=gen, device="cuda").to(dtype)
    return x, g, k, fold


def _compare_wgrad(got, want, tag):
    """dW stays float32 in the kernel and in the plain version: they differ
    by the f32 order of the sums only (the pixels split over blocks and
    their partials added in another order; with atomics that order also
    changes from run to run): 1e-3 of max |dW|."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not err <= 1e-3 * scale:
        raise AssertionError(f"{tag}: dW disagrees, max abs err {err:.4g} of {scale:.4g}")
    return err, err / scale


def _compare_dgrad(got, want, tag):
    """dx within one rounding of its dtype plus 1e-3 of the scale; the fold
    sums within 1e-3 * max(1, max |sum|) (f32 sums of up to a million terms
    in another order, with atomics whose order changes from run to run)."""
    import torch

    dx, db, dm = got
    rx, rb, rm = want
    eps = torch.finfo(rx.dtype).eps
    rf = rx.float()
    scale = rf.abs().max().item()
    err = (dx.float() - rf).abs()
    if not bool((err <= 2 * eps * rf.abs() + 1e-3 * scale).all()):
        raise AssertionError(f"{tag}: dx disagrees, max abs err {err.max().item():.4g}")
    for name, a, r in (("dbias", db, rb), ("dmul", dm, rm)):
        e = (a - r).abs().max().item()
        if not e <= 1e-3 * max(1.0, r.abs().max().item()):
            raise AssertionError(f"{tag}: {name} disagrees, max abs err {e:.4g} of "
                                 f"{r.abs().max().item():.4g}")
    return err.max().item()


def check_conv_bn_backward():
    """K4 (wgrad) and K5 (dgrad) at the six train-path shapes, fold on and
    off, against their plain versions; times beside the plain version, one
    library call each (``torch.nn.grad.conv2d_weight`` / ``conv2d_input`` on
    the already activated bf16 input) and the bound."""
    import torch

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")
    rows = {"conv_bn_wgrad": dict.fromkeys(keys, 0.0), "conv_bn_dgrad": dict.fromkeys(keys, 0.0)}
    bound_by = {"conv_bn_wgrad": set(), "conv_bn_dgrad": set()}
    for i, (name, b, h, w, c, co) in enumerate(TRAIN_PATH):
        x, g, k, fold = bwd_case(b, h, w, c, co, torch.bfloat16, seed=70 + i)
        kf = pfc.flip_kernel(k)
        has_fold = name.endswith("conv2")  # the path: conv1 takes the input as it is
        for hf in (True, False):
            f = fold if hf else None
            e4, r4 = _compare_wgrad(pfc.conv_bn_wgrad(x, g, fold, hf),
                                    pfc.reference_wgrad(x, g, f), f"K4 {name} fold={hf}")
            e5 = _compare_dgrad(pfc.conv_bn_dgrad(g, kf, x, fold, hf),
                                pfc.reference_dgrad(g, kf, x, f), f"K5 {name} fold={hf}")
            torch.cuda.synchronize()
            rows["conv_bn_wgrad"]["max_abs_err"] = max(rows["conv_bn_wgrad"]["max_abs_err"], e4)
            rows["conv_bn_dgrad"]["max_abs_err"] = max(rows["conv_bn_dgrad"]["max_abs_err"], e5)
            log(f"K4/K5 {name} {(b, h, w, c)}->{co} bf16 fold={hf}: dW max abs err {e4:.4g} "
                f"({r4:.3g} of max|dW|, tolerance 1e-3), dx max abs err {e5:.4g} (tolerance "
                f"2*eps*|dx| + 1e-3*max|dx|)")
        f = fold if has_fold else None
        a = pfc.prologue(x, f).permute(0, 3, 1, 2)
        gc = g.permute(0, 3, 1, 2)
        kc = k.permute(3, 2, 0, 1).contiguous()
        flops = 2.0 * b * h * w * 9 * c * co
        act = b * h * w * (c + co) * 2
        times = {
            "conv_bn_wgrad": (
                cuda_ms(lambda: pfc.conv_bn_wgrad(x, g, fold, has_fold), 10),
                cuda_ms(lambda: pfc.reference_wgrad(x, g, f), 2),
                cuda_ms(lambda: torch.nn.grad.conv2d_weight(a, kc.shape, gc, padding=1), 10),
                bound_ms(act + 9 * c * co * 4 + 3 * c * 4, flops, "bfloat16")),
            "conv_bn_dgrad": (
                cuda_ms(lambda: pfc.conv_bn_dgrad(g, kf, x, fold, has_fold), 10),
                cuda_ms(lambda: pfc.reference_dgrad(g, kf, x, f), 2),
                cuda_ms(lambda: torch.nn.grad.conv2d_input(a.shape, kc, gc, padding=1), 10),
                bound_ms(act + (b * h * w * c + 9 * c * co) * 2 + 5 * c * 4, flops, "bfloat16")),
        }
        variants = {kern: pfc.kernel_variant(kern, h, w, c, co, torch.bfloat16) for kern in times}
        for kern, variant in variants.items():
            if "pipelined" not in variant:
                raise AssertionError(f"{kern} {name}: the path shape took '{variant}'")
        for kern, (ms, plain, lib, (bnd, by)) in times.items():
            r = rows[kern]
            r["ms"] += ms
            r["plain_ms"] += plain
            r["library_ms"] += lib
            r["bound_ms"] += bnd
            bound_by[kern].add(by)
            log(f"{'K4' if kern.endswith('wgrad') else 'K5'} {name} fold={has_fold} timing "
                f"[{variants[kern]}]: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                f"{plain:.3f} ms, library (cuDNN {'wgrad' if kern.endswith('wgrad') else 'dgrad'})"
                f" {lib:.3f} ms, bound {bnd:.3f} ms ({by})")
        other = cuda_ms(lambda: pfc.conv_bn_dgrad(g, kf, x, fold, not has_fold), 10)
        log(f"K5 {name} fold={not has_fold} (not on the path): kernel {other:.3f} ms "
            f"({flops / other / 1e9:.1f} TFLOP/s)")
        del x, g, k, kf, fold, a, gc, kc
        torch.cuda.empty_cache()
    # ragged and half-tile shapes of the pipelined weight and input gradients
    # (and those the dispatch hands to the earlier tiles), fold on and off;
    # K5's dx EQUAL between two runs (no atomics touch it)
    for i, (b, h, w, c, co) in enumerate(RAGGED):
        x, g, k, fold = bwd_case(b, h, w, c, co, torch.bfloat16, seed=130 + i)
        kf = pfc.flip_kernel(k)
        v4 = pfc.kernel_variant("conv_bn_wgrad", h, w, c, co, torch.bfloat16)
        v5 = pfc.kernel_variant("conv_bn_dgrad", h, w, c, co, torch.bfloat16) if c % 64 == 0 \
            else None  # K5 tiles the channels it produces by 64 at least
        for hf in (True, False):
            f = fold if hf else None
            e4, r4 = _compare_wgrad(pfc.conv_bn_wgrad(x, g, fold, hf),
                                    pfc.reference_wgrad(x, g, f),
                                    f"K4 ragged {(b, h, w, c, co)} fold={hf}")
            rows["conv_bn_wgrad"]["max_abs_err"] = max(rows["conv_bn_wgrad"]["max_abs_err"], e4)
            msg = (f"K4 ragged {(b, h, w, c)}->{co} bf16 fold={hf} [{v4}]: dW max abs err "
                   f"{e4:.4g} ({r4:.3g} of max|dW|, tolerance 1e-3)")
            if v5 is not None:
                got = pfc.conv_bn_dgrad(g, kf, x, fold, hf)
                again = pfc.conv_bn_dgrad(g, kf, x, fold, hf)
                e5 = _compare_dgrad(got, pfc.reference_dgrad(g, kf, x, f),
                                    f"K5 ragged {(b, h, w, c, co)} fold={hf}")
                if not torch.equal(got[0], again[0]):
                    raise AssertionError(f"K5 {(b, h, w, c, co)} fold={hf}: dx differs between "
                                         "two runs on the same input")
                rows["conv_bn_dgrad"]["max_abs_err"] = max(rows["conv_bn_dgrad"]["max_abs_err"],
                                                           e5)
                msg += f"; K5 [{v5}]: dx max abs err {e5:.4g}, dx bit-equal between two runs"
            log(msg)
        del x, g, k, kf, fold
    # one float32 case each (--precision 32): the FMA kernels, TF32 off in the
    # plain versions (they turn it off themselves)
    x, g, k, fold = bwd_case(4, 128, 128, 128, 128, torch.float32, seed=90)
    kf = pfc.flip_kernel(k)
    e4, r4 = _compare_wgrad(pfc.conv_bn_wgrad(x, g, fold, True), pfc.reference_wgrad(x, g, fold),
                            "K4 f32 case")
    e5 = _compare_dgrad(pfc.conv_bn_dgrad(g, kf, x, fold, True),
                        pfc.reference_dgrad(g, kf, x, fold), "K5 f32 case")
    ms4 = cuda_ms(lambda: pfc.conv_bn_wgrad(x, g, fold, True), 3)
    ms5 = cuda_ms(lambda: pfc.conv_bn_dgrad(g, kf, x, fold, True), 3)
    p4 = cuda_ms(lambda: pfc.reference_wgrad(x, g, fold), 3)
    p5 = cuda_ms(lambda: pfc.reference_dgrad(g, kf, x, fold), 3)
    log(f"K4/K5 f32 (4, 128, 128, 128)->128 fold=True (TF32 off): dW max abs err {e4:.4g} "
        f"({r4:.3g} of max|dW|), dx max abs err {e5:.4g}; wgrad kernel {ms4:.3f} ms, plain "
        f"{p4:.3f} ms; dgrad kernel {ms5:.3f} ms, plain {p5:.3f} ms")
    for kern, r in rows.items():
        r["bound_by"] = "operations" if "operations" in bound_by[kern] else "bytes"
        log(f"{'K4' if kern.endswith('wgrad') else 'K5'} per train step (6 launches): kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms")
    return rows


# (tag, B, H, W, C, Co): the fused variant's packed cross-fusion, conv_pre and
# conv_post (two launches per step) over the concat of the two branches'
# packed dec_l5 maps (2 x 4 x 32 channels) -> 4 x 32, at configuration C's
# train batch of 512^2 crops and at its eval step (16 images of 1024^2)
FUSION_PATH = [("train", 8, CROP // 2, CROP // 2, 256, 128),
               ("eval", 4 * VAL_BATCH, TILE // 2, TILE // 2, 256, 128)]


def fusion_kernel(seed: int):
    """A packed kernel of the cross-fusion: a fine (3, 3, 64, 32) kernel
    embedded by ``s2d_conv_kernel`` and row-permuted group-major
    (``PackedConvLayer(groups=2)``), in bf16."""
    import torch

    from xview2_tpu_torch.models.layers import group_major_rows, s2d_conv_kernel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((3, 3, 64, 32), generator=gen, device="cuda") / math.sqrt(9 * 64)
    return group_major_rows(s2d_conv_kernel(w), 2).to(torch.bfloat16)


def check_cross_fusion():
    """K2, K4 and K5 at the packed cross-fusion of the fused variant (C = 256
    -> 128 with a group-major kernel): K2 at C's train and eval shapes, K4
    and K5 at the train shape, fold on and off, against their plain versions
    at the tolerances of the other path shapes; the path shapes must take
    the pipelined ``wgmma`` kernels.  Timed (fold on, as on the path: the
    concat carries both branches' folds) beside the plain version, cuDNN's
    conv, wgrad and dgrad on the activated input, and the bound.  Returns
    {kernel: row} with ``fusion_`` keys per eval step (K2) and
    ``fusion_train_`` keys per train step (two launches each)."""
    import torch
    import torch.nn.functional as F

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    rows = {k: {} for k in ("conv_bn_fused", "conv_bn_wgrad", "conv_bn_dgrad")}
    for i, (tag, b, h, w, c, co) in enumerate(FUSION_PATH):
        x, g, _, fold = bwd_case(b, h, w, c, co, torch.bfloat16, seed=150 + i)
        k = fusion_kernel(160 + i)
        kf = pfc.flip_kernel(k)
        a = pfc.prologue(x, fold)
        an, gn = a.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        kc = k.permute(3, 2, 0, 1).contiguous()
        flops = 2.0 * b * h * w * 9 * c * co
        act = b * h * w * (c + co) * 2
        kerns = {"conv_bn_fused": (
            lambda hf: pfc.conv_bn_fused(x, k, fold, hf),
            lambda hf: pfc.reference_conv_bn(x, k, fold if hf else None), _compare_conv,
            lambda: F.conv2d(an, kc, padding=1), "cuDNN conv",
            act + 9 * c * co * 2 + (3 * c + 2 * co) * 4)}
        if tag == "train":
            kerns["conv_bn_wgrad"] = (
                lambda hf: pfc.conv_bn_wgrad(x, g, fold, hf),
                lambda hf: pfc.reference_wgrad(x, g, fold if hf else None),
                lambda got, want, t: _compare_wgrad(got, want, t)[0],
                lambda: torch.nn.grad.conv2d_weight(an, kc.shape, gn, padding=1), "cuDNN wgrad",
                act + 9 * c * co * 4 + 3 * c * 4)
            kerns["conv_bn_dgrad"] = (
                lambda hf: pfc.conv_bn_dgrad(g, kf, x, fold, hf),
                lambda hf: pfc.reference_dgrad(g, kf, x, fold if hf else None), _compare_dgrad,
                lambda: torch.nn.grad.conv2d_input(an.shape, kc, gn, padding=1), "cuDNN dgrad",
                act + (b * h * w * c + 9 * c * co) * 2 + 5 * c * 4)
        for kern, (fn, ref, compare, lib_fn, lib_name, nbytes) in kerns.items():
            short = {"conv_bn_fused": "K2", "conv_bn_wgrad": "K4", "conv_bn_dgrad": "K5"}[kern]
            err = 0.0
            for hf in (True, False):
                got = compare(fn(hf), ref(hf), f"{short} cross-fusion {tag} fold={hf}")
                err = max(err, got[0] if isinstance(got, tuple) else got)
            torch.cuda.synchronize()
            variant = pfc.kernel_variant(kern, h, w, c, co, torch.bfloat16)
            if "pipelined" not in variant:
                raise AssertionError(f"{short} cross-fusion {tag}: the path shape took "
                                     f"'{variant}'")
            ms = cuda_ms(lambda: fn(True), 10)
            plain = cuda_ms(lambda: ref(True), 2)
            lib = cuda_ms(lib_fn, 10)
            bnd, by = bound_ms(nbytes, flops, "bfloat16")
            key = "fusion_" if tag == "eval" else "fusion_train_"
            rows[kern].update({f"{key}max_abs_err": err, f"{key}ms": 2 * ms,
                               f"{key}plain_ms": 2 * plain, f"{key}library_ms": 2 * lib,
                               f"{key}bound_ms": 2 * bnd, f"{key}variant": variant})
            log(f"{short} cross-fusion {tag} {(b, h, w, c)}->{co} bf16 [{variant}]: fold on "
                f"and off within the tolerance of the other path shapes, max abs err "
                f"{err:.4g}; fold=True kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                f"plain {plain:.3f} ms, library ({lib_name}) {lib:.3f} ms, bound {bnd:.3f} ms "
                f"({by}); two launches per step")
        del x, g, k, kf, fold, a, an, gn, kc
        torch.cuda.empty_cache()
    return rows


def head_case(shape, co, seed):
    """(x, kmat, hbias, fold) on the card for K3 at ``shape`` -> co."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    kmat = torch.randn((c, co), generator=gen, device="cuda") / math.sqrt(c)
    hbias = torch.randn(co, generator=gen, device="cuda")
    fold = (torch.randn(c, generator=gen, device="cuda") * 0.5,
            torch.rand(c, generator=gen, device="cuda") + 0.5,
            torch.randn(c, generator=gen, device="cuda") * 0.5)
    return x, kmat, hbias, fold


def _compare_head(x, kmat, hbias, fold, tag):
    """K3 against its plain version, which rounds to bf16 where the kernel
    does (after the GEMM, then after the bias): the two must be EQUAL.
    Returns (max abs err, the kernel variant)."""
    import torch

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    b, h, w, c = x.shape
    co = kmat.shape[1]
    variant = pfc.kernel_variant("head_conv_fused", h, w, c, co, x.dtype)
    got = pfc.head_conv_fused(x, kmat, hbias, fold)
    want = pfc.reference_head(x, kmat, hbias, fold)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"K3 head {tag} {(b, h, w, c)}->{co} [{variant}] is not bit-equal to "
                             f"the plain version: max abs err {err:.4g}")
    return err, variant


def check_head_conv_fused(c: int = 128, cos=(16, 8), train_batch: int = TRAIN_BATCH,
                          pre: str = ""):
    """K3 at the eval shape (the packed dec_l5 map of 16 images of 1024^2)
    and the train shape (``train_batch`` 512^2 crops), at each Co of
    ``cos`` (the path's last), and at a ragged pixel count, bit-equal to the
    plain version; the path shapes must take the mma.sync kernel.  Timed at
    the path's Co beside the plain version, ``torch.matmul`` of the
    activated map and the bound by CUDA events, as every kernel is; the
    kernel and ``matmul`` also by the device time of the kernels a call
    launches (``device_ms``: at the train shape the wrapper's host time is
    of the kernel's order).  C = 128, Co = 8:
    the localization head; C = 256, Co = 16 (``pre="dmg_"``): the Siamese
    head, two packed branches of 128.  Returns the row, keys prefixed with
    ``pre`` (and ``train_`` at the train shape)."""
    import torch

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    row = {f"{pre}max_abs_err": 0.0}
    for tag, shape in (("eval", (16, 512, 512, c)),
                       ("train", (train_batch, CROP // 2, CROP // 2, c)),
                       ("ragged", (1, 37, 53, c))):
        for co in cos:  # the path's Co last: its tensors are timed below
            x, kmat, hbias, fold = head_case(shape, co, seed=40 if tag != "ragged" else 41)
            err, variant = _compare_head(x, kmat, hbias, fold, tag)
            row[f"{pre}max_abs_err"] = max(row[f"{pre}max_abs_err"], err)
            log(f"K3 head {tag} {shape}->{co} bf16 [{variant}]: bit-equal to the plain version")
            if "mma.sync" not in variant:
                raise AssertionError(f"K3 head {tag} {shape}->{co}: the path shape took "
                                     f"'{variant}'")
        row[f"{pre}variant"] = variant
        if tag == "ragged":
            continue
        a = pfc.prologue(x, fold)
        kb = kmat.to(torch.bfloat16)
        ms = cuda_ms(lambda: pfc.head_conv_fused(x, kmat, hbias, fold), 10)
        plain = cuda_ms(lambda: pfc.reference_head(x, kmat, hbias, fold), 10)
        lib = cuda_ms(lambda: torch.matmul(a, kb), 10)
        dev = device_ms(lambda: pfc.head_conv_fused(x, kmat, hbias, fold), 20)
        lib_dev = device_ms(lambda: torch.matmul(a, kb), 20)
        npix = x.numel() // c
        nbytes = x.numel() * 2 + npix * co * 2 + (c * co + co + 3 * c) * 4
        bnd, by = bound_ms(nbytes, 2.0 * npix * c * co, "bfloat16")
        log(f"K3 head {tag} {shape}->{co} timing [{variant}] by CUDA events: kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e9:.3f} TB/s), plain {plain:.3f} ms, library (matmul) {lib:.4f} "
            f"ms, bound {bnd:.4f} ms ({by}); device time of every kernel of a call (profiler): "
            f"kernel {dev:.4f} ms, library (matmul) {lib_dev:.4f} ms")
        key = pre if tag == "eval" else f"{pre}train_"
        row.update({f"{key}ms": ms, f"{key}plain_ms": plain, f"{key}library_ms": lib,
                    f"{key}bound_ms": bnd, f"{key}device_ms": dev,
                    f"{key}library_device_ms": lib_dev})
        if tag == "eval":
            row[f"{pre}bound_by"] = by
        del x, a
        torch.cuda.empty_cache()
    return row


def check_relayout_damage(n: int = 4, pre: str = "dmg_"):
    """K1 at a damage head's ``n`` logits (4 classes; 3 CORAL levels; 1 MSE
    logit): the eval step's logits (VAL_BATCH, 1024, 1024, n) f32, and the
    train step's three launches (labels (DMG_BATCH, 256, 1024) int32, logits
    and cotangent (DMG_BATCH, 256, 1024, n) bf16), bit-exact on the
    contiguous tensor and a transposed view, timed by CUDA events beside the
    plain version, ``clone`` and the bound.  Returns the row with ``pre``
    keys (``{pre}train_`` per train step)."""
    import torch

    from xview2_tpu_torch.ops import layout

    gen = torch.Generator(device="cuda").manual_seed(3)
    k1 = {f"{pre}max_abs_err": 0.0}
    logits = torch.randn((VAL_BATCH, TILE, TILE, n), generator=gen, device="cuda")
    lab = torch.randint(0, 5, (DMG_BATCH, CROP // 2, 2 * CROP), generator=gen, device="cuda",
                        dtype=torch.int32)
    tlog = torch.randn((DMG_BATCH, CROP // 2, 2 * CROP, n), generator=gen,
                       device="cuda").to(torch.bfloat16)
    for tag, tensors in (("eval", ((logits, 1),)), ("train", ((lab, 1), (tlog, 2)))):
        row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for x, count in tensors:
            for v in (x, x.transpose(1, 2)):
                got = layout.relayout_cuda(v)
                torch.cuda.synchronize()
                if not (got.is_contiguous() and torch.equal(got, v)):
                    raise AssertionError(f"K1 at n = {n} {tuple(v.shape)} {v.dtype}: not a "
                                         "bit-exact contiguous copy")
            row["ms"] += count * cuda_ms(lambda: layout.relayout_cuda(x), 20)
            row["plain_ms"] += count * cuda_ms(lambda: layout.relayout_reference(x), 20)
            row["library_ms"] += count * cuda_ms(lambda: x.clone(), 20)
            row["bound_ms"] += count * bound_ms(2 * x.numel() * x.element_size(), 0.0,
                                                "float32")[0]
        shapes = ", ".join(f"{tuple(x.shape)} {str(x.dtype).split('.')[-1]}" for x, _ in tensors)
        log(f"K1 relayout damage n = {n} {tag} ({shapes}; {sum(c for _, c in tensors)} "
            f"launches): bit-exact on the contiguous tensor and a transposed view; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library (clone) "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes)")
        key = pre if tag == "eval" else f"{pre}train_"
        k1.update({key + k: v for k, v in row.items()})
    return k1


# K6 shapes of the --autoaugment train path: a shear of 512^2 crops, and the
# two passes of the three-shear rotation on the map widened to 654 columns
# (the first and third pass shift rows, the second shifts columns)
AA_GROUP = 2    # a typical group: 17% of a batch of 16 draw a spatial op
ROT_WIDTH = CROP + 2 * (int(math.ceil(0.2680 * (CROP - 1) / 2.0)) + 2)


def _row_shift_cases(n, c: int = 4):
    """(tag, x, shift, sel, axis) at the path's shapes and shift patterns, on
    ``c``-channel pixels (4: image and mask; 7: a pre/post pair and mask)."""
    import numpy as np
    import torch

    from xview2_tpu_torch.ops import autoaugment as aa

    gen = torch.Generator(device="cuda").manual_seed(60 + n)

    def image(w):
        return torch.randint(0, 256, (n, CROP, w, c), generator=gen, device="cuda").float()

    rows = torch.arange(CROP, dtype=torch.float32, device="cuda")
    cols = torch.arange(ROT_WIDTH, dtype=torch.float32, device="cuda")
    mags = np.resize(np.array([30.0, -26.666666, 10.0], np.float32), n)
    a, b = (torch.from_numpy(v).cuda() for v in aa.rotate_shear_factors(mags))
    shear = torch.full((n, 1), float(aa._M1[18]), device="cuda") * rows[None, :]
    lerp = torch.ones(n, dtype=torch.int32, device="cuda")
    near = torch.zeros(n, dtype=torch.int32, device="cuda")
    return [
        ("shear", image(CROP), shear, lerp, 2),
        ("rotate row pass", image(ROT_WIDTH), a[:, None] * (rows - (CROP - 1) / 2.0)[None, :],
         near, 2),
        ("rotate column pass", image(ROT_WIDTH),
         b[:, None] * (cols - (ROT_WIDTH - 1) / 2.0)[None, :], near, 1),
    ]


def row_shift_host_breakdown(calls: int = 1000, c: int = 4) -> dict:
    """Host microseconds of one ``row_shift_cuda`` call beside ``clone``, and
    of the ctypes call of the entry point without a launch (an empty map) and
    the launch (a call with one, less that), each by ``time.perf_counter``
    over ``calls`` calls with the card otherwise idle, on a (1, 8, 8, 4) map
    (the host's share does not depend on the size).  The bare calls go
    through a binding of their own: the wrapper's cached one is timed only
    through the wrapper."""
    import ctypes

    import torch

    from xview2_tpu_torch.ops import cuda_build, rowshift

    x = torch.zeros((1, 8, 8, c), device="cuda")
    shift = torch.zeros((1, 8), device="cuda")
    sel = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty_like(x)
    rowshift.row_shift_cuda(x, shift, sel)  # builds and binds the library
    bare = ctypes.CDLL(cuda_build._lib_path("rowshift")).row_shift
    bare.argtypes = list(rowshift._ARGS)
    bare.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), shift.data_ptr(), sel.data_ptr(), out.data_ptr())
    us = host_us({
        "row_shift_cuda": lambda: rowshift.row_shift_cuda(x, shift, sel),
        "ctypes_call": lambda: bare(*args, 0, 8, 8, c, 2, stream),
        "ctypes_call_and_launch": lambda: bare(*args, 1, 8, 8, c, 2, stream),
        "clone": lambda: x.clone(),
    }, calls)
    us["launch"] = us.pop("ctypes_call_and_launch") - us["ctypes_call"]
    log("K6 host time per call (us, perf_counter over "
        f"{calls} calls of a (1, 8, 8, {c}) map): "
        + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
    return us


def check_row_shift():
    """K6 at the three shapes of the --autoaugment path against its plain
    version: EQUAL (tolerance 0).  No PyTorch call computes this function, so
    ``library_ms`` is null; ``clone`` of the same bytes is printed as the
    card's copy rate.  The row sums one step's typical launches: a rotation
    (row, column, row pass) and a shear on a group of AA_GROUP samples, by
    CUDA events and by the profiler's device time.  At the batch of 16 each
    launch is also timed L2-cold beside ``clone`` (``cold_device_ms``;
    ``cold_*`` keys), and the wrapper's host time is broken down
    (``host_us_*`` keys)."""
    import torch

    from xview2_tpu_torch.ops import rowshift

    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
               bound_by="bytes", device_ms=0.0)
    for n in (AA_GROUP, TRAIN_BATCH):
        for tag, x, shift, sel, axis in _row_shift_cases(n):
            got = rowshift.row_shift(x, shift, sel, axis=axis)
            want = rowshift.row_shift_reference(x, shift, sel, axis=axis)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"K6 row_shift {tag} {tuple(x.shape)}: not bit-equal to "
                                     f"the plain version, max abs err {err:.4g}")
            fn = lambda: rowshift.row_shift(x, shift, sel, axis=axis)  # noqa: E731
            ms = cuda_ms(fn, 20)
            dev = device_ms(fn, 20)
            plain = cuda_ms(lambda: rowshift.row_shift_reference(x, shift, sel, axis=axis), 5)
            copy = cuda_ms(lambda: x.clone(), 20)
            bnd, by = bound_ms(2 * x.numel() * 4 + shift.numel() * 4 + sel.numel() * 4, 0.0,
                               "float32")
            cold = ""
            if n == TRAIN_BATCH:
                xs = cold_copies(x)
                key = tag.replace(" ", "_")
                row[f"cold_device_ms_{key}"] = cold_ms = cold_device_ms(
                    lambda t: rowshift.row_shift(t, shift, sel, axis=axis), xs)
                row[f"cold_library_device_ms_{key}"] = cold_copy = cold_device_ms(
                    lambda t: t.clone(), xs)
                row[f"cold_bound_ms_{key}"] = bnd
                del xs
                cold = (f"; L2-cold {cold_ms:.4f} ms ({100 * bnd / cold_ms:.0f}% of the bound), "
                        f"clone L2-cold {cold_copy:.4f} ms ({100 * bnd / cold_copy:.0f}%)")
            log(f"K6 row_shift {tag} {tuple(x.shape)} f32 axis {axis}: bit-equal (tolerance 0), "
                f"kernel {ms:.4f} ms ({2 * x.numel() * 4 / ms / 1e9:.3f} TB/s; device time "
                f"{dev:.4f}), plain {plain:.4f} ms, clone of the same bytes {copy:.4f} ms, bound "
                f"{bnd:.4f} ms ({by}){cold}")
            if n == AA_GROUP:
                times = 2 if tag == "rotate row pass" else 1
                row["ms"] += times * ms
                row["device_ms"] += times * dev
                row["plain_ms"] += times * plain
                row["bound_ms"] += times * bnd
    # a 7-channel pair (pre + post + mask), lerp and nearest samples in one batch
    gen = torch.Generator(device="cuda").manual_seed(61)
    x = torch.randint(0, 256, (2, CROP, CROP, 7), generator=gen, device="cuda").float()
    shift = (torch.rand((2, CROP), generator=gen, device="cuda") - 0.5) * 2.2 * CROP
    sel = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
    for axis in (2, 1):
        if not torch.equal(rowshift.row_shift(x, shift, sel, axis=axis),
                           rowshift.row_shift_reference(x, shift, sel, axis=axis)):
            raise AssertionError(f"K6 row_shift C=7 axis {axis}: not bit-equal")
    log(f"K6 row_shift (2, {CROP}, {CROP}, 7) f32, shifts past both edges, axes 2 and 1: "
        f"bit-equal; per --autoaugment step with one rotation and one shear group of "
        f"{AA_GROUP} samples (4 launches): kernel {row['ms']:.4f} ms (device time "
        f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        "(bytes)")
    row.update({f"host_us_{k}": v for k, v in row_shift_host_breakdown().items()})
    # --autoaugment on pairs: 7-channel pixels (pre, post, mask) take the
    # scalar path; the same step row at C = 7 and each launch at the damage
    # batch, EQUAL to the plain version
    pair = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for n in (AA_GROUP, DMG_BATCH):
        for tag, x, shift, sel, axis in _row_shift_cases(n, 7):
            got = rowshift.row_shift(x, shift, sel, axis=axis)
            if not torch.equal(got, rowshift.row_shift_reference(x, shift, sel, axis=axis)):
                raise AssertionError(f"K6 row_shift {tag} {tuple(x.shape)}: not bit-equal")
            fn = lambda: rowshift.row_shift(x, shift, sel, axis=axis)  # noqa: E731
            ms, dev = cuda_ms(fn, 20), device_ms(fn, 20)
            plain = cuda_ms(lambda: rowshift.row_shift_reference(x, shift, sel, axis=axis), 5)
            copy = cuda_ms(lambda: x.clone(), 20)
            bnd, _ = bound_ms(2 * x.numel() * 4 + shift.numel() * 4 + sel.numel() * 4, 0.0,
                              "float32")
            log(f"K6 row_shift pair {tag} {tuple(x.shape)} f32 axis {axis}: bit-equal, kernel "
                f"{ms:.4f} ms ({2 * x.numel() * 4 / ms / 1e9:.3f} TB/s; device time {dev:.4f}), "
                f"plain {plain:.4f} ms, clone {copy:.4f} ms, bound {bnd:.4f} ms (bytes)")
            if n == AA_GROUP:
                times = 2 if tag == "rotate row pass" else 1
                for k, v in (("ms", ms), ("device_ms", dev), ("plain_ms", plain),
                             ("bound_ms", bnd)):
                    pair[k] += times * v
            else:
                row[f"pair_batch_ms_{tag.replace(' ', '_')}"] = ms
                row[f"pair_batch_device_ms_{tag.replace(' ', '_')}"] = dev
    log(f"K6 per --autoaugment step on pairs (C = 7, one rotation and one shear group of "
        f"{AA_GROUP}, 4 launches): kernel {pair['ms']:.4f} ms (device time "
        f"{pair['device_ms']:.4f}), plain {pair['plain_ms']:.4f} ms, bound "
        f"{pair['bound_ms']:.4f} ms (bytes)")
    row.update({f"pair_{k}": v for k, v in pair.items()})
    row.update({f"pair_host_us_{k}": v for k, v in row_shift_host_breakdown(c=7).items()})
    return row


SMALL_CONV = (16, 512, 512, 32, 32)   # (B, H, W, C, Co), bfloat16


def _small_conv_case(shape, dtype, seed):
    import torch

    b, h, w, c, co = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, h, w, co), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, c, co), generator=gen, device="cuda") / math.sqrt(9 * c)).to(dtype)
    return x, g, k


def _compare_small_fwd(got, want, tag):
    """Within one rounding of the output dtype plus 1e-3 of the scale (the
    f32 sums run in another order)."""
    import torch

    gf, wf = got.float(), want.float()
    err = (gf - wf).abs()
    scale = wf.abs().max().item()
    if not bool((err <= 2 * torch.finfo(want.dtype).eps * wf.abs() + 1e-3 * scale).all()):
        raise AssertionError(f"{tag}: disagrees, max abs err {err.max().item():.4g}")
    return err.max().item()


def check_small_conv():
    """K7 (forward, and as dx with the flipped, IO-transposed kernel) and K8
    (dW) at (16, 512, 512, 32) -> 32 in bfloat16 and at one float32 shape
    against their plain versions; times beside the plain version, one library
    call each (``F.conv2d``, ``torch.nn.grad.conv2d_weight``) and the bound."""
    import torch
    import torch.nn.functional as F

    from xview2_tpu_torch.ops import small_conv as sc

    b, h, w, c, co = SMALL_CONV
    x, g, k = _small_conv_case(SMALL_CONV, torch.bfloat16, seed=80)
    kmat = sc.kernel_to_mat(k)
    kflip = sc.kernel_to_mat(k.flip(0, 1).permute(0, 1, 3, 2)).contiguous()
    e_fwd = _compare_small_fwd(sc.small_conv_fwd(x, kmat), sc.reference_conv3x3(x, kmat),
                               "K7 small_conv_fwd bf16")
    e_dx = _compare_small_fwd(sc.small_conv_fwd(g, kflip), sc.reference_conv3x3(g, kflip),
                              "K7 small_conv_fwd bf16 (dx)")
    e_dw, r_dw = _compare_wgrad(sc.small_conv_wgrad(x, g), sc.reference_wgrad(x, g),
                                "K8 small_conv_wgrad bf16")
    torch.cuda.synchronize()
    log(f"K7/K8 {(b, h, w, c)}->{co} bf16: out max abs err {e_fwd:.4g}, dx max abs err "
        f"{e_dx:.4g} (tolerance 2*eps*|out| + 1e-3*max|out|), dW max abs err {e_dw:.4g} "
        f"({r_dw:.3g} of max|dW|, tolerance 1e-3)")
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    kc = k.permute(3, 2, 0, 1).contiguous()
    kfc = k.flip(0, 1).permute(2, 3, 0, 1).contiguous()  # (C, Co, 3, 3): the dx conv's OIHW
    flops = 2.0 * b * h * w * 9 * c * co
    act = b * h * w * (c + co) * 2
    rows = {}
    ms = cuda_ms(lambda: sc.small_conv_fwd(x, kmat), 5)
    dx_ms = cuda_ms(lambda: sc.small_conv_fwd(g, kflip), 5)
    plain = cuda_ms(lambda: sc.reference_conv3x3(x, kmat), 5)
    lib = cuda_ms(lambda: F.conv2d(xc, kc, padding=1), 5)
    lib_dx = cuda_ms(lambda: F.conv2d(gc, kfc, padding=1), 5)
    bnd, by = bound_ms(act + 9 * c * co * 2, flops, "bfloat16")
    dev = device_ms(lambda: sc.small_conv_fwd(x, kmat), 5)
    dx_dev = device_ms(lambda: sc.small_conv_fwd(g, kflip), 5)
    lib_dev = device_ms(lambda: F.conv2d(xc, kc, padding=1), 5)
    lib_dx_dev = device_ms(lambda: F.conv2d(gc, kfc, padding=1), 5)
    if not torch.equal(sc.small_conv_fwd(x, kmat), sc.small_conv_fwd(x, kmat)):
        raise AssertionError("K7 small_conv_fwd bf16: out differs between two runs")
    log(f"K7 small_conv_fwd timing: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{act / ms / 1e9:.3f} TB/s, {100 * bnd / ms:.0f}% of the bound; device time "
        f"{dev:.4f}), as dx {dx_ms:.4f} ms (device time {dx_dev:.4f}), plain {plain:.3f} ms, "
        f"library (cuDNN conv) {lib:.4f} ms (device time {lib_dev:.4f}), as dx {lib_dx:.4f} ms "
        f"(device time {lib_dx_dev:.4f}), bound {bnd:.3f} ms ({by}); out EQUAL between two runs")
    rows["small_conv_fwd"] = dict(max_abs_err=max(e_fwd, e_dx), ms=ms, dx_ms=dx_ms,
                                  plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
                                  device_ms=dev, dx_device_ms=dx_dev, library_device_ms=lib_dev,
                                  dx_library_ms=lib_dx, dx_library_device_ms=lib_dx_dev)
    lib_fn = lambda: torch.nn.grad.conv2d_weight(xc, kc.shape, gc, padding=1)  # noqa: E731
    ms = cuda_ms(lambda: sc.small_conv_wgrad(x, g), 20)
    plain = cuda_ms(lambda: sc.reference_wgrad(x, g), 2)
    lib = cuda_ms(lib_fn, 20)
    dev = device_ms(lambda: sc.small_conv_wgrad(x, g), 20)
    lib_dev = device_ms(lib_fn, 20)
    bnd, by = bound_ms(act + 9 * c * co * 4, flops, "bfloat16")
    if not torch.equal(sc.small_conv_wgrad(x, g), sc.small_conv_wgrad(x, g)):
        raise AssertionError("K8 small_conv_wgrad bf16: dW differs between two runs")
    log(f"K8 small_conv_wgrad timing: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{act / ms / 1e9:.3f} TB/s, {100 * bnd / ms:.0f}% of the bound; device time {dev:.4f}, "
        f"{100 * bnd / dev:.0f}%), plain {plain:.3f} ms, library (cuDNN wgrad) {lib:.4f} ms "
        f"(device time {lib_dev:.4f}): {ms / lib:.2f}x cuDNN by the events, {dev / lib_dev:.2f}x "
        f"by device time; bound {bnd:.3f} ms ({by}); dW EQUAL between two runs")
    rows["small_conv_wgrad"] = dict(max_abs_err=e_dw, ms=ms, plain_ms=plain, library_ms=lib,
                                    bound_ms=bnd, bound_by=by, device_ms=dev,
                                    library_device_ms=lib_dev, bound_share=bnd / ms,
                                    device_bound_share=bnd / dev)
    del x, g, xc, gc
    torch.cuda.empty_cache()
    # odd channel counts of the domain (padding to 16 inside the kernels) and
    # a ragged width, in bfloat16; then one float32 shape (FMA kernels, TF32 off)
    for shape, dtype in (((2, 70, 200, 24, 40), torch.bfloat16),
                         ((4, 256, 256, 32, 32), torch.float32)):
        x, g, k = _small_conv_case(shape, dtype, seed=81)
        kmat = sc.kernel_to_mat(k)
        e_fwd = _compare_small_fwd(sc.small_conv_fwd(x, kmat), sc.reference_conv3x3(x, kmat),
                                   f"K7 {shape} {dtype}")
        e_dw, r_dw = _compare_wgrad(sc.small_conv_wgrad(x, g), sc.reference_wgrad(x, g),
                                    f"K8 {shape} {dtype}")
        if dtype == torch.bfloat16 and not torch.equal(sc.small_conv_wgrad(x, g),
                                                       sc.small_conv_wgrad(x, g)):
            raise AssertionError(f"K8 {shape} bf16: dW differs between two runs")
        ms7 = cuda_ms(lambda: sc.small_conv_fwd(x, kmat), 3)
        p7 = cuda_ms(lambda: sc.reference_conv3x3(x, kmat), 3)
        ms8 = cuda_ms(lambda: sc.small_conv_wgrad(x, g), 3)
        p8 = cuda_ms(lambda: sc.reference_wgrad(x, g), 3)
        log(f"K7/K8 {shape[:4]}->{shape[4]} {str(dtype).split('.')[-1]}: out max abs err "
            f"{e_fwd:.4g}, dW max abs err {e_dw:.4g} ({r_dw:.3g} of max|dW|); forward kernel "
            f"{ms7:.3f} ms, plain {p7:.3f} ms; wgrad kernel {ms8:.3f} ms, plain {p8:.3f} ms "
            f"(plain versions with TF32 off)")
    return rows


# --------------------------------------------------------------- main path

def seeded_model(cfg, seed: int, kernel_scale: float = 2.2):
    """The port's model with random weights from ``seed``: torch's default
    conv init scaled by ``kernel_scale`` so activations stay O(1) (1.9 for
    the 66 blocks of ResNeSt-200), BN statistics and affines drawn away
    from the identity so the folds do real work, and each CORAL head's
    ordinal bias its initial [1, 0, -1] plus N(0, 0.1) noise, as the CPU
    tests draw it: levels drawn near each other would tie in bfloat16 and
    make the logits' argmax a coin toss between two equal channels."""
    import torch

    from xview2_tpu_torch.models.unet import build_model

    torch.manual_seed(seed)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("coral_bias"):
                t.copy_(torch.tensor([1.0, 0.0, -1.0]) + torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) * 1.5 + 0.5)
            elif name.endswith("weight") and t.dim() == 1:
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("weight"):
                t.mul_(kernel_scale)
    return model


def _counters():
    from xview2_tpu_torch.ops import layout, rowshift, small_conv
    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    return (layout.relayout_cuda, pfc.conv_bn_fused, pfc.head_conv_fused, pfc.conv_bn_wgrad,
            pfc.conv_bn_dgrad, rowshift.row_shift_cuda, small_conv.small_conv_fwd,
            small_conv.small_conv_wgrad)


def _zero_counters() -> None:
    for fn in _counters():
        fn.launches = 0


def _read_counters() -> dict:
    return {fn.__name__: fn.launches for fn in _counters()}


def _need_launches(launches: dict, need: dict, path: str) -> None:
    for k, n in need.items():
        if launches[k] < n:
            raise AssertionError(f"{k} launched {launches[k]} times on the {path} main path, "
                                 f"expected >= {n}")


def _time_eval_step(cfg, model, channels: int, profile: bool, tag: str) -> dict:
    """Steady state of the eval step of ``cfg`` (4-flip TTA) on a
    device-resident batch of VAL_BATCH raw tiles: CUDA events over 3 steps
    after 1 warm-up, and peak memory.  Returns the numbers and the logits."""
    import numpy as np
    import torch

    from xview2_tpu_torch.ops.metrics import init_f1_state
    from xview2_tpu_torch.parallel.steps import make_eval_step

    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (VAL_BATCH, TILE, TILE, channels),
                                           np.uint8)).cuda()
    masks = torch.from_numpy(((rng.random((VAL_BATCH, TILE, TILE)) > 0.9)
                              * rng.integers(1, 5 if channels == 6 else 2,
                                             (VAL_BATCH, TILE, TILE))).astype(np.uint8)).cuda()
    valid = torch.ones(VAL_BATCH, device="cuda")
    step = make_eval_step(cfg, model, device="cuda")
    f1 = init_f1_state(cfg.n_metric_class, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(f1, images, masks, valid), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    logits = step(f1, images, masks, valid)[2].float()
    log(f"eval step ({tag}, batch {VAL_BATCH} x 4 TTA of {TILE}^2, "
        f"{'bf16' if cfg.precision == 16 else 'f32'}): {ms:.2f} ms = "
        f"{VAL_BATCH / ms * 1e3:.3f} tiles/s, peak memory {peak:.2f} GiB")
    if profile:
        profile_step(lambda: step(f1, images, masks, valid), f"eval step, {tag}")
    return {"ms": ms, "tiles_per_s": VAL_BATCH / ms * 1e3, "peak_gib": peak}, logits


def _check_fused_vs_stock(outs: dict, tag: str, names=("fused", "stock")) -> None:
    """The bf16 logits ``outs[True]`` against ``outs[False]`` (the fused and
    the stock tail, or the two ``names`` given)."""
    ref, got = outs[False], outs[True]
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"{tag} {names[0]} vs {names[1]} logits: max abs diff {diff:.4g}, max |logit| "
        f"{scale:.4g}, argmax agreement {agree:.5f} (tolerance: diff <= 0.05*max|logit|, "
        "agreement >= 0.99)")
    if not (math.isfinite(diff) and diff <= 0.05 * scale and agree >= 0.99):
        raise AssertionError(f"{tag}: {names[0]} and {names[1]} eval paths disagree")


def run_eval_path(work: str, profile: bool):
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.data.synthetic import make_synthetic_split
    from xview2_tpu_torch.main import main as port_main
    from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
    from xview2_tpu_torch.weights import to_flax

    t0 = time.perf_counter()
    make_synthetic_split(work, "holdout", N_TILES, size=TILE, seed=7)
    cfg = Config(type="pre", encoder="resnet50", precision=16, loss_str="focal+dice",
                 tta=True, fused_tail=True, fold_eval_bn=True)
    model = seeded_model(cfg, seed=0)
    ckpt = os.path.join(work, "ckpt")
    ckpt_lib.save_checkpoint(ckpt, *to_flax(model.state_dict()), epoch=0, best_f1=0.0,
                             best_epoch=0, cfg=cfg)
    log(f"main path setup (holdout of {N_TILES} tiles of {TILE}^2, seeded ResNet-50 UNetLoc "
        f"checkpoint): {time.perf_counter() - t0:.1f} s")

    results = os.path.join(work, "results")
    argv = ["--exec_mode", "eval", "--type", "pre", "--data", work, "--results", results,
            "--ckpt", ckpt, "--val_batch_size", str(VAL_BATCH), "--num_workers", "8",
            "--eval_tta", "on", "--eval_fused_tail", "on"]
    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = port_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    log(f"main path: main(--exec_mode eval, {N_TILES} tiles) {wall:.2f} s end to end "
        f"({N_TILES / wall:.3f} tiles/s incl. model build, checkpoint load and PNG decode); "
        f"launches {launches}")

    probs = sorted(glob.glob(os.path.join(results, "probs", "*.npy")))
    targets = sorted(glob.glob(os.path.join(results, "targets", "*.png")))
    if len(probs) != N_TILES or len(targets) != N_TILES:
        raise AssertionError(f"expected {N_TILES} dumps, got {len(probs)} probs and "
                             f"{len(targets)} targets")
    import numpy as np

    for p in probs:
        prob = np.load(p)
        if prob.shape != (TILE, TILE) or not np.isfinite(prob).all() or \
                prob.min() < 0 or prob.max() > 1:
            raise AssertionError(f"{p}: bad probabilities {prob.shape}")
    with open(os.path.join(results, "logs.json")) as f:
        metrics = json.loads(f.readlines()[-1])["data"]
    if not math.isfinite(metrics["f1"]):
        raise AssertionError(f"F1 is not finite: {metrics}")
    steps = N_TILES // VAL_BATCH
    _need_launches(launches, {"relayout_cuda": steps, "conv_bn_fused": 6 * steps,
                              "head_conv_fused": steps}, "eval")
    log(f"main path outputs: {len(probs)} probs, {len(targets)} targets, metrics {metrics}")

    # steady state of the eval step on a device-resident batch, and the fused
    # path against the stock (cuDNN) path on the same batch
    model = model.cuda()
    outs = {}
    for fused in (False, True):
        _, outs[fused] = _time_eval_step(cfg.replace(fused_tail=fused), model, 3, profile,
                                         "fused tail" if fused else "stock tail")
    _check_fused_vs_stock(outs, "eval step")
    check_f32_against_cpu()
    return launches


def _drive_train_cli(work: str, results_name: str, extra_argv, need_total: dict, tag: str,
                     batch: int = TRAIN_BATCH, need_per_step: dict = None):
    """``main([--exec_mode train ...])`` on the synthetic train split with the
    launch counters set to 0 just before and read just after; then its log
    and both checkpoints are checked.  ``extra_argv`` follows the common
    flags (``--type pre``, the CLI's default encoder unless it names one).
    Returns the launch counts."""
    import torch

    from xview2_tpu_torch.main import main as port_main
    from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
    from xview2_tpu_torch.train.trainer import initial_model
    from xview2_tpu_torch.weights import from_flax

    results = os.path.join(work, results_name)
    argv = ["--exec_mode", "train", "--type", "pre", "--fused_tail",
            "1", "--batch_size", str(batch), "--epochs", "1", "--val_batch_size",
            str(VAL_BATCH), "--num_workers", "8", "--data", work, "--results", results]
    argv += list(extra_argv)
    _zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = port_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    steps = TRAIN_TILES // batch
    log(f"{tag} main path: main(--exec_mode train {' '.join(extra_argv)}, {TRAIN_TILES} tiles = "
        f"{steps} steps at batch {batch} of {CROP}^2 crops, validation on "
        f"{TRAIN_VAL_TILES} tiles, best and last checkpoints) {wall:.2f} s end to end (index "
        f"build, model build and PNG decode included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {launches}")
    per_step = TRAIN_NEED if need_per_step is None else need_per_step
    _need_launches(launches, dict({k: n * steps for k, n in per_step.items()}, **need_total),
                   tag)
    with open(os.path.join(results, "logs.json")) as f:
        metrics = json.loads(f.readlines()[-1])["data"]
    if not (math.isfinite(metrics["val_loss"]) and metrics["imgs_per_sec"] > 0):
        raise AssertionError(f"validation loss is not finite: {metrics}")
    cfg = ckpt_lib.load_config(os.path.join(results, "checkpoints", "last"))
    fresh = initial_model(cfg).state_dict()
    for name in ("best", "last"):
        path = os.path.join(results, "checkpoints", name)
        if not ckpt_lib.checkpoint_exists(path):
            raise AssertionError(f"no {name} checkpoint at {path}")
        payload, meta = ckpt_lib.restore_raw(path)
        trained = from_flax(payload["params"], payload["batch_stats"])
        initial_model(cfg).load_state_dict(trained, strict=True)  # it reloads
        if int(payload["train"]["step"]) != steps or "opt_state" not in payload:
            raise AssertionError(f"{name}: step {payload['train']['step']}, expected {steps}, "
                                 "with optimizer state")
        moved = [k for k, v in trained.items() if not torch.equal(v, fresh[k])]
        finite = all(bool(torch.isfinite(v).all()) for v in trained.values())
        stats = [k for k in moved if "running" in k]
        if not finite or len(moved) < 0.9 * len(trained) or not stats:
            raise AssertionError(f"{name}: finite={finite}, {len(moved)} of {len(trained)} "
                                 f"tensors differ from the initial ones ({len(stats)} running "
                                 "statistics)")
    log(f"{tag} main path outputs: metrics {metrics}; best and last checkpoints reload, step "
        f"{steps}, {len(moved)} of {len(trained)} tensors moved from their initial values "
        f"({len(stats)} BN running statistics), all finite")
    return launches


TRAIN_NEED = {"relayout_cuda": 3, "conv_bn_fused": 6, "head_conv_fused": 1, "conv_bn_wgrad": 6,
              "conv_bn_dgrad": 6}   # launches per train step


def _raw_train_batch(batch: int = TRAIN_BATCH, channels: int = 3):
    """A device-resident batch of raw tiles (pre/post pairs with damage
    labels 1..4 on 10% of the pixels for 6 channels) for the steady-state
    timings."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13)
    images = torch.from_numpy(rng.integers(0, 256, (batch, TILE, TILE, channels), np.uint8))
    fg = rng.random((batch, TILE, TILE)) > 0.9
    labels = rng.integers(1, 5, fg.shape) if channels == 6 else 1
    masks = torch.from_numpy((fg * labels).astype(np.uint8))
    return images.cuda(), masks.cuda()


def _time_train_step(cfg, images, masks, profile: bool, tag: str,
                     kernel_scale: float = 2.2) -> dict:
    """Steady state of the train step of ``cfg`` on a device-resident batch:
    CUDA events over 3 steps after 1 warm-up, peak memory, launch counts."""
    import torch

    from xview2_tpu_torch.parallel.steps import (init_train_state, make_train_step,
                                                 step_generator)
    from xview2_tpu_torch.train.optimizers import build_optimizer

    model = seeded_model(cfg, seed=0, kernel_scale=kernel_scale)
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    state = init_train_state(model, opt, device="cuda")
    step = make_train_step(cfg, model, opt, crop=CROP, device="cuda")
    losses = []

    def one_step():
        losses.append(step(state, images, masks, step_generator(cfg, state.step, "cuda"))[1])

    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(one_step, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vals = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"train step losses are not finite: {vals}")
    b = images.shape[0]
    launches = _nonzero(_read_counters())
    log(f"train step ({tag}, batch {b} raw {TILE}^2 tiles -> {CROP}^2 crops, bf16, "
        f"{cfg.optimizer}): {ms:.2f} ms = {b / ms * 1e3:.3f} tiles/s, peak memory {peak:.2f} "
        f"GiB, losses {[round(v, 4) for v in vals]}, launches over 4 steps {launches}")
    if profile:
        profile_step(one_step, f"train step, {tag}")
    del model, opt, state, step
    torch.cuda.empty_cache()
    return {"ms": ms, "tiles_per_s": b / ms * 1e3, "peak_gib": peak, "launches": launches}


def run_train_path(work: str, profile: bool):
    """The train main path through ``main``, then the train step's steady
    state (fused tail against stock tail) on a device-resident batch."""
    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.data.synthetic import make_synthetic_split

    t0 = time.perf_counter()
    make_synthetic_split(work, "train", TRAIN_TILES, size=TILE, seed=11)
    make_synthetic_split(work, "test", TRAIN_VAL_TILES, size=TILE, seed=12)
    log(f"train path setup (train split of {TRAIN_TILES} tiles and validation split of "
        f"{TRAIN_VAL_TILES} tiles of {TILE}^2): {time.perf_counter() - t0:.1f} s")
    launches = _drive_train_cli(work, "train_results", ["--encoder", "resnet50"], {}, "train")

    images, masks = _raw_train_batch()
    base = Config(type="pre", encoder="resnet50", precision=16, loss_str="focal+dice",
                  batch_size=TRAIN_BATCH, optimizer="adamw")
    for fused in (True, False):
        _time_train_step(base.replace(fused_tail=fused), images, masks, profile,
                         "fused tail" if fused else "stock tail")
    check_f32_train_step_against_cpu()
    return launches


def run_small_conv_path():
    """The second entry point: ``conv3x3_small`` forward and backward at
    (16, 512, 512, 32) -> 32 in bfloat16, counters from 0.  Its output and
    both gradients are held against autograd through the library convolution
    on the same tensors: within one bf16 rounding plus 1e-2 of the scale (the
    cotangent 2*out is itself rounded to bf16 on both sides)."""
    import torch

    from xview2_tpu_torch.ops import small_conv as sc
    from xview2_tpu_torch.ops.packed_fused_conv import conv3x3_nhwc

    x, _, k = _small_conv_case(SMALL_CONV, torch.bfloat16, seed=85)
    x.requires_grad_()
    k.requires_grad_()
    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sc.conv3x3_small(x, k)
    loss = (out.float() ** 2).mean()
    loss.backward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = _read_counters()
    _need_launches(launches, {"small_conv_fwd": 2, "small_conv_wgrad": 1}, "conv3x3_small")
    xr, kr = x.detach().clone().requires_grad_(), k.detach().clone().requires_grad_()
    ref = conv3x3_nhwc(xr, kr)
    (ref.float() ** 2).mean().backward()
    torch.cuda.synchronize()
    errs = []
    for name, got, want in (("out", out, ref), ("dx", x.grad, xr.grad), ("dk", k.grad, kr.grad)):
        gf, wf = got.detach().float(), want.detach().float()
        if got.shape != want.shape or got.dtype != torch.bfloat16 or \
                not bool(torch.isfinite(gf).all()):
            raise AssertionError(f"conv3x3_small {name}: shape, dtype or values are off")
        err = (gf - wf).abs()
        if not bool((err <= 2 ** -7 * wf.abs() + 1e-2 * wf.abs().max()).all()):
            raise AssertionError(f"conv3x3_small {name} disagrees with the library's autograd: "
                                 f"max abs err {err.max().item():.4g}")
        errs.append(f"{name} {err.max().item():.3g} of {wf.abs().max().item():.3g}")
    log(f"conv3x3_small path: forward and backward at {SMALL_CONV[:4]}->{SMALL_CONV[4]} bf16 in "
        f"{wall:.2f} ms (first use), loss {loss.item():.6f}; max abs err against autograd "
        f"through the library conv: {', '.join(errs)} (tolerance 2^-7*|v| + 1e-2*max|v|); "
        f"launches { {k: v for k, v in launches.items() if v} }")
    return launches


DMG_NEED = {"relayout_cuda": 3, "conv_bn_fused": 12, "head_conv_fused": 1, "conv_bn_wgrad": 12,
            "conv_bn_dgrad": 12}   # launches per Siamese train step: the tail runs per branch


def write_splits(work: str) -> None:
    """The synthetic splits of the eval and train paths, where they are not
    in ``work`` yet (the damage phases alone write them)."""
    from xview2_tpu_torch.data.synthetic import make_synthetic_split

    for split, n, seed in (("holdout", N_TILES, 7), ("train", TRAIN_TILES, 11),
                           ("test", TRAIN_VAL_TILES, 12)):
        if not os.path.isdir(os.path.join(work, split)):
            make_synthetic_split(work, split, n, size=TILE, seed=seed)


def run_damage_path(work: str, profile: bool):
    """The README's pipeline at the CLI's defaults (ResNeSt-200, full width
    and depth, torch's initializers from --seed): A, ``main([--exec_mode
    train --type pre --fused_tail 1])`` at batch DMG_A_BATCH; B, ``main([...
    --type post --dmg_model siamese --ckpt_pre <A's best> --loss_str
    ohem+dice --fused_tail 1])`` at batch DMG_BATCH; then ``main([--exec_mode
    eval --type post --ckpt <B's best> --eval_tta on])``, each with the
    counters set to 0 just before and read just after, on the splits of the
    earlier paths.  B's transplant is watched: every ``unet.enc_l*`` tensor it
    wrote must equal A's checkpoint.  The damage dumps must be (4, 1024,
    1024) float32 class probabilities.  Then the steady state of A's and B's
    train and eval steps (A with the fused and the stock tail), and B's
    float32 eval and train steps on the card against the CPU (ResNeSt-50
    Siamese, small).  Returns {path: launch counts}."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.main import main as port_main
    from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
    from xview2_tpu_torch.train import trainer
    from xview2_tpu_torch.weights import from_flax

    write_splits(work)
    launches = {}
    res_a, res_b = os.path.join(work, "dmg_a"), os.path.join(work, "dmg_b")
    launches["A train"] = _drive_train_cli(work, "dmg_a", [], {}, "A (ResNeSt-200 UNetLoc) train",
                                           batch=DMG_A_BATCH)
    torch.cuda.empty_cache()
    a_best = os.path.join(res_a, "checkpoints", "best")
    payload, _ = ckpt_lib.restore_raw(a_best)
    loc = from_flax(payload["params"], payload["batch_stats"])
    shutil.rmtree(os.path.join(res_a, "checkpoints", "last"))

    seen = {}
    real_transplant = trainer.transplant_encoder

    def watched(dmg_model, model, loc_state):
        copied = real_transplant(dmg_model, model, loc_state)
        seen["copied"] = copied
        seen["state"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                         if k.startswith("unet.enc_l")}
        return copied

    trainer.transplant_encoder = watched
    try:
        launches["B train"] = _drive_train_cli(
            work, "dmg_b", ["--type", "post", "--dmg_model", "siamese", "--ckpt_pre", a_best,
                            "--loss_str", "ohem+dice"],
            {}, "B (ResNeSt-200 Siamese, --ckpt_pre A) train", batch=DMG_BATCH,
            need_per_step=DMG_NEED)
    finally:
        trainer.transplant_encoder = real_transplant
    torch.cuda.empty_cache()
    enc = sorted(seen.get("state", {}))
    differ = [k for k in enc if not torch.equal(seen["state"][k], loc[k])]
    log(f"B's --ckpt_pre transplant: {len(seen.get('copied', []))} tensors copied of "
        f"{len(enc)} unet.enc_l* tensors; {len(differ)} differ from A's best checkpoint")
    if not enc or sorted(seen["copied"]) != enc or differ:
        raise AssertionError("the --ckpt_pre transplant did not copy A's encoder whole")
    del loc, payload, seen

    b_best = os.path.join(res_b, "checkpoints", "best")
    argv = ["--exec_mode", "eval", "--type", "post", "--data", work, "--results", res_b,
            "--ckpt", b_best, "--val_batch_size", str(VAL_BATCH), "--num_workers", "8",
            "--eval_tta", "on"]
    _zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = port_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["B eval"] = _read_counters()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    log(f"B eval main path: main(--exec_mode eval --type post --eval_tta on, {N_TILES} tiles) "
        f"{wall:.2f} s end to end, peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB; launches {launches['B eval']}")
    steps = N_TILES // VAL_BATCH
    _need_launches(launches["B eval"], {"relayout_cuda": steps, "conv_bn_fused": 12 * steps,
                                        "head_conv_fused": steps}, "B eval")
    probs = sorted(glob.glob(os.path.join(res_b, "probs", "test_damage_*.npy")))
    targets = sorted(glob.glob(os.path.join(res_b, "targets", "test_damage_*.png")))
    if len(probs) != N_TILES or len(targets) != N_TILES:
        raise AssertionError(f"expected {N_TILES} damage dumps, got {len(probs)} probs and "
                             f"{len(targets)} targets")
    worst = 0.0
    for p in probs:
        prob = np.load(p)
        if prob.shape != (4, TILE, TILE) or prob.dtype != np.float32 or \
                not np.isfinite(prob).all() or prob.min() < 0:
            raise AssertionError(f"{p}: bad damage probabilities {prob.shape} {prob.dtype}")
        worst = max(worst, float(np.abs(prob.sum(axis=0) - 1.0).max()))
    with open(os.path.join(res_b, "logs.json")) as f:
        metrics = json.loads(f.readlines()[-1])["data"]
    log(f"B eval outputs: {len(probs)} channel-first (4, {TILE}, {TILE}) float32 dumps, class "
        f"sums within {worst:.3g} of 1 (tolerance 1e-3), {len(targets)} targets, metrics "
        f"{metrics}")
    if worst > 1e-3 or "f1" not in metrics:
        raise AssertionError("the damage dumps are not class probabilities")
    shutil.rmtree(os.path.join(res_b, "checkpoints"))

    # steady state of the steps on device-resident batches
    a_cfg = Config(type="pre", encoder="resnest200", precision=16, loss_str="focal+dice",
                   batch_size=DMG_A_BATCH, optimizer="adamw")
    b_cfg = Config(type="post", dmg_model="siamese", encoder="resnest200", precision=16,
                   loss_str="ohem+dice", batch_size=DMG_BATCH, optimizer="adamw",
                   fused_tail=True)
    rows = {}
    images, masks = _raw_train_batch(DMG_A_BATCH, 3)
    for fused in (True, False):
        rows[f"A train {'fused' if fused else 'stock'}"] = _time_train_step(
            a_cfg.replace(fused_tail=fused), images, masks, profile,
            f"A ResNeSt-200 UNetLoc, {'fused' if fused else 'stock'} tail", kernel_scale=1.9)
    del images, masks
    images, masks = _raw_train_batch(DMG_BATCH, 6)
    rows["B train fused"] = _time_train_step(b_cfg, images, masks, profile,
                                             "B ResNeSt-200 Siamese, fused tail",
                                             kernel_scale=1.9)
    del images, masks
    torch.cuda.empty_cache()
    for tag, cfg in (("A", a_cfg.replace(tta=True)), ("B", b_cfg.replace(tta=True))):
        model = seeded_model(cfg, seed=0, kernel_scale=1.9).cuda()
        outs = {}
        for fused in ((True, False) if tag == "A" else (True,)):
            rows[f"{tag} eval {'fused' if fused else 'stock'}"], outs[fused] = _time_eval_step(
                cfg.replace(fused_tail=fused), model, cfg.in_channels, profile,
                f"{tag} ResNeSt-200 {'Siamese' if tag == 'B' else 'UNetLoc'}, "
                f"{'fused' if fused else 'stock'} tail")
        if tag == "A":
            _check_fused_vs_stock(outs, "A eval step")
        if not bool(torch.isfinite(outs[True]).all()):
            raise AssertionError(f"{tag} eval step logits are not finite")
        del model, outs
        torch.cuda.empty_cache()
    small = Config(type="post", dmg_model="siamese", encoder="resnest50", loss_str="ohem+dice")
    check_f32_against_cpu(small, " (B: ResNeSt-50 Siamese)")
    check_f32_train_step_against_cpu(small.replace(precision=32), b=4, size=128,
                                     tag=" (B: ResNeSt-50 Siamese)", spread=True)
    return launches, rows


C_BATCH = 8   # configuration C: ResNeSt-200 fused + CORAL (+ --ppm), BASELINE config 4
# launches per train step of C: each branch's decoder runs its dec_l2 and
# dec_l3 ConvBlocks (two fused convs each) and its packed dec_l5 (two), and
# the packed cross-fusion its conv_pre and conv_post (two): 14 K2, with a K4
# and a K5 behind each; the CORAL head once (K3 at C = 256, Co = 4); K1 for
# the labels, the logits and their cotangent
C_NEED = {"relayout_cuda": 3, "conv_bn_fused": 14, "head_conv_fused": 1, "conv_bn_wgrad": 14,
          "conv_bn_dgrad": 14}
# the six other variants (and cat with the MSE head) at reduced depth and
# batch: ResNet-50, VARIANT_BATCH pairs cropped to VARIANT_CROP^2; with the
# fused convs of one step: dec_l2, dec_l3 and dec_l5 two each per decoder,
# but the doubled decoders of siameseEnc and parallelEnc keep dec_l2 (C =
# 1280) on the stock route, whose weight gradient exceeds supported()'s budget
VARIANTS = (("siameseEnc", "ohem+dice", 4), ("fusedEnc", "ohem+dice", 6),
            ("parallel", "ohem+dice", 12), ("parallelEnc", "ohem+dice", 4),
            ("diff", "ohem+dice", 6), ("cat", "ohem+dice", 6), ("cat", "mse", 6))
VARIANT_BATCH = 2
VARIANT_CROP = 256


def run_dmg_variants_path(work: str, profile: bool):
    """Configuration C, BASELINE's config 4 as written, through the CLI at
    full width and depth: ``main([--exec_mode train --type post --dmg_model
    fused --loss_str coral --ppm --fused_tail 1 --batch_size 8 --ckpt_pre
    <A's best>])`` (the CLI's default encoder, ResNeSt-200; the fused
    variant ignores ``--ppm``, as JAX's does: its tree is held equal with
    and without it), its transplant
    watched (every ``enc_fusion_i.pre_layer`` and ``.post_layer`` tensor
    equal to A's ``unet.enc_l{i+1}``), then ``main([--exec_mode eval ...
    --eval_tta on --eval_fused_tail on])`` on C's best with its CORAL dumps
    ((1024, 1024) float32 classes in {1, 2, 3, 4}), each with the counters
    from 0; C's train step (fused and stock tail) and eval step (fused
    against stock) on device-resident batches.  Then the six other variants
    and ``cat`` with the MSE head, one train and one eval step each
    (ResNet-50, VARIANT_BATCH pairs of VARIANT_CROP^2): a finite loss, moved
    parameters, fused and stock eval in agreement, K3 on the kernel its
    shape should take.  Then the fused variant's float32 train step against
    the CPU, and the --autoaugment chain on pairs against the CPU.  Needs
    A's best checkpoint from :func:`run_damage_path`.  Returns ({path:
    launch counts}, {row: steady-state numbers})."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.main import main as port_main
    from xview2_tpu_torch.models.unet import build_model
    from xview2_tpu_torch.ops import packed_fused_conv as pfc
    from xview2_tpu_torch.ops.metrics import init_f1_state
    from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
    from xview2_tpu_torch.parallel.steps import (init_train_state, make_eval_step,
                                                 make_train_step, step_generator)
    from xview2_tpu_torch.train import trainer
    from xview2_tpu_torch.train.optimizers import build_optimizer
    from xview2_tpu_torch.weights import from_flax

    # config 4 as written: the fused variant ignores --ppm, as JAX's does
    with torch.device("meta"):
        trees = [{k: tuple(v.shape) for k, v in build_model(Config(
            type="post", dmg_model="fused", loss_str="coral", ppm=ppm)).state_dict().items()}
            for ppm in (False, True)]
    if trees[0] != trees[1]:
        raise AssertionError("C's parameter tree changes with --ppm")
    log(f"C's tree with and without --ppm: the same {len(trees[0])} tensors, names and shapes")
    a_best = os.path.join(work, "dmg_a", "checkpoints", "best")
    payload, _ = ckpt_lib.restore_raw(a_best)
    loc = from_flax(payload["params"], payload["batch_stats"])
    del payload
    launches, rows, seen = {}, {}, {}
    real_transplant = trainer.transplant_encoder

    def watched(dmg_model, model, loc_state):
        copied = real_transplant(dmg_model, model, loc_state)
        seen["copied"] = copied
        seen["state"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                         if k.startswith("enc_fusion_")
                         and k.split(".")[1] in ("pre_layer", "post_layer")}
        return copied

    trainer.transplant_encoder = watched
    try:
        launches["C train"] = _drive_train_cli(
            work, "dmg_c", ["--type", "post", "--dmg_model", "fused", "--loss_str", "coral",
                            "--ppm", "--ckpt_pre", a_best],
            {}, "C (ResNeSt-200 fused + CORAL, --ckpt_pre A) train", batch=C_BATCH,
            need_per_step=C_NEED)
    finally:
        trainer.transplant_encoder = real_transplant
    torch.cuda.empty_cache()
    enc = sorted(seen.get("state", {}))

    def source(name):  # enc_fusion_i.{pre,post}_layer.rest -> unet.enc_l{i+1}.rest
        block, _, rest = name.split(".", 2)
        return f"unet.enc_l{int(block.split('_')[-1]) + 1}.{rest}"

    differ = [k for k in enc if source(k) not in loc or not torch.equal(seen["state"][k],
                                                                        loc[source(k)])]
    n_loc = sum(k.startswith("unet.enc_l") for k in loc)
    log(f"C's --ckpt_pre transplant: {len(seen.get('copied', []))} tensors copied of "
        f"{len(enc)} enc_fusion_*.pre_layer/post_layer tensors (A has {n_loc} unet.enc_l* "
        f"tensors, each placed in both branches); {len(differ)} differ from A's best checkpoint")
    if not enc or sorted(seen["copied"]) != enc or differ or len(enc) != 2 * n_loc:
        raise AssertionError("the --ckpt_pre transplant did not copy A's encoder whole into "
                             "both branches")
    del loc, seen

    res_c = os.path.join(work, "dmg_c")
    argv = ["--exec_mode", "eval", "--type", "post", "--dmg_model", "fused", "--loss_str",
            "coral", "--ppm", "--data", work, "--results", res_c, "--ckpt",
            os.path.join(res_c, "checkpoints", "best"), "--val_batch_size", str(VAL_BATCH),
            "--num_workers", "8", "--eval_tta", "on", "--eval_fused_tail", "on"]
    _zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = port_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["C eval"] = _read_counters()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    log(f"C eval main path: main(--exec_mode eval --type post --dmg_model fused --loss_str coral "
        f"--eval_tta on --eval_fused_tail on, {N_TILES} tiles) {wall:.2f} s end to end, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{launches['C eval']}")
    steps = N_TILES // VAL_BATCH
    _need_launches(launches["C eval"], {"relayout_cuda": steps, "conv_bn_fused": 14 * steps,
                                        "head_conv_fused": steps}, "C eval")
    probs = sorted(glob.glob(os.path.join(res_c, "probs", "test_damage_*.npy")))
    targets = sorted(glob.glob(os.path.join(res_c, "targets", "test_damage_*.png")))
    if len(probs) != N_TILES or len(targets) != N_TILES:
        raise AssertionError(f"expected {N_TILES} damage dumps, got {len(probs)} probs and "
                             f"{len(targets)} targets")
    counts = np.zeros(5, np.int64)
    for p in probs:
        cls = np.load(p)
        if cls.shape != (TILE, TILE) or cls.dtype != np.float32 or \
                not set(np.unique(cls).tolist()) <= {1.0, 2.0, 3.0, 4.0}:
            raise AssertionError(f"{p}: bad CORAL classes {cls.shape} {cls.dtype} "
                                 f"{np.unique(cls)[:8]}")
        counts += np.bincount(cls.astype(np.int64).ravel(), minlength=5)
    with open(os.path.join(res_c, "logs.json")) as f:
        metrics = json.loads(f.readlines()[-1])["data"]
    log(f"C eval outputs: {len(probs)} ({TILE}, {TILE}) float32 CORAL class dumps, pixels per "
        f"class 1-4 {counts[1:].tolist()}, {len(targets)} targets, metrics {metrics}")
    if "f1" not in metrics:
        raise AssertionError("the damage eval logged no F1")
    shutil.rmtree(os.path.join(res_c, "checkpoints"))

    # C's steady state on device-resident batches
    c_cfg = Config(type="post", dmg_model="fused", encoder="resnest200", precision=16,
                   loss_str="coral", batch_size=C_BATCH, optimizer="adamw", fused_tail=True,
                   ppm=True)
    images, masks = _raw_train_batch(C_BATCH, 6)
    for fused in (True, False):
        rows[f"C train {'fused' if fused else 'stock'}"] = _time_train_step(
            c_cfg.replace(fused_tail=fused), images, masks, profile,
            f"C ResNeSt-200 fused + CORAL, {'fused' if fused else 'stock'} tail", kernel_scale=1.9)
    del images, masks
    torch.cuda.empty_cache()
    model = seeded_model(c_cfg.replace(tta=True), seed=0, kernel_scale=1.9).cuda()
    outs = {}
    for fused in (True, False):
        rows[f"C eval {'fused' if fused else 'stock'}"], outs[fused] = _time_eval_step(
            c_cfg.replace(tta=True, fused_tail=fused), model, 6, profile,
            f"C ResNeSt-200 fused + CORAL, {'fused' if fused else 'stock'} tail")
    _check_fused_vs_stock(outs, "C eval step (CORAL logits)")
    del model, outs
    torch.cuda.empty_cache()

    # the six other variants, and cat with the MSE head
    rng = np.random.default_rng(23)
    images, masks = _raw_train_batch(VARIANT_BATCH, 6)
    ev_images = torch.from_numpy(rng.integers(0, 256, (VARIANT_BATCH, VARIANT_CROP, VARIANT_CROP,
                                                       6), np.uint8)).cuda()
    ev_masks = torch.from_numpy(((rng.random((VARIANT_BATCH, VARIANT_CROP, VARIANT_CROP)) > 0.8)
                                 * rng.integers(1, 5, (VARIANT_BATCH, VARIANT_CROP,
                                                       VARIANT_CROP))).astype(np.uint8)).cuda()
    valid = torch.ones(VARIANT_BATCH, device="cuda")
    launches["variants"] = dict.fromkeys(_read_counters(), 0)
    for dmg_model, loss_str, k2 in VARIANTS:
        tag = f"{dmg_model} {loss_str} (ResNet-50)"
        cfg = Config(type="post", dmg_model=dmg_model, encoder="resnet50", precision=16,
                     loss_str=loss_str, batch_size=VARIANT_BATCH, optimizer="adamw",
                     fused_tail=True)
        model = seeded_model(cfg, seed=0)
        before = {k: v.clone() for k, v in model.named_parameters()}
        opt = build_optimizer(cfg, model.parameters(), cfg.lr)
        state = init_train_state(model, opt, device="cuda")
        step = make_train_step(cfg, model, opt, crop=VARIANT_CROP, device="cuda")
        _zero_counters()
        loss = float(step(state, images, masks, step_generator(cfg, 0, "cuda"))[1])
        torch.cuda.synchronize()
        train_launches = _read_counters()
        moved = sum(not torch.equal(v.cpu(), before[k]) for k, v in model.named_parameters())

        def train_step():
            step(state, images, masks, step_generator(cfg, state.step, "cuda"))

        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(train_step, 3)
        rows[f"{tag} train"] = {"ms": ms, "tiles_per_s": VARIANT_BATCH / ms * 1e3,
                                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if profile:
            profile_step(train_step, f"train step, {tag}")
        outs, eval_launches = {}, {}
        for fused in (False, True):  # the fused eval step last: it is timed below
            ecfg = cfg.replace(tta=True, fused_tail=fused)
            f1 = init_f1_state(ecfg.n_metric_class, device="cuda")
            eval_step = make_eval_step(ecfg, model, device="cuda")
            _zero_counters()
            _, eloss, outs[fused] = eval_step(f1, ev_images, ev_masks, valid)
            torch.cuda.synchronize()
            eval_launches[fused] = _read_counters()
            outs[fused] = outs[fused].float()
            if not math.isfinite(float(eloss)):
                raise AssertionError(f"{tag}: eval loss is not finite")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: eval_step(f1, ev_images, ev_masks, valid), 3)
        rows[f"{tag} eval fused"] = {"ms": ms, "tiles_per_s": VARIANT_BATCH / ms * 1e3,
                                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        groups = 2 if dmg_model == "parallel" else 1
        c, co = 128 * groups, 4 * (1 if cfg.n_class == 3 else cfg.n_class)
        variant = pfc.kernel_variant("head_conv_fused", VARIANT_CROP // 2, VARIANT_CROP // 2, c,
                                     co, torch.bfloat16)
        log(f"variant {tag}: train step loss {loss:.6f}, {moved} of {len(before)} parameters "
            f"moved, then {rows[tag + ' train']['ms']:.2f} ms a step (batch {VARIANT_BATCH} "
            f"of {VARIANT_CROP}^2 crops, peak {rows[tag + ' train']['peak_gib']:.2f} GiB); "
            f"eval step (TTA, fused tail) {rows[tag + ' eval fused']['ms']:.2f} ms; "
            f"launches {_nonzero(train_launches)}; eval step (TTA) launches fused "
            f"{_nonzero(eval_launches[True])}, stock {_nonzero(eval_launches[False])}; K3 at "
            f"C = {c}, Co = {co} [{variant}]")
        _check_fused_vs_stock(outs, f"variant {tag} eval step")
        if not (math.isfinite(loss) and moved >= 0.9 * len(before)):
            raise AssertionError(f"{tag}: loss {loss}, {moved} of {len(before)} parameters moved")
        if "mma.sync" not in variant:
            raise AssertionError(f"{tag}: K3 at C = {c}, Co = {co} took '{variant}'")
        _need_launches(train_launches, {"relayout_cuda": 3, "conv_bn_fused": k2,
                                        "head_conv_fused": 1, "conv_bn_wgrad": k2,
                                        "conv_bn_dgrad": k2}, f"{tag} train")
        _need_launches(eval_launches[True], {"relayout_cuda": 1, "conv_bn_fused": k2,
                                             "head_conv_fused": 1}, f"{tag} eval")
        for d in (train_launches, eval_launches[True], eval_launches[False]):
            for k, v in d.items():
                launches["variants"][k] += v
        del model, opt, state, step, before, outs
        torch.cuda.empty_cache()
    del images, masks, ev_images, ev_masks
    torch.cuda.empty_cache()

    check_f32_train_step_against_cpu(
        Config(type="post", dmg_model="fused", encoder="resnet50", loss_str="coral",
               precision=32), b=4, size=128, tag=" (C: ResNet-50 fused + CORAL)", spread=True,
        noise_floor=True)
    check_autoaugment_against_cpu(6)
    return launches, rows


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


# configuration D, BASELINE config 2 (tools/roofline_configs.py:61-64): ResNeSt-50
# UNetLoc with the attention gates, deep supervision and --autoaugment at
# batch 16, 512^2 crops; per train step K2 at dec_l2, dec_l3 (after their
# gates) and the packed dec_l5 (two each), a K4 and a K5 behind each, the
# fused head once; K1 eight times: both label views (packed and fine), the
# three outputs [out, ds4, ds3] and their three cotangents
D_NEED = {"relayout_cuda": 8, "conv_bn_fused": 6, "head_conv_fused": 1, "conv_bn_wgrad": 6,
          "conv_bn_dgrad": 6}
D_BASE = dict(type="pre", encoder="resnest50", attention=True, deep_supervision=True)
# the other options, small: (tag, Config kwargs, crop, K1/K2/K3 per train step,
# K1/K2/K3 per eval step).  --dec_interp leaves the fine dec_l5 (C = 32) and
# its fine head on the stock route, as supported() refuses C = 32; --interpolate
# has no decoder; parallelEnc's doubled dec_l2 (C = 1280) stays stock; the
# fused variant's dec_interp tail fuses dec_l2 and dec_l3 of both branches
OPTION_RUNS = (
    ("--ppm", dict(type="pre", ppm=True), VARIANT_CROP, (3, 6, 1), (1, 6, 1)),
    ("--aspp --dilation 2", dict(type="pre", aspp=True, dilation=2), VARIANT_CROP, (3, 6, 1),
     (1, 6, 1)),
    ("--dec_interp", dict(type="pre", dec_interp=True), VARIANT_CROP, (3, 4, 0), (1, 4, 0)),
    ("--interpolate", dict(type="pre", interpolate=True), CROP, (3, 0, 0), (1, 0, 0)),
    ("parallelEnc --ppm --deep_supervision coral",
     dict(type="post", dmg_model="parallelEnc", ppm=True, deep_supervision=True,
          loss_str="coral"), VARIANT_CROP, (8, 4, 1), (1, 4, 1)),
    ("fused --dec_interp --attention --deep_supervision",
     dict(type="post", dmg_model="fused", dec_interp=True, attention=True,
          deep_supervision=True), VARIANT_CROP, (7, 8, 0), (1, 8, 0)),
)


def check_relayout_ds() -> dict:
    """K1 at configuration D's eight launches per train step: the packed
    labels (16, 256, 1024) and the fine labels (16, 512, 512) int32, and the
    three outputs (16, 256, 1024, 2), (16, 256, 256, 2), (16, 128, 128, 2)
    bf16 with their cotangents; bit-exact, timed by CUDA events beside the
    plain version, ``clone`` and the bound.  Returns the ``ds_train_`` keys."""
    import torch

    from xview2_tpu_torch.ops import layout

    gen = torch.Generator(device="cuda").manual_seed(4)
    b = TRAIN_BATCH
    tensors = [(torch.randint(0, 2, shape, generator=gen, device="cuda", dtype=torch.int32), 1)
               for shape in ((b, CROP // 2, 2 * CROP), (b, CROP, CROP))]
    tensors += [(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16), 2)
                for shape in ((b, CROP // 2, 2 * CROP, 2), (b, CROP // 2, CROP // 2, 2),
                              (b, CROP // 4, CROP // 4, 2))]
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for x, count in tensors:
        got = layout.relayout_cuda(x)
        torch.cuda.synchronize()
        if not (got.is_contiguous() and torch.equal(got, x)):
            raise AssertionError(f"K1 {tuple(x.shape)} {x.dtype}: not a bit-exact copy")
        row["ms"] += count * cuda_ms(lambda: layout.relayout_cuda(x), 20)
        row["plain_ms"] += count * cuda_ms(lambda: layout.relayout_reference(x), 20)
        row["library_ms"] += count * cuda_ms(lambda: x.clone(), 20)
        row["bound_ms"] += count * bound_ms(2 * x.numel() * x.element_size(), 0.0,
                                            "float32")[0]
    log(f"K1 relayout per D train step ({sum(c for _, c in tensors)} launches: "
        f"{', '.join(f'{tuple(x.shape)} x{c}' for x, c in tensors)}): bit-exact; kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library (clone) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes)")
    return {f"ds_train_{k}": v for k, v in row.items()}


def check_ds_outputs(cfg) -> None:
    """The train-mode outputs of ``cfg`` (deep supervision, bf16, fused tail)
    on 2 crops of CROP^2 on the card: the list [out, ds4, ds3] in the
    packed loss view and on dec4's and dec3's grids, all finite."""
    import torch

    from xview2_tpu_torch.models.layers import fused_tail_scope
    from xview2_tpu_torch.models.unet import fused_head_defer_ok

    model = seeded_model(cfg, seed=4).cuda()
    x = torch.randn((2, CROP, CROP, cfg.in_channels), device="cuda")
    with torch.no_grad(), fused_tail_scope(True, defer_head=fused_head_defer_ok(cfg)):
        outs = model(x, True)
    shapes = [tuple(o.shape) for o in outs]
    n = cfg.n_class
    want = [(2, CROP // 2, 2 * CROP, n), (2, CROP // 2, CROP // 2, n), (2, CROP // 4, CROP // 4, n)]
    finite = [bool(torch.isfinite(o).all()) for o in outs]
    log(f"D's train-mode outputs on the card: {shapes}, finite {finite}")
    if shapes != want or not all(finite):
        raise AssertionError(f"deep-supervision outputs {shapes} (expected {want}), "
                             f"finite {finite}")
    del model


def run_decoder_options_path(work: str, profile: bool):
    """Configuration D, BASELINE's config 2, through the CLI at full width:
    ``main([--exec_mode train --encoder resnest50 --attention
    --deep_supervision --autoaugment --fused_tail 1 --batch_size 16])`` on the
    synthetic train split (torch's initializers from --seed; no checkpoint of
    another phase is read), then ``main([--exec_mode eval --eval_tta on
    --eval_fused_tail on])`` of its best checkpoint on the 1024^2 holdout at
    val batch 4 with its (1024, 1024) probability dumps, each with the
    counters from 0 (``D_NEED`` per train step, K6 at least once); D's train
    step (fused and stock tail) and eval step (fused against stock) on
    device-resident batches; its train-mode outputs; its float32 eval and
    train steps against the CPU.  Then each of OPTION_RUNS (ResNet-50,
    VARIANT_BATCH tiles or pairs): one train step and one TTA eval step with
    their launches, a finite loss, moved parameters and fused against stock
    eval, and its float32 eval step against the CPU; the --interpolate model
    also through the eval CLI on the holdout, its dumps (1024, 1024).
    Returns ({path: launch counts}, {row: steady-state numbers})."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.main import main as port_main
    from xview2_tpu_torch.ops.metrics import init_f1_state
    from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
    from xview2_tpu_torch.parallel.steps import (init_train_state, make_eval_step,
                                                 make_train_step, step_generator)
    from xview2_tpu_torch.train.optimizers import build_optimizer
    from xview2_tpu_torch.weights import to_flax

    write_splits(work)
    launches, rows = {}, {}
    launches["D train"] = _drive_train_cli(
        work, "dmg_d", ["--encoder", "resnest50", "--attention", "--deep_supervision",
                        "--autoaugment"], {"row_shift_cuda": 1},
        "D (ResNeSt-50 + attention + deep supervision + --autoaugment) train",
        need_per_step=D_NEED)
    torch.cuda.empty_cache()

    def eval_cli(results, ckpt, tag, need):
        argv = ["--exec_mode", "eval", "--type", "pre", "--data", work, "--results", results,
                "--ckpt", ckpt, "--val_batch_size", str(VAL_BATCH), "--num_workers", "8",
                "--eval_tta", "on", "--eval_fused_tail", "on"]
        _zero_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = port_main(argv, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read_counters()
        if rc != 0:
            raise AssertionError(f"main returned {rc}")
        steps = N_TILES // VAL_BATCH
        _need_launches(got, {k: n * steps for k, n in need.items()}, tag)
        probs = sorted(glob.glob(os.path.join(results, "probs", "test_localization_*.npy")))
        if len(probs) != N_TILES:
            raise AssertionError(f"{tag}: expected {N_TILES} dumps, got {len(probs)}")
        for path in probs:
            prob = np.load(path)
            if prob.shape != (TILE, TILE) or prob.dtype != np.float32 or \
                    not np.isfinite(prob).all() or prob.min() < 0 or prob.max() > 1:
                raise AssertionError(f"{path}: bad probabilities {prob.shape} {prob.dtype}")
        with open(os.path.join(results, "logs.json")) as f:
            metrics = json.loads(f.readlines()[-1])["data"]
        log(f"{tag} main path: main(--exec_mode eval --eval_tta on --eval_fused_tail on, "
            f"{N_TILES} tiles of {TILE}^2) {wall:.2f} s end to end, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {_nonzero(got)}; "
            f"{len(probs)} ({TILE}, {TILE}) float32 probability dumps; metrics {metrics}")
        return got

    res_d = os.path.join(work, "dmg_d")
    launches["D eval"] = eval_cli(res_d, os.path.join(res_d, "checkpoints", "best"), "D eval",
                                  {"relayout_cuda": 1, "conv_bn_fused": 6,
                                   "head_conv_fused": 1})
    shutil.rmtree(os.path.join(res_d, "checkpoints"))

    # D's steady state on device-resident batches
    d_cfg = Config(precision=16, loss_str="focal+dice", batch_size=TRAIN_BATCH,
                   optimizer="adamw", fused_tail=True, autoaugment=True, **D_BASE)
    images, masks = _raw_train_batch()
    for fused in (True, False):
        rows[f"D train {'fused' if fused else 'stock'}"] = _time_train_step(
            d_cfg.replace(fused_tail=fused), images, masks, profile,
            f"D ResNeSt-50 + attention + DS + --autoaugment, {'fused' if fused else 'stock'} "
            "tail")
    # what the gates and the DS heads add: the same step without them
    rows["D without gates and DS train fused"] = _time_train_step(
        d_cfg.replace(attention=False, deep_supervision=False), images, masks, profile,
        "ResNeSt-50 + --autoaugment without the gates and the DS heads, fused tail")
    del images, masks
    torch.cuda.empty_cache()
    model = seeded_model(d_cfg.replace(tta=True), seed=0).cuda()
    outs = {}
    for fused in (True, False):
        rows[f"D eval {'fused' if fused else 'stock'}"], outs[fused] = _time_eval_step(
            d_cfg.replace(tta=True, fused_tail=fused), model, 3, profile,
            f"D ResNeSt-50 + attention + DS, {'fused' if fused else 'stock'} tail")
    _check_fused_vs_stock(outs, "D eval step")
    bare = d_cfg.replace(tta=True, attention=False, deep_supervision=False)
    rows["D without gates eval fused"], _ = _time_eval_step(
        bare, seeded_model(bare, seed=0).cuda(), 3, profile,
        "ResNeSt-50 without the gates, fused tail")
    del model, outs
    torch.cuda.empty_cache()
    check_ds_outputs(d_cfg)
    check_f32_against_cpu(Config(**D_BASE), " (D: ResNeSt-50 + attention + DS)")
    check_f32_train_step_against_cpu(Config(precision=32, **D_BASE), b=4, size=256,
                                     tag=" (D: ResNeSt-50 + attention + DS)", spread=True)

    # the other options, small
    rng = np.random.default_rng(29)
    launches["options"] = dict.fromkeys(_read_counters(), 0)
    for tag, kw, crop, need_train, need_eval in OPTION_RUNS:
        cfg = Config(encoder="resnet50", precision=16, batch_size=VARIANT_BATCH,
                     optimizer="adamw", fused_tail=True, **kw)
        ch = cfg.in_channels
        images, masks = _raw_train_batch(VARIANT_BATCH, ch)
        model = seeded_model(cfg, seed=0)
        before = {k: v.clone() for k, v in model.named_parameters()}
        opt = build_optimizer(cfg, model.parameters(), cfg.lr)
        state = init_train_state(model, opt, device="cuda")
        step = make_train_step(cfg, model, opt, crop=crop, device="cuda")
        _zero_counters()
        loss = float(step(state, images, masks, step_generator(cfg, 0, "cuda"))[1])
        torch.cuda.synchronize()
        train_launches = _read_counters()
        moved = sum(not torch.equal(v.cpu(), before[k]) for k, v in model.named_parameters())
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, images, masks,
                                  step_generator(cfg, state.step, "cuda")), 3)
        rows[f"{tag} train"] = {"ms": ms, "tiles_per_s": VARIANT_BATCH / ms * 1e3,
                                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        msize = TILE if cfg.interpolate else VARIANT_CROP
        ev_images = torch.from_numpy(rng.integers(0, 256, (VARIANT_BATCH, VARIANT_CROP,
                                                           VARIANT_CROP, ch), np.uint8)).cuda()
        hi = 5 if cfg.type == "post" else 2
        ev_masks = torch.from_numpy(((rng.random((VARIANT_BATCH, msize, msize)) > 0.8)
                                     * rng.integers(1, hi, (VARIANT_BATCH, msize, msize)))
                                    .astype(np.uint8)).cuda()
        valid = torch.ones(VARIANT_BATCH, device="cuda")
        outs, eval_launches = {}, {}
        for fused in (False, True):
            ecfg = cfg.replace(tta=True, fused_tail=fused)
            eval_step = make_eval_step(ecfg, model, device="cuda")
            _zero_counters()
            _, eloss, outs[fused] = eval_step(init_f1_state(ecfg.n_metric_class, device="cuda"),
                                              ev_images, ev_masks, valid)
            torch.cuda.synchronize()
            eval_launches[fused] = _read_counters()
            outs[fused] = outs[fused].float()
            if not math.isfinite(float(eloss)):
                raise AssertionError(f"{tag}: eval loss is not finite")
        f1 = init_f1_state(cfg.n_metric_class, device="cuda")
        rows[f"{tag} eval fused"] = {"ms": cuda_ms(lambda: eval_step(f1, ev_images, ev_masks,
                                                                     valid), 3)}
        log(f"option {tag} (ResNet-50, batch {VARIANT_BATCH}, {crop}^2 crops): train step loss "
            f"{loss:.6f}, {moved} of {len(before)} parameters moved, then "
            f"{rows[tag + ' train']['ms']:.2f} ms a step (peak "
            f"{rows[tag + ' train']['peak_gib']:.2f} GiB); eval step (TTA, fused tail, "
            f"{VARIANT_CROP}^2 -> logits {tuple(outs[True].shape)}) "
            f"{rows[tag + ' eval fused']['ms']:.2f} ms; launches {_nonzero(train_launches)}; "
            f"eval launches fused {_nonzero(eval_launches[True])}, stock "
            f"{_nonzero(eval_launches[False])}")
        _check_fused_vs_stock(outs, f"option {tag} eval step")
        if not (math.isfinite(loss) and moved >= 0.9 * len(before)):
            raise AssertionError(f"{tag}: loss {loss}, {moved} of {len(before)} parameters moved")
        names = ("relayout_cuda", "conv_bn_fused", "head_conv_fused")
        _need_launches(train_launches, dict(zip(names, need_train), conv_bn_wgrad=need_train[1],
                                            conv_bn_dgrad=need_train[1]), f"{tag} train")
        _need_launches(eval_launches[True], dict(zip(names, need_eval)), f"{tag} eval")
        for d in (train_launches, eval_launches[True], eval_launches[False]):
            for k, v in d.items():
                launches["options"][k] += v
        if cfg.interpolate:
            ckpt = os.path.join(work, "interp_ckpt")
            ckpt_lib.save_checkpoint(ckpt, *to_flax(model.state_dict()), epoch=0, best_f1=0.0,
                                     best_epoch=0, cfg=cfg.replace(tta=True))
            launches["interpolate eval"] = eval_cli(os.path.join(work, "interp_results"), ckpt,
                                                    "--interpolate eval", {"relayout_cuda": 1})
        del model, opt, state, step, before, outs, images, masks
        torch.cuda.empty_cache()
        check_f32_against_cpu(cfg.replace(precision=32), f" ({tag})")
    return launches, rows


# --------------------------------------------------------------- the recipe

RECIPE_OPTIMIZERS = ("radam", "adabelief", "adabound", "adamp", "novograd")
REMAT_MODES = ("none", "tail", "dots", "full")
SUBTYPES = {1: "no-damage", 2: "minor-damage", 3: "major-damage", 4: "destroyed"}


def release_encoder_pth(arch: str, path: str, seed: int) -> int:
    """Write a ``.pth`` of ``arch``'s encoder in the release's key names,
    drawn from ``seed`` (conv weights N(0, 1.1^2 / fan_in), BN statistics and
    affines away from the identity); returns its number of tensors."""
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.models.convert_weights import release_key
    from xview2_tpu_torch.models.unet import build_model

    with torch.device("meta"):
        shapes = build_model(Config(type="pre", encoder=arch)).state_dict()
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in shapes.items():
        if not k.startswith("unet.enc_l"):
            continue
        if t.dim() == 4:
            v = torch.randn(t.shape, generator=gen) * (1.1 / math.sqrt(math.prod(t.shape[1:])))
        elif k.endswith("running_var") or k.endswith("weight"):
            v = torch.rand(t.shape, generator=gen) + 0.5
        else:
            v = torch.randn(t.shape, generator=gen) * 0.1
        sd[release_key(k[len("unet."):], arch)] = v
    torch.save(sd, path)
    return len(sd)


def _eval_cli(work: str, results: str, ckpt: str, task: str, need: dict, tag: str) -> dict:
    """``main([--exec_mode eval --eval_tta on ...])`` on the holdout split with
    the counters from 0; its dumps are checked.  Returns the launch counts."""
    import numpy as np
    import torch

    from xview2_tpu_torch.main import main as port_main

    argv = ["--exec_mode", "eval", "--type", task, "--data", work, "--results", results,
            "--ckpt", ckpt, "--val_batch_size", str(VAL_BATCH), "--num_workers", "8",
            "--eval_tta", "on"]
    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = port_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counters()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    steps = N_TILES // VAL_BATCH
    _need_launches(got, {k: n * steps for k, n in need.items()}, tag)
    name = "localization" if task == "pre" else "damage"
    probs = sorted(glob.glob(os.path.join(results, "probs", f"test_{name}_*.npy")))
    if len(probs) != N_TILES or not all(np.isfinite(np.load(p)).all() for p in probs):
        raise AssertionError(f"{tag}: expected {N_TILES} finite dumps, got {len(probs)}")
    log(f"{tag} main path: main(--exec_mode eval --type {task} --eval_tta on, {N_TILES} "
        f"tiles) {wall:.2f} s end to end; launches {_nonzero(got)}; {len(probs)} dumps")
    return got


def check_optimizers_on_card(names=RECIPE_OPTIMIZERS + ("adamw",), dev: str = "cuda") -> dict:
    """Each optimizer's float32 update of the ResNet-50 UNetLoc's parameters
    on the card against the CPU's, from the same two gradients (seeded, of
    two scales); then the update alone by CUDA events (3 after 1 warm-up).
    Tolerance: every leaf's movement within 1e-4 of its largest (sums and
    divisions in another order) plus 4 float32 ulps of the leaf's largest
    weight (the movement is read off the updated float32 weights, each
    rounded on its own)."""
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.train.optimizers import build_optimizer

    model = seeded_model(Config(type="pre", encoder="resnet50", precision=32), seed=0)
    start = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator().manual_seed(31)
    grads = [[torch.randn(p.shape, generator=gen) * scale for p in start]
             for scale in (1e-2, 1e-3)]
    rows = {}
    for name in names:
        cfg = Config(type="pre", encoder="resnet50", optimizer=name, weight_decay=1e-4)
        moved = {}
        for i, where in enumerate(("cpu", dev)):
            ps = [torch.nn.Parameter(p.to(where, copy=True)) for p in start]
            opt = build_optimizer(cfg, ps, cfg.lr)
            for g in grads:
                for p, gi in zip(ps, g):
                    p.grad = gi.to(where)
                opt.step()
            moved[i] = [p.detach().cpu() - p0 for p, p0 in zip(ps, start)]
        ms = cuda_ms(opt.step, 3)
        ulp = torch.finfo(torch.float32).eps
        err = max(float((a - b).abs().max()
                        / (1e-4 * b.abs().max() + 4 * ulp * p0.abs().max()).clamp_min(1e-30))
                  for a, b, p0 in zip(moved[1], moved[0], start))
        rows[name] = {"update_ms": ms, "max_err_of_tolerance": err}
        log(f"optimizer {name}: float32 update of {len(start)} tensors "
            f"({sum(p.numel() for p in start) / 1e6:.1f} M parameters) on the card against the "
            f"CPU, two updates: worst leaf at {err:.3g} of its tolerance (1e-4 of its movement "
            f"+ 4 ulps of its weights); one update {ms:.3f} ms by CUDA events")
        if not err <= 1.0:
            raise AssertionError(f"optimizer {name}: the card's update differs from the CPU's")
        del ps, opt, moved
        torch.cuda.empty_cache()
    return rows


def check_remat_running_stats(dev: str = "cuda") -> str:
    """float32 (TF32 off), ResNet-50 UNetLoc, 4 crops of 256^2, the fused
    tail through the f32 kernels: one forward, loss and backward under each
    remat mode from the same weights; every running statistic against the
    run without remat (``tail`` against the stock tail it runs on), within
    1e-3 of that run's own movement of the statistic (K2 adds its sums with
    atomics, so two runs differ by float32 rounding; a second update would
    move them by 0.9 of it).  Under ``dots`` and ``full`` the fused conv's
    outputs in the recomputation must EQUAL the first forward's."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.models.layers import remat_tail_scope
    from xview2_tpu_torch.ops import packed_fused_conv as pfc
    from xview2_tpu_torch.ops.layout import relayout_standard
    from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels
    from xview2_tpu_torch.parallel.steps import forward_loss, rematerialized

    base = Config(type="pre", encoder="resnet50", precision=32, loss_str="focal+dice")
    apply_precision(base)
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(size=(4, 256, 256, 3)).astype(np.float32)).to(dev)
    y = relayout_standard(packed_loss_view_labels(torch.from_numpy(
        (rng.random((4, 256, 256)) > 0.7).astype(np.int32)).to(dev)))
    real = pfc._conv_bn_forward

    def run(mode, fused):
        cfg = base.replace(remat=mode, fused_tail=fused)
        model = seeded_model(cfg, seed=0).to(dev)
        before = {k: v.clone() for k, v in model.named_buffers()}
        outs = []
        pfc._conv_bn_forward = lambda *a: (lambda r: outs.append(r[0].clone()) or r)(real(*a))
        try:
            loss_of = rematerialized(
                lambda *a: forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type), *a),
                mode)
            with remat_tail_scope(mode == "tail"):
                loss = loss_of(x, y, y)
            loss.backward()
        finally:
            pfc._conv_bn_forward = real
        return before, dict(model.named_buffers()), outs

    ref = {fused: run("none", fused) for fused in (True, False)}
    lines = []
    for mode in REMAT_MODES[1:]:
        fused = mode != "tail"
        before, want, outs0 = ref[fused]
        _, got, outs = run(mode, fused)
        worst = max(float((got[k] - want[k]).abs().max()
                          / (want[k] - before[k]).abs().max().clamp_min(1e-30)) for k in want)
        n = len(outs0)
        replay = all(torch.equal(a, b) for a, b in zip(outs[:n], outs[n:]))
        lines.append(f"{mode}: {len(want)} statistics within {worst:.3g} of their movement"
                     + (f", the fused conv launched {len(outs)} times for {n}, the recomputed "
                        f"outputs {'EQUAL' if replay else 'NOT equal'} to the first forward's"
                        if fused else ""))
        if not worst <= 1e-3 or (fused and (len(outs) != 2 * n or n == 0 or not replay)):
            raise AssertionError(f"--remat {mode}: running statistics or the recomputation "
                                 f"differ from the step without remat ({lines[-1]})")
    msg = "; ".join(lines)
    log(f"--remat running statistics after one float32 step (ResNet-50, 4 x 256^2, the card): "
        f"{msg}")
    return msg


def check_fold_eval_bn(cfg, tag: str, profile: bool) -> dict:
    """``--fold_eval_bn 0`` against the fold on one seeded model of ``cfg``
    (TTA, fused tail) and the eval step's batch: both bfloat16 steps by CUDA
    events with peak memory, and the same weights in float32 (TF32 off),
    where the two are one affine in another order.  Gates: in float32 the
    two within 1e-4 of the logits' scale; the bfloat16 stock step against
    the float32 one within the smoke's bf16 gates (max |diff| <= 0.05 *
    max|logit|, argmax agreement >= 0.99) or, where the bfloat16 fold itself
    is outside them (its distance from float32 is the model's bf16 noise:
    D's seeded ResNeSt-50 with the gates reads about 0.29 of the scale and
    98% argmax), no farther from float32 than 1.25 times the fold, in both
    numbers.  The two bfloat16 steps against each other are printed: the
    fold rounds to bf16 after each of its three ops, the stock normalize
    once."""
    import torch

    from xview2_tpu_torch.config import apply_precision

    rows, outs = {}, {}
    model = seeded_model(cfg, seed=0).cuda()
    for fold in (True, False):
        rows[f"{tag} eval fold_eval_bn {int(fold)}"], outs[fold] = _time_eval_step(
            cfg.replace(fold_eval_bn=fold), model, 3, profile,
            f"{tag}, --fold_eval_bn {int(fold)}")
    del model
    torch.cuda.empty_cache()
    f32 = cfg.replace(precision=32)
    apply_precision(f32)
    model = seeded_model(f32, seed=0).cuda()
    ref = {fold: _time_eval_step(f32.replace(fold_eval_bn=fold), model, 3, False,
                                 f"{tag} float32, --fold_eval_bn {int(fold)}")[1]
           for fold in (True, False)}
    del model
    torch.cuda.empty_cache()

    def dist(got, want):
        scale = want.abs().max().item()
        return ((got - want).abs().max().item() / scale,
                (got.argmax(-1) == want.argmax(-1)).float().mean().item())

    d32 = dist(ref[False], ref[True])
    d_stock, d_fold, d_bf16 = dist(outs[False], ref[False]), dist(outs[True], ref[False]), \
        dist(outs[False], outs[True])
    log(f"{tag} eval step, --fold_eval_bn 0 against the fold: float32 max |diff| "
        f"{d32[0]:.3g} of the scale, argmax {d32[1]:.5f} (gate 1e-4); against the float32 "
        f"stock step, bf16 stock {d_stock[0]:.4g} of the scale, argmax {d_stock[1]:.5f}, bf16 "
        f"fold {d_fold[0]:.4g}, argmax {d_fold[1]:.5f} (gates 0.05, 0.99); bf16 stock against "
        f"bf16 fold {d_bf16[0]:.4g}, argmax {d_bf16[1]:.5f}")
    plain = d_stock[0] <= 0.05 and d_stock[1] >= 0.99
    floor = d_stock[0] <= 1.25 * d_fold[0] and 1 - d_stock[1] <= 1.25 * (1 - d_fold[1])
    log(f"{tag}: " + ("the bf16 gates hold" if plain else "the fold's bf16 noise floor holds"
                      if floor else "no gate holds"))
    if not (d32[0] <= 1e-4 and (plain or floor)):
        raise AssertionError(f"{tag}: --fold_eval_bn 0 disagrees with the fold")
    rows[f"{tag} fold_eval_bn 0 against the fold"] = {
        "f32": d32, "bf16_stock_vs_f32": d_stock, "bf16_fold_vs_f32": d_fold,
        "bf16_stock_vs_bf16_fold": d_bf16}
    return rows


def synthetic_labels(root: str, split: str, n: int, seed: int, size: int = TILE) -> str:
    """Label JSONs whose polygons rasterize to ``make_synthetic_split``'s
    targets: its draws replayed, each building the rectangle it fills, later
    ones over earlier ones.  Returns the split directory holding labels/."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = os.path.join(root, "labels")
    os.makedirs(out, exist_ok=True)
    for i in range(n):
        rng.integers(0, 256, (size, size, 3), np.uint8)  # the images' draws
        rng.integers(-20, 20)
        feats = []
        for _ in range(rng.integers(2, 6)):
            h0, w0 = int(rng.integers(0, size - 64)), int(rng.integers(0, size - 64))
            hh, ww = int(rng.integers(16, 64)), int(rng.integers(16, 64))
            dmg = int(rng.integers(1, 5))
            x1, y1 = w0 + ww - 1, h0 + hh - 1
            feats.append({"wkt": f"POLYGON (({w0} {h0}, {x1} {h0}, {x1} {y1}, {w0} {y1}, "
                                 f"{w0} {h0}))", "properties": {"subtype": SUBTYPES[dmg]}})
        for mode in ("pre", "post"):
            name = f"synth-{split}_{i:08d}_{mode}_disaster.json"
            with open(os.path.join(out, name), "w") as f:
                json.dump({"features": {"xy": feats}}, f)
    return root


def run_score_chain(work: str) -> dict:
    """The offline chain on the card's own eval dumps: A's localization dumps
    (``recipe_a``) with B's damage dumps (``dmg_b``) and with C's CORAL class
    dumps (``dmg_c``), each through ``post_process`` plain and with
    ``--components --dilate``, then the scorer, which writes the score JSON;
    and ``convert2png`` on label JSONs replaying the holdout's draws, whose
    masks must EQUAL the eval's target PNGs."""
    import numpy as np
    from PIL import Image

    from xview2_tpu_torch.data import convert2png
    from xview2_tpu_torch.utils import post_process, xview2_metrics

    scores = {}
    res_a = os.path.join(work, "recipe_a")
    for tag, res_dmg in (("A+B", os.path.join(work, "dmg_b")),
                         ("A+C", os.path.join(work, "dmg_c"))):
        chain = os.path.join(work, f"score_{tag}")
        for sub, task, res in (("probs", "localization", res_a), ("probs", "damage", res_dmg),
                               ("targets", "localization", res_a),
                               ("targets", "damage", res_dmg)):
            os.makedirs(os.path.join(chain, sub), exist_ok=True)
            files = sorted(glob.glob(os.path.join(res, sub, f"test_{task}_*")))
            if len(files) != N_TILES:
                raise AssertionError(f"score chain {tag}: {len(files)} {task} {sub} in {res}")
            for p in files:
                shutil.copy(p, os.path.join(chain, sub))
        for flags in ([], ["--components", "--dilate"]):
            t0 = time.perf_counter()
            post_process.main(["--results", chain] + flags)
            t1 = time.perf_counter()
            out = os.path.join(chain, f"score{''.join(flags)}.json")
            xview2_metrics.main([os.path.join(chain, "predictions"),
                                 os.path.join(chain, "targets"), out])
            with open(out) as f:
                score = json.load(f)
            key = f"{tag} {' '.join(flags) or 'plain'}"
            scores[key] = score
            log(f"score chain {key}: post_process {t1 - t0:.2f} s, scorer "
                f"{time.perf_counter() - t1:.2f} s ({N_TILES} tiles); {json.dumps(score)}")
            if sorted(score) != sorted(["score", "damage_f1", "localization_f1",
                                        "damage_f1_no_damage", "damage_f1_minor_damage",
                                        "damage_f1_major_damage", "damage_f1_destroyed"]) or \
                    not all(0.0 <= v <= 1.0 for v in score.values()):
                raise AssertionError(f"score chain {key}: bad score JSON {score}")
    labels = synthetic_labels(os.path.join(work, "labels_holdout"), "holdout", N_TILES, seed=7)
    convert2png.main(["--data", labels])
    for task, mode, res in (("localization", "pre", res_a),
                            ("damage", "post", os.path.join(work, "dmg_b"))):
        got = sorted(glob.glob(os.path.join(labels, "targets", f"*_{mode}_disaster.png")))
        want = sorted(glob.glob(os.path.join(res, "targets", f"test_{task}_*_target.png")))
        differ = [os.path.basename(g) for g, w in zip(got, want)
                  if not np.array_equal(np.array(Image.open(g)), np.array(Image.open(w)))]
        log(f"convert2png: {len(got)} {mode} masks from label JSONs against the eval's "
            f"{len(want)} {task} targets: {len(differ)} differ")
        if len(got) != N_TILES or len(want) != N_TILES or differ:
            raise AssertionError(f"convert2png: the {mode} masks differ from the targets: "
                                 f"{differ}")
    return scores


def run_recipe_path(work: str, profile: bool, c_peak_gib=None):
    """The reference's recipe and its score.  A from a converted
    ``--pretrained_enc``: a ResNeSt-200 release state dict from a seed,
    converted by ``python -m xview2_tpu_torch.models.convert_weights``'s
    ``main``, then ``main([--exec_mode train --pretrained_enc ...])`` at batch
    DMG_A_BATCH with every grafted tensor held EQUAL to the ``.npz`` (the
    trainer's call watched), and A's eval CLI.  The five optimizers' ResNet-50
    train steps (batch 16, 512^2 crops, fused tail) and each one's float32
    update against the CPU; the four remat modes' steps (K2/K4/K5 per step),
    C under ``--remat full`` (its peak beside ``c_peak_gib``, C's without
    remat in this run) and the running statistics under each mode against
    the step without it; the ResNet-50 and D eval steps with ``--fold_eval_bn
    0`` against the fold; the score chain.  Returns ({path: launch counts},
    rows)."""
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.models.convert_weights import main as convert_main
    from xview2_tpu_torch.models.pretrained import encoder_state
    from xview2_tpu_torch.train import trainer

    write_splits(work)
    launches, rows = {}, {}
    pth, npz = os.path.join(work, "resnest200.pth"), os.path.join(work, "resnest200.npz")
    t0 = time.perf_counter()
    n_release = release_encoder_pth("resnest200", pth, seed=5)
    if convert_main(["--arch", "resnest200", "--pth", pth, "--out", npz]) != 0:
        raise AssertionError("the converter failed")
    want = encoder_state(npz)
    log(f"recipe: a ResNeSt-200 release state dict of {n_release} tensors from a seed, "
        f"converted in {time.perf_counter() - t0:.1f} s to {len(want)} encoder tensors")
    seen = {}
    real = trainer.apply_pretrained_encoder

    def watched(model, path, variant):
        copied = real(model, path, variant)
        sd = model.state_dict()
        seen["copied"] = copied
        seen["differ"] = [k for k in want if not torch.equal(sd[k].cpu(), want[k])]
        return copied

    trainer.apply_pretrained_encoder = watched
    try:
        launches["A train"] = _drive_train_cli(
            work, "recipe_a", ["--pretrained_enc", npz], {},
            "A (ResNeSt-200 UNetLoc, --pretrained_enc) train", batch=DMG_A_BATCH)
    finally:
        trainer.apply_pretrained_encoder = real
    log(f"A's --pretrained_enc: {len(seen.get('copied', []))} tensors grafted of {len(want)}; "
        f"{len(seen.get('differ', want))} differ from the .npz before the first step")
    if sorted(seen.get("copied", [])) != sorted(want) or seen["differ"]:
        raise AssertionError("--pretrained_enc did not graft the converted encoder whole")
    res_a = os.path.join(work, "recipe_a")
    launches["A eval"] = _eval_cli(
        work, res_a, os.path.join(res_a, "checkpoints", "best"), "pre",
        {"relayout_cuda": 1, "conv_bn_fused": 6, "head_conv_fused": 1},
        "A (--pretrained_enc) eval")
    shutil.rmtree(os.path.join(res_a, "checkpoints"))
    torch.cuda.empty_cache()

    # the optimizers and the remat modes on the ResNet-50 step
    base = Config(type="pre", encoder="resnet50", precision=16, loss_str="focal+dice",
                  batch_size=TRAIN_BATCH, optimizer="adamw", fused_tail=True)
    images, masks = _raw_train_batch()
    launches["steps"] = dict.fromkeys(_read_counters(), 0)
    for name in RECIPE_OPTIMIZERS:
        rows[f"train {name}"] = _time_train_step(base.replace(optimizer=name), images, masks,
                                                 profile, f"ResNet-50, {name}")
    for mode in REMAT_MODES:
        rows[f"train remat {mode}"] = r = _time_train_step(
            base.replace(remat=mode), images, masks, profile, f"ResNet-50, --remat {mode}")
        per_step = {k: r["launches"].get(k, 0) / 4 for k in ("conv_bn_fused", "conv_bn_wgrad",
                                                              "conv_bn_dgrad")}
        rows[f"train remat {mode}"]["k2_k4_k5_per_step"] = per_step
        log(f"--remat {mode}: {r['ms']:.2f} ms a step, peak {r['peak_gib']:.2f} GiB, "
            f"K2/K4/K5 launches a step {per_step}")
    for r in rows.values():
        for k, v in r["launches"].items():
            launches["steps"][k] += v
    del images, masks
    torch.cuda.empty_cache()
    rows["optimizer updates"] = check_optimizers_on_card()
    c_cfg = Config(type="post", dmg_model="fused", encoder="resnest200", precision=16,
                   loss_str="coral", batch_size=C_BATCH, optimizer="adamw", fused_tail=True,
                   ppm=True, remat="full")
    images, masks = _raw_train_batch(C_BATCH, 6)
    rows["C train remat full"] = r = _time_train_step(
        c_cfg, images, masks, profile, "C ResNeSt-200 fused + CORAL, --remat full",
        kernel_scale=1.9)
    for k, v in r["launches"].items():
        launches["steps"][k] += v
    log(f"C under --remat full: {r['ms']:.2f} ms a step, peak {r['peak_gib']:.2f} GiB against "
        + (f"{c_peak_gib:.2f} GiB without remat in this run" if c_peak_gib else
           "C without remat not measured in this call"))
    del images, masks
    torch.cuda.empty_cache()
    rows["remat running statistics"] = check_remat_running_stats()
    torch.cuda.empty_cache()

    # --fold_eval_bn 0 against the fold: the ResNet-50 eval step and D's
    for tag, cfg in (("ResNet-50", base.replace(tta=True)),
                     ("D", Config(precision=16, loss_str="focal+dice", fused_tail=True,
                                  tta=True, **D_BASE))):
        rows.update(check_fold_eval_bn(cfg, tag, profile))
    rows["score"] = run_score_chain(work)
    return launches, rows


def check_autoaugment_against_cpu(channels: int = 3) -> None:
    """The --autoaugment chain (crop, AutoAugment, normalize) on the card,
    through K6, against the same chain on the CPU, through the plain
    version, on the same draws at full size (16 raw 1024^2 tiles -> 512^2
    crops; with ``channels=6`` DMG_BATCH pre/post pairs, 7-channel pixels in
    K6).  Labels EQUAL.  The image within 1e-5 of the normalized scale,
    except where contrast's mean (a float32 sum of 262,144 pixels, in another
    order on the card) lands on another side of .5."""
    import torch

    from xview2_tpu_torch.ops import augment, autoaugment, rowshift

    batch = TRAIN_BATCH if channels == 3 else DMG_BATCH
    images, masks = _raw_train_batch(batch, channels)
    gen = torch.Generator().manual_seed(21)
    d = augment.draw_augment_autoaugment(gen, masks.cpu(), CROP)
    # every subpolicy with a spatial op at least once, slots forced to fire
    pol = torch.tensor([0, 5, 8, 10, 11, 15, 18, 18], dtype=d.aa.policy.dtype)[:batch]
    d.aa.policy[:len(pol)] = pol
    d.aa.u1[:len(pol)] = 0.0
    d.aa.u2[:len(pol)] = 0.0
    want_x, want_y = augment.apply_augment_autoaugment(images.cpu(), masks.cpu(), d, CROP)
    dc = augment.AutoAugmentBranchDraws(
        d.pix_y.cuda(), d.pix_x.cuda(), d.off_y.cuda(), d.off_x.cuda(),
        autoaugment.AutoAugmentDraws(d.aa.policy.cuda(), d.aa.u1.cuda(), d.aa.u2.cuda(),
                                     d.aa.neg1.cuda(), d.aa.neg2.cuda()))
    before = rowshift.row_shift_cuda.launches
    got_x, got_y = augment.apply_augment_autoaugment(images, masks, dc, CROP)
    torch.cuda.synchronize()
    launched = rowshift.row_shift_cuda.launches - before
    err = (got_x.cpu() - want_x).abs().amax(dim=(1, 2, 3))
    labels_equal = torch.equal(got_y.cpu(), want_y)
    log(f"--autoaugment chain ({batch} x {TILE}^2 x {channels} channels -> {CROP}^2, every "
        f"spatial subpolicy "
        f"forced: two rotation groups and a shear group, 7 launches or more), "
        f"card through K6 vs CPU through the plain version: labels equal: {labels_equal}, "
        f"image max abs err per sample {[float(f'{e:.2g}') for e in err.tolist()]} (tolerance "
        f"1e-5 normalized), {launched} K6 launches")
    if not (labels_equal and launched >= 7 and float(err.max()) <= 1e-5
            and bool(torch.isfinite(got_x).all())):
        raise AssertionError("the --autoaugment chain on the card disagrees with the CPU")


def run_autoaugment_path(work: str, profile: bool):
    """The --autoaugment train main path through ``main`` (the train split of
    ``run_train_path``), the chain against the CPU, then the AutoAugment train
    step's steady state beside the plain-augmentation step, in turns."""
    from xview2_tpu_torch.config import Config

    launches = _drive_train_cli(work, "autoaugment_results", ["--encoder", "resnet50",
                                                               "--autoaugment"],
                                {"row_shift_cuda": 1}, "--autoaugment train")
    check_autoaugment_against_cpu()
    images, masks = _raw_train_batch()
    base = Config(type="pre", encoder="resnet50", precision=16, loss_str="focal+dice",
                  batch_size=TRAIN_BATCH, optimizer="adamw", fused_tail=True)
    for aa in (False, True, True, False):
        _time_train_step(base.replace(autoaugment=aa), images, masks, profile and aa,
                         "fused tail, --autoaugment" if aa else "fused tail, plain augmentation")
    return launches


def _kernel_leaf(name: str) -> bool:
    """A parameter of a decoder block that the fused kernels run: dec_l2,
    dec_l3 and the packed dec_l5 of a template, of each fused branch, and the
    fused variant's packed cross-fusion."""
    return (any(f"dec_layers_{i}.conv_block" in name for i in (1, 2, 4))
            or any(f"dec_fusion_{i}.{b}_layer.conv_block" in name
                   for i in (1, 2, 4) for b in ("pre", "post"))
            or name.startswith(("dec_fusion_4.conv_pre.", "dec_fusion_4.conv_post.")))


def check_f32_train_step_against_cpu(base=None, b: int = 4, size: int = 256,
                                     tag: str = "", spread: bool = False,
                                     noise_floor: bool = False) -> None:
    """One small float32 train-mode forward, loss and backward (TF32 off) on
    the card with the fused tail, through the f32 kernels, against the same
    on the CPU through the plain versions, from the same weights and the same
    augmented crop.  The card's stock tail (no kernel of the port) is run
    beside it: its distance from the CPU is the float32 noise of the network
    itself (sums in another order through a backward whose BN-statistics
    path cancels), which the tolerances have to allow.

    Tolerances: loss rtol 1e-4; all gradients together, and each leaf of the
    decoder blocks the kernels run (dec_l2, dec_l3, dec_l5) on its own,
    within 5e-2 in relative L2 norm of the CPU's, and within the same of the
    card's own stock tail; running statistics within 1e-3 of each tensor's
    scale.  ``base``: the configuration (default the ResNet-50 UNetLoc), at
    ``b`` crops of ``size``^2; with deep supervision the DS heads read the
    fine labels, the main head their packed view.  ``spread``: each crop (and channel) gets its
    own contrast and brightness, as real tiles do; the ResNeSt split
    attention needs it in a float32 train step, where its ``bn1``
    normalizes the batch's few pooled values: with crops of one
    distribution those differ by little more than float32 rounding, and
    the gradients with them.  ``spread`` also logs what separates that
    conditioning from a fault of the card, on the spread crops and on
    crops of one distribution: the CPU's own float32 step against itself
    with the batch reversed (the same sums in another order) and against
    the float64 step, and the card's float32 step against both CPU
    steps.

    ``noise_floor`` (with ``spread``; the fused variant, where the CPU's own
    float32 step reversed reads about 0.06 against itself, above the 5e-2):
    the gradients may instead be no farther from the float64 step than 1.25
    times the CPU's float32 step is, over all leaves and over the worst
    fused-tail leaf, so the card is held to the float32 noise it cannot be
    below; the gate against the card's own stock tail stays 5e-2."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.models.unet import emits_packed_loss_view
    from xview2_tpu_torch.ops import packed_fused_conv as pfc
    from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels
    from xview2_tpu_torch.parallel.steps import forward_loss

    base = Config(type="pre", encoder="resnet50", precision=32) if base is None else base
    apply_precision(base)
    rng = np.random.default_rng(17)
    x = x0 = rng.normal(size=(b, size, size, base.in_channels))
    if spread:
        x = x * rng.uniform(0.3, 2.0, (b, 1, 1, base.in_channels)) \
            + rng.normal(0.0, 1.0, (b, 1, 1, base.in_channels))
    x, unspread = torch.from_numpy(x.astype(np.float32)), torch.from_numpy(x0.astype(np.float32))
    hi = 5 if base.type == "post" else 2
    fine = torch.from_numpy((rng.random((b, size, size)) > 0.7)
                            * rng.integers(1, hi, (b, size, size))).to(torch.int32)
    # the main head's view of the labels; the deep-supervision heads read the fine ones
    y = packed_loss_view_labels(fine) if emits_packed_loss_view(base) else fine
    loss_fn = make_loss_fn(base.loss_str, base.type)

    def run(dev, fused, x=x, dtype=torch.float32, order=slice(None)):
        cfg = base.replace(fused_tail=fused, precision=64 if dtype == torch.float64 else 32)
        model = seeded_model(cfg, seed=2).to(dev, dtype)
        before = pfc.conv_bn_wgrad.launches + pfc.conv_bn_dgrad.launches
        loss = forward_loss(cfg, model, loss_fn, x[order].to(dev, dtype), y[order].to(dev),
                            fine[order].to(dev))
        names, params = zip(*model.named_parameters())
        grads = dict(zip(names, (g.cpu() for g in torch.autograd.grad(loss, params))))
        stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
        return (loss.item(), grads, stats,
                pfc.conv_bn_wgrad.launches + pfc.conv_bn_dgrad.launches - before)

    def rel_l2(got, want, names):
        num = math.sqrt(sum(float(((got[k] - want[k]) ** 2).sum()) for k in names))
        return num / max(math.sqrt(sum(float((want[k] ** 2).sum()) for k in names)), 1e-30)

    lc, gc, sc, nc = run("cpu", True)
    lg, gg, sg, ng = run("cuda", True)
    ls, gs, _, _ = run("cuda", False)
    tail = [k for k in gc if _kernel_leaf(k)]
    err_all, floor_all = rel_l2(gg, gc, list(gc)), rel_l2(gs, gc, list(gc))
    err_tail = max(rel_l2(gg, gc, [k]) for k in tail)
    floor_tail = max(rel_l2(gs, gc, [k]) for k in tail)
    card_all = rel_l2(gg, gs, list(gs))
    card_tail = max(rel_l2(gg, gs, [k]) for k in tail)
    stat_err = max(float((sg[k] - sc[k]).abs().max() / sc[k].abs().max()) for k in sc)
    log(f"f32 train step{tag} ({b} x {size}^2, fused tail), card vs CPU plain path: loss "
        f"{lg:.6f} vs "
        f"{lc:.6f}; gradients relative L2 error {err_all:.3g} over all {len(gc)} leaves, worst "
        f"of the {len(tail)} fused-tail leaves {err_tail:.3g} (tolerance 5e-2; the card's stock "
        f"tail, no kernel of the port, is {floor_all:.3g} and {floor_tail:.3g} from the CPU, "
        f"loss {ls:.6f}; fused against stock tail on the card: {card_all:.3g} and "
        f"{card_tail:.3g}); running statistics max err {stat_err:.3g} of scale (tolerance "
        f"1e-3); {ng} K4+K5 launches on the card, {nc} on the CPU")
    top = sorted(gc, key=lambda k: -float(((gg[k] - gc[k]) ** 2).sum()))[:3]
    log(f"f32 train step{tag}: the leaves farthest from the CPU: " + ", ".join(
        f"{k} {rel_l2(gg, gc, [k]):.3g} (stock tail {rel_l2(gs, gc, [k]):.3g})" for k in top))
    near_cpu = max(err_all, err_tail) <= 5e-2
    if spread:
        reverse = torch.arange(b - 1, -1, -1)
        for name, data, cpu, card in (("spread", x, gc, gg), ("one distribution", unspread,
                                                             None, None)):
            cpu = run("cpu", True, data)[1] if cpu is None else cpu
            card = run("cuda", True, data)[1] if card is None else card
            cpu_rev = run("cpu", True, data, order=reverse)[1]
            cpu64 = run("cpu", True, data, torch.float64)[1]
            log(f"f32 train step{tag}, crops of {name}: gradients relative L2, CPU float32 "
                f"batch reversed vs CPU float32 {rel_l2(cpu_rev, cpu, list(cpu)):.3g}, CPU "
                f"float32 vs CPU float64 {rel_l2(cpu, cpu64, list(cpu)):.3g}, card float32 vs "
                f"CPU float32 {rel_l2(card, cpu, list(cpu)):.3g}, card float32 vs CPU float64 "
                f"{rel_l2(card, cpu64, list(cpu)):.3g}")
            if name == "spread" and noise_floor and not near_cpu:
                floor = (rel_l2(cpu, cpu64, list(cpu)),
                         max(rel_l2(cpu, cpu64, [k]) for k in tail))
                got = (rel_l2(card, cpu64, list(cpu)), max(rel_l2(card, cpu64, [k]) for k in tail))
                near_cpu = got[0] <= 1.25 * floor[0] and got[1] <= 1.25 * floor[1]
                log(f"f32 train step{tag}: against float64, the card float32 {got[0]:.3g} over "
                    f"all leaves and {got[1]:.3g} at the worst fused-tail leaf, the CPU float32 "
                    f"{floor[0]:.3g} and {floor[1]:.3g} (noise-floor gate: the card within 1.25 "
                    f"times the CPU)")
    if not (ng > 0 and nc == 0 and abs(lg - lc) <= 1e-4 * abs(lc) and stat_err <= 1e-3
            and near_cpu and max(card_all, card_tail) <= 5e-2):
        raise AssertionError(f"float32 train step{tag} on the card disagrees with the CPU path")


def check_f32_against_cpu(cfg=None, tag: str = "") -> None:
    """The whole eval step in float32 on a small input: on the card (fused
    tail through the f32 kernels, TF32 off) against the port's plain path on
    the CPU, at rtol = atol = 2e-4 of the logits' scale (float32 sums in
    another order through the encoder's depth).  ``cfg``: the configuration
    (default the ResNet-50 UNetLoc), with TTA and the fused tail on; the
    card's step must launch a fused kernel, or K1 where the model has no
    decoder (``--interpolate``, whose masks are then 1024^2, the head's fixed
    eval size).  2 x 64^2 inputs, 128^2 under ``--dec_interp``: its fine
    tail takes no fused conv, and in float32 dec_l3 reaches one from 128^2."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.ops.metrics import init_f1_state
    from xview2_tpu_torch.parallel.steps import make_eval_step

    cfg = Config(type="pre", encoder="resnet50") if cfg is None else cfg
    cfg = cfg.replace(precision=32, tta=True, fused_tail=True)
    apply_precision(cfg)
    kernels = ("relayout_cuda",) if cfg.interpolate else ("conv_bn_fused", "head_conv_fused")
    size = 128 if cfg.dec_interp else 64
    model = seeded_model(cfg, seed=1)
    rng = np.random.default_rng(5)
    hi = 5 if cfg.type == "post" else 2
    msize = 1024 if cfg.interpolate else size
    data = (rng.integers(0, 256, (2, size, size, cfg.in_channels), np.uint8),
            ((rng.random((2, msize, msize)) > 0.8)
             * rng.integers(1, hi, (2, msize, msize))).astype(np.uint8),
            np.ones(2, np.float32))
    nm = cfg.n_metric_class
    _, loss_c, logits_c = make_eval_step(cfg, model, device="cpu")(init_f1_state(nm), *data)
    counters = {fn.__name__: fn for fn in _counters()}
    before = sum(counters[k].launches for k in kernels)
    _, loss_g, logits_g = make_eval_step(cfg, model.cuda(), device="cuda")(
        init_f1_state(nm, device="cuda"), *data)
    launched = sum(counters[k].launches for k in kernels) - before
    logits_g = logits_g.cpu()
    scale = max(1.0, logits_c.abs().max().item())
    diff = (logits_g - logits_c).abs().max().item()
    agree = (logits_g.argmax(-1) == logits_c.argmax(-1)).float().mean().item()
    log(f"f32 eval step{tag} (2 x {size}^2, TTA, fused tail), card vs CPU plain path: max abs "
        f"diff {diff:.4g}, max |logit| {scale:.4g}, loss {loss_g.item():.6f} vs "
        f"{loss_c.item():.6f}, argmax agreement {agree:.5f}, {launched} launches of "
        f"{'/'.join(kernels)} (tolerance 2e-4 * max(1, max|logit|))")
    if not (launched > 0 and diff <= 2e-4 * scale
            and abs(loss_g.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item())):
        raise AssertionError(f"float32 eval step{tag} on the card disagrees with the CPU path")


# ---------------------------------------------------------- data parallel

DP_WORLD = 2
DP_ROWS = TRAIN_BATCH // DP_WORLD   # each rank's rows of the global batch of 16
DP_NEED = {"conv_bn_fused": 6, "conv_bn_wgrad": 6, "conv_bn_dgrad": 6}  # per rank per step


def _dp_steps(cfg, images, masks, n_steps: int, keep_grads: bool = False) -> dict:
    """``n_steps`` train steps of ``cfg`` (the seeded ResNet-50 UNetLoc,
    rank 0's weights broadcast as the trainer does) on ``images``/``masks``,
    in or out of a group: the losses, the first step's gradients after the
    all-reduce (``keep_grads``, on the host), a digest of the parameters and
    buffers after the last step, each step's wall ms and the ms of each
    gradient all-reduce, both with the card synchronised."""
    import hashlib

    import torch

    from xview2_tpu_torch.config import apply_precision
    from xview2_tpu_torch.parallel import mesh, steps
    from xview2_tpu_torch.train.optimizers import build_optimizer

    apply_precision(cfg)
    model = seeded_model(cfg, seed=0).cuda()
    mesh.broadcast_module(model)
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    state = steps.init_train_state(model, opt, device="cuda")
    step = steps.make_train_step(cfg, model, opt, crop=CROP, device="cuda")
    out = {"losses": [], "step_ms": [], "allreduce_ms": []}
    average, opt_step = mesh.average_gradients, opt.step

    def timed_average(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average(params)
        torch.cuda.synchronize()
        out["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)

    def step_keeping_grads(*a, **kw):
        if keep_grads and "grads" not in out:
            out["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        return opt_step(*a, **kw)

    mesh.average_gradients, opt.step = timed_average, step_keeping_grads
    try:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, images, masks, steps.step_generator(cfg, state.step, "cuda"))
            out["losses"].append(loss.item())
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    finally:
        mesh.average_gradients = average
    tensors = [t.detach().reshape(-1).float().cpu() for t in
               list(model.parameters()) + list(model.buffers())]
    out["digest"] = hashlib.sha256(torch.cat(tensors).numpy().tobytes()).hexdigest()
    del model, opt, state, step
    torch.cuda.empty_cache()
    return out


def _dp_rank(rank: int, world: int, work: str) -> None:
    """One rank of the two-rank job on the one card (gloo, which carries the
    card's tensors through the host): its rows of the global batch of 16,
    one float32 step (rank 0 keeps its gradients) and two bf16 steps with
    the launch counters from 0; writes ``dp_rank{rank}.pt`` to ``work``."""
    sys.path.insert(0, ROOT)
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.parallel import mesh

    mesh.init_data_parallel(world, rank, backend="gloo", device="cuda:0",
                            init_method=f"file://{os.path.abspath(work)}/dp_rendezvous")
    try:
        images, masks = _raw_train_batch(TRAIN_BATCH)
        rows = slice(rank * DP_ROWS, (rank + 1) * DP_ROWS)
        base = Config(type="pre", encoder="resnet50", loss_str="focal+dice", optimizer="adamw",
                      fused_tail=True, batch_size=DP_ROWS)
        res = {"f32": _dp_steps(base.replace(precision=32), images[rows], masks[rows], 1,
                                keep_grads=rank == 0)}
        _zero_counters()
        before = mesh.collective.calls
        res["bf16"] = _dp_steps(base.replace(precision=16), images[rows], masks[rows], 2)
        res["launches"] = _read_counters()
        res["collectives"] = mesh.collective.calls - before
        torch.save(res, os.path.join(work, f"dp_rank{rank}.pt"))
    finally:
        mesh.shutdown()


def _rel_l2(got: dict, want: dict, names) -> float:
    num = math.sqrt(sum(float(((got[k] - want[k]) ** 2).sum()) for k in names))
    return num / max(math.sqrt(sum(float((want[k] ** 2).sum()) for k in names)), 1e-30)


def run_two_ranks_on_one_card(work: str) -> dict:
    """Phase 12 (i): the ResNet-50 UNetLoc at full width, 512^2 crops of
    1024^2 tiles, fused tail, global batch 16 = 2 ranks x 8 on the one card
    over gloo, against the one-process batch-16 step on the same generator:
    float32 within the smoke's float32 gates (loss 1e-4 relative, gradients
    5e-2 relative L2 over all leaves and at the worst fused-tail leaf); in
    bf16 the parameters and buffers bit-equal across the ranks after two
    steps, K2, K4 and K5 six times per rank per step, collectives counted.
    Returns the ranks' launch counts, summed, and the gloo timings."""
    import multiprocessing

    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.ops.augment import draw_augment

    images, masks = _raw_train_batch(TRAIN_BATCH)
    # a rank draws every per-sample value of the global batch, the noise too
    gen = torch.Generator(device="cuda").manual_seed(0)
    draw_ms = {world: cuda_ms(lambda: draw_augment(gen, masks[:DP_ROWS], CROP, 3, 0, world), 10)
               for world in (1, DP_WORLD)}
    log(f"a rank's draws for its {DP_ROWS} rows (crop {CROP}^2, CUDA events over 10): "
        f"{draw_ms[DP_WORLD]:.3f} ms for the global batch of {DP_ROWS * DP_WORLD}, "
        f"{draw_ms[1]:.3f} ms for its rows alone")
    ref = _dp_steps(Config(type="pre", encoder="resnet50", loss_str="focal+dice",
                           optimizer="adamw", fused_tail=True, batch_size=TRAIN_BATCH,
                           precision=32), images, masks, 1, keep_grads=True)
    del images, masks
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, DP_WORLD, work)) for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + 600
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise AssertionError(f"two-rank job: exit codes {codes}, {len(hung)} hung")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"dp_rank{r}.pt")) for r in range(DP_WORLD)]

    got = ranks[0]["f32"]
    names = list(ref["grads"])
    tail = [k for k in names if _kernel_leaf(k)]
    err_all = _rel_l2(got["grads"], ref["grads"], names)
    err_tail = max(_rel_l2(got["grads"], ref["grads"], [k]) for k in tail)
    loss_err = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    same_f32 = all(r["f32"]["losses"] == got["losses"] for r in ranks)
    log(f"two ranks x {DP_ROWS} on one card (gloo) against one process x {TRAIN_BATCH}, "
        f"float32 step: loss {got['losses'][0]:.6f} vs {ref['losses'][0]:.6f} (relative "
        f"{loss_err:.3g}, tolerance 1e-4), gradients relative L2 {err_all:.3g} over all "
        f"{len(names)} leaves, worst of the {len(tail)} fused-tail leaves {err_tail:.3g} "
        f"(tolerance 5e-2); the same loss on both ranks: {same_f32}")
    digests = {r["bf16"]["digest"] for r in ranks}
    launches = [r["launches"] for r in ranks]
    per_rank = {k: [ln[k] for ln in launches] for k in DP_NEED}
    collectives = [r["collectives"] for r in ranks]
    log(f"two ranks, bf16, two steps: parameters and buffers bit-equal across the ranks: "
        f"{len(digests) == 1}; losses {[r['bf16']['losses'] for r in ranks]}; K2/K4/K5 "
        f"launches per rank {per_rank} (need {2 * 6} each); collectives per rank "
        f"{collectives}")
    timing = {"gloo_step_ms": [r["bf16"]["step_ms"][-1] for r in ranks],
              "gloo_allreduce_ms": [r["bf16"]["allreduce_ms"][-1] for r in ranks],
              "job_wall_s": wall}
    log(f"two ranks, bf16, second step on one card over gloo (host-staged collectives, both "
        f"ranks sharing the card: not a scaling number): step ms {timing['gloo_step_ms']}, "
        f"of it the gradient all-reduce (41 M float32 through the host) ms "
        f"{timing['gloo_allreduce_ms']}; the job {wall:.1f} s with process start and build")
    if not (loss_err <= 1e-4 and err_all <= 5e-2 and err_tail <= 5e-2 and same_f32):
        raise AssertionError("two ranks disagree with the one-process step in float32")
    if len(digests) != 1:
        raise AssertionError("the ranks' bf16 parameters and buffers differ")
    for k, counts in per_rank.items():
        if any(c != 2 * DP_NEED[k] for c in counts):
            raise AssertionError(f"{k} launched {counts} times on the ranks, expected "
                                 f"{2 * DP_NEED[k]} each")
    if not all(c > 0 for c in collectives):
        raise AssertionError(f"no collective on a rank: {collectives}")
    total = {k: sum(ln[k] for ln in launches) for k in launches[0]}
    return total, dict(timing, f32_loss_rel_err=loss_err, f32_grad_rel_l2=err_all,
                       f32_grad_rel_l2_tail=err_tail, draw_global_ms=draw_ms[DP_WORLD],
                       draw_own_rows_ms=draw_ms[1])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _LauncherEnv:
    """The environment ``torchrun`` gives one process of a one-rank job."""

    def __enter__(self):
        self.env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _last_log(results: str) -> dict:
    with open(os.path.join(results, "logs.json")) as f:
        return json.loads(f.readlines()[-1])["data"]


def run_nccl_one_rank(work: str, profile: bool):
    """Phase 12 (ii) and (iii): the train and eval CLIs under a one-rank
    NCCL group (``torchrun``'s environment, ``WORLD_SIZE=1``): collectives
    counted, the train checkpoint finite, moved and reloading
    (``_drive_train_cli``), the epoch's metrics within tolerance of the run
    without a group, the eval's F1 EQUAL to the eval of the same checkpoint
    without a group and its dumps within 1e-3; then the train step under the
    group against the plain one by CUDA events, in turns (plain, NCCL, NCCL,
    plain), with peak memory and the collectives a step, and the host
    microseconds of one ``global_sum`` beside the ``cat`` and ``split`` in it."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.parallel import mesh

    write_splits(work)
    plain = os.path.join(work, "train_results")
    if not os.path.exists(os.path.join(plain, "logs.json")):  # this phase alone
        _drive_train_cli(work, "train_results", ["--encoder", "resnet50"], {}, "train")
    launches = {}
    with _LauncherEnv():
        before = mesh.collective.calls
        launches["train"] = _drive_train_cli(work, "dp_nccl_train", ["--encoder", "resnet50"],
                                             {}, "one-rank NCCL train")
        train_calls = mesh.collective.calls - before
        ckpt = os.path.join(work, "dp_nccl_train", "checkpoints", "best")
        before = mesh.collective.calls
        launches["eval"] = _eval_cli(work, os.path.join(work, "dp_nccl_eval"), ckpt, "pre",
                                     {"conv_bn_fused": 6, "head_conv_fused": 1},
                                     "one-rank NCCL eval")
        eval_calls = mesh.collective.calls - before
    if mesh.active() is not None:
        raise AssertionError("the CLI left its process group behind")
    _eval_cli(work, os.path.join(work, "dp_plain_eval"), ckpt, "pre", {}, "eval without a group")
    got, want = _last_log(os.path.join(work, "dp_nccl_train")), _last_log(plain)
    e_got, e_want = (_last_log(os.path.join(work, d)) for d in ("dp_nccl_eval", "dp_plain_eval"))
    dump_diff = max(float(np.abs(np.load(p) - np.load(p.replace("dp_nccl_eval",
                                                                 "dp_plain_eval"))).max())
                    for p in glob.glob(os.path.join(work, "dp_nccl_eval", "probs", "*.npy")))
    log(f"one-rank NCCL CLIs: {train_calls} collectives in the train run, {eval_calls} in "
        f"the eval run; train epoch under the group {got} vs without {want} (tolerance: "
        f"val_loss 5e-2 relative, f1 2.0); eval F1 {e_got} vs without a group {e_want} "
        f"(EQUAL), dumps max abs diff {dump_diff:.3g} (tolerance 1e-3)")
    if not (train_calls > 0 and eval_calls > 0):
        raise AssertionError("the one-rank NCCL CLIs ran no collective")
    if not (abs(got["val_loss"] - want["val_loss"]) <= 5e-2 * abs(want["val_loss"])
            and abs(got["f1"] - want["f1"]) <= 2.0):
        raise AssertionError("the one-rank NCCL train run's metrics are off the run without")
    if e_got != e_want or not dump_diff <= 1e-3:
        raise AssertionError("the one-rank NCCL eval differs from the eval without a group")

    images, masks = _raw_train_batch(TRAIN_BATCH)
    cfg = Config(type="pre", encoder="resnet50", precision=16, loss_str="focal+dice",
                 batch_size=TRAIN_BATCH, optimizer="adamw", fused_tail=True)
    rows = {}
    for kind in ("plain", "nccl", "nccl", "plain"):
        profiled = profile and kind not in rows
        if kind == "nccl":
            with _LauncherEnv():
                mesh.init_data_parallel(1, 0, backend="nccl", device="cuda:0",
                                        init_method="env://")
                try:
                    before = mesh.collective.calls
                    row = _time_train_step(cfg, images, masks, profiled, "one-rank NCCL group")
                    # 1 warm-up and 3 timed steps, and 2 more under the profiler
                    row["collectives_per_step"] = (mesh.collective.calls - before) / (
                        6 if profiled else 4)
                    if "host_us" not in rows:
                        v = torch.zeros(256, device=images.device)
                        rows["host_us"] = host_us({
                            "global_sum": lambda: mesh.global_sum(v, v),
                            "cat_and_split": lambda: torch.split(torch.cat([v, v]), [256, 256])},
                            1000)
                finally:
                    mesh.shutdown()
        else:
            row = _time_train_step(cfg, images, masks, profiled, "no group")
        rows.setdefault(kind, []).append(row)
    ms = {k: [r["ms"] for r in rows[k]] for k in ("plain", "nccl")}
    log(f"ResNet-50 train step (batch {TRAIN_BATCH}, fused tail, bf16) in turns: without a "
        f"group {ms['plain']} ms, under a one-rank NCCL group {ms['nccl']} ms "
        f"({rows['nccl'][0]['collectives_per_step']:.0f} collectives a step), peak "
        f"{rows['plain'][0]['peak_gib']:.2f} vs {rows['nccl'][0]['peak_gib']:.2f} GiB; host "
        f"us per call under the group (perf_counter over 1000 calls): "
        + ", ".join(f"{k} {v:.2f}" for k, v in rows["host_us"].items()))
    total = {k: launches["train"][k] + launches["eval"][k] for k in launches["train"]}
    return total, {"nccl_step_ms": ms["nccl"], "plain_step_ms": ms["plain"],
                   "nccl_collectives_per_step": rows["nccl"][0]["collectives_per_step"],
                   "nccl_peak_gib": rows["nccl"][0]["peak_gib"],
                   "plain_peak_gib": rows["plain"][0]["peak_gib"],
                   "nccl_global_sum_host_us": rows["host_us"]["global_sum"]}


def run_data_parallel_path(work: str, profile: bool):
    """Phase 12: ``--gpus N``, two ranks on the one card over gloo, then the
    production NCCL path as a process group of one rank."""
    os.makedirs(work, exist_ok=True)
    two, rows = run_two_ranks_on_one_card(work)
    one, nccl_rows = run_nccl_one_rank(work, profile)
    rows.update(nccl_rows)
    return {k: two.get(k, 0) + one[k] for k in one}, rows


# kernel-name fragments -> category of a step's breakdown
_CATEGORIES = (("K6 row_shift", ("row_shift_kernel",)),
               ("K7 small_conv_fwd", ("small_fwd_mma_kernel", "small_fwd_f32_kernel")),
               ("K8 small_conv_wgrad", ("small_wgrad_mma_kernel", "small_wgrad_sum_kernel",
                                        "small_wgrad_f32_kernel")),
               ("K4 conv_bn_wgrad", ("wgrad_wgmma_kernel", "wgrad_bf16_kernel", "wgrad_f32_kernel")),
               ("K5 conv_bn_dgrad", ("dgrad_wgmma_kernel", "dgrad_bf16_kernel",
                                     "dgrad_f32_kernel")),
               ("K2 conv_bn_fused", ("conv_wgmma_kernel", "conv_bf16_kernel", "conv_f32_kernel")),
               ("K3 head_conv_fused", ("head_mma_kernel", "head_kernel")),
               ("K1 relayout", ("relayout_",)),
               ("library conv/GEMM", ("xmma", "cudnn", "cutlass", "gemm", "conv")),
               ("elementwise", ("elementwise", "reduce")),
               ("cat/copy", ("CatArray", "copy", "Memcpy", "Memset")))


def profile_step(fn, tag: str) -> None:
    """torch.profiler over one call of ``fn`` (one step): device time by
    category, the device's idle share of the step's wall time, and the top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    if not kernels:
        raise AssertionError("the profiler saw no device time")
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    by_cat = {}
    for e in kernels:
        cat = next((c for c, keys in _CATEGORIES if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    parts = ", ".join(f"{c} {ms:.2f} ms ({100 * ms / total:.1f}%)"
                      for c, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]))
    log(f"profile ({tag}): device time {total:.2f} ms in a {wall:.2f} ms step under the "
        f"profiler (device idle {100 * max(0.0, 1 - total / wall):.1f}%): {parts}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="print torch.profiler tables of the eval and train steps")
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "xview2_tpu_torch")):
        print("chip_smoke.py must run from a checkout holding xview2_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    from xview2_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    log(f"kernel build: {cuda_build.build_all():.1f} s (nvcc, one per source, in parallel)")
    rows = {"relayout": check_relayout(), "conv_bn_fused": check_conv_bn_fused(),
            "head_conv_fused": check_head_conv_fused()}
    torch.cuda.empty_cache()
    rows["relayout"].update(check_relayout_damage())
    rows["relayout"].update(check_relayout_damage(3, "coral_"))
    rows["relayout"].update(check_relayout_damage(1, "mse_"))
    rows["relayout"].update(check_relayout_ds())
    rows["head_conv_fused"].update(check_head_conv_fused(256, (8, 16), DMG_BATCH, "dmg_"))
    rows["head_conv_fused"].update(check_head_conv_fused(256, (4,), C_BATCH, "coral_"))
    rows["head_conv_fused"].update(check_head_conv_fused(128, (4,), VARIANT_BATCH, "mse_"))
    torch.cuda.empty_cache()
    rows.update(check_conv_bn_backward())
    for kern, row in check_cross_fusion().items():
        rows[kern].update(row)
    check_prologue_bit_equal()
    check_dgrad_epilogue_bit_equal()
    torch.cuda.empty_cache()
    rows["row_shift"] = check_row_shift()
    rows.update(check_small_conv())
    torch.cuda.empty_cache()
    log(f"kernel checks done at {time.perf_counter() - t_start:.0f} s")

    work = os.path.join(ROOT, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    launches = {}
    try:
        launches["eval"] = run_eval_path(work, args.profile)
        torch.cuda.empty_cache()
        log(f"eval path done at {time.perf_counter() - t_start:.0f} s")
        launches["train"] = run_train_path(work, args.profile)
        torch.cuda.empty_cache()
        log(f"train path done at {time.perf_counter() - t_start:.0f} s")
        launches["small"] = run_small_conv_path()
        torch.cuda.empty_cache()
        launches["autoaugment"] = run_autoaugment_path(work, args.profile)
        torch.cuda.empty_cache()
        log(f"--autoaugment path done at {time.perf_counter() - t_start:.0f} s")
        dmg_launches, dmg_rows = run_damage_path(work, args.profile)
        launches["damage"] = {k: sum(d[k] for d in dmg_launches.values())
                              for k in launches["eval"]}
        log(f"damage path done at {time.perf_counter() - t_start:.0f} s; steady state "
            f"{json.dumps(dmg_rows)}")
        torch.cuda.empty_cache()
        var_launches, var_rows = run_dmg_variants_path(work, args.profile)
        launches["variants"] = {k: sum(d[k] for d in var_launches.values())
                                for k in launches["eval"]}
        log(f"damage variants path done at {time.perf_counter() - t_start:.0f} s; steady state "
            f"{json.dumps(var_rows)}")
        torch.cuda.empty_cache()
        opt_launches, opt_rows = run_decoder_options_path(work, args.profile)
        launches["decoder_options"] = {k: sum(d[k] for d in opt_launches.values())
                                       for k in launches["eval"]}
        log(f"decoder options path done at {time.perf_counter() - t_start:.0f} s; steady state "
            f"{json.dumps(opt_rows)}")
        torch.cuda.empty_cache()
        rec_launches, rec_rows = run_recipe_path(
            work, args.profile, var_rows.get("C train fused", {}).get("peak_gib"))
        launches["recipe"] = {k: sum(d[k] for d in rec_launches.values())
                              for k in launches["eval"]}
        log(f"recipe and score path done at {time.perf_counter() - t_start:.0f} s; steady state "
            f"{json.dumps(rec_rows)}")
        torch.cuda.empty_cache()
        launches["data_parallel"], dp_rows = run_data_parallel_path(work, args.profile)
        log(f"data parallel path done at {time.perf_counter() - t_start:.0f} s; "
            f"{json.dumps(dp_rows)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    src = "xview2_tpu_torch/csrc/"
    meta = {
        "relayout": ("relayout_cuda", src + "relayout.cu", "xview2_tpu/ops/layout.py:79"),
        "conv_bn_fused": ("conv_bn_fused", src + "fused_conv.cu",
                          "xview2_tpu/ops/packed_fused_conv.py:157"),
        "head_conv_fused": ("head_conv_fused", src + "fused_head.cu",
                            "xview2_tpu/ops/packed_fused_conv.py:463"),
        "conv_bn_wgrad": ("conv_bn_wgrad", src + "fused_conv_bwd.cu",
                          "xview2_tpu/ops/packed_fused_conv.py:259"),
        "conv_bn_dgrad": ("conv_bn_dgrad", src + "fused_conv_bwd.cu",
                          "xview2_tpu/ops/packed_fused_conv.py:338"),
        "row_shift": ("row_shift_cuda", src + "rowshift.cu", "xview2_tpu/ops/rowshift.py:85"),
        "small_conv_fwd": ("small_conv_fwd", src + "small_conv.cu",
                           "xview2_tpu/ops/pallas_conv.py:87"),
        "small_conv_wgrad": ("small_conv_wgrad", src + "small_conv.cu",
                             "xview2_tpu/ops/pallas_conv.py:121"),
    }
    # launches: the eight main paths' runs (eval CLI, train CLI, conv3x3_small,
    # --autoaugment train CLI, the damage path's A train, B train and B eval
    # CLIs, the variants path's C train and C eval CLIs and the six other
    # variants' steps, and the decoder options path's D train and D eval CLIs,
    # the six option runs' steps and the --interpolate eval CLI, and the recipe
    # path's A train and eval CLIs and its optimizer and remat steps, and the data
    # parallel path's two ranks' bf16 steps and its one-rank NCCL train and eval
    # CLIs), each counted from 0; ds_train_ keys of K1: D's eight launches per train step; dmg_ keys of K1 and K3: the
    # damage shapes (K1 at n = 4, K3 at C = 256, Co = 16; dmg_train_: per
    # train step); coral_ and mse_ keys: K1 at n = 3 and 1, K3 at Co = 4 with
    # C = 256 (C's head) and 128 (cat's MSE head); fusion_ keys of K2, K4 and
    # K5: the fused variant's packed cross-fusion (C = 256 -> 128, two
    # launches per step; fusion_train_: per train step); K6's pair_ keys: 7
    # channels.  ms/plain_ms/library_ms/bound_ms: K1-K3 per eval step (train_* keys: per train step), K4/K5 per
    # train step, K6 per --autoaugment step with one rotation and one shear
    # group, K7/K8 per launch at (16, 512, 512, 32) -> 32 bf16, all by CUDA
    # events; K1, K3, K6, K7 and K8 add the profiler's device time of a
    # call's kernels (device_ms, library_device_ms, and their train_/dx_
    # keys), K8 its share of the bound (bound_share, device_bound_share), K1
    # its NCHW-viewed-NHWC row (permuted_ keys), K1 and K6 their L2-cold
    # device times (cold_ keys; K6 per launch at the batch of 16) and the host
    # microseconds of one call (host_us_ keys).
    kernels = []
    for name, (counter, source, replaces) in meta.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(n[counter] for n in launches.values()),
                        "eval_path_launches": launches["eval"][counter],
                        "train_path_launches": launches["train"][counter],
                        "small_conv_path_launches": launches["small"][counter],
                        "autoaugment_path_launches": launches["autoaugment"][counter],
                        "damage_path_launches": launches["damage"][counter],
                        "variants_path_launches": launches["variants"][counter],
                        "decoder_options_path_launches": launches["decoder_options"][counter],
                        "recipe_path_launches": launches["recipe"][counter],
                        "data_parallel_path_launches": launches["data_parallel"][counter],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **{k: v for k, v in r.items() if k not in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")}})
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel was launched on no main path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
