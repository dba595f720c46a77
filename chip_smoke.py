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
8. one JSON line listing every kernel, then the ``nvidia-smi`` line, then
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
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not kernels:
        raise AssertionError("the profiler saw no device time")
    return sum(e.self_device_time_total for e in kernels) / iters / 1e3


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
    """Two bf16 roundings, after the GEMM (at the GEMM's magnitude, which the
    bias may cancel) and after the bias: up to one ulp of each apart, plus
    1e-3 of max|out|.  Returns (max abs err, max rel err of max(|gemm|,
    |out|), the kernel variant)."""
    import torch

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    b, h, w, c = x.shape
    co = kmat.shape[1]
    variant = pfc.kernel_variant("head_conv_fused", h, w, c, co, x.dtype)
    got = pfc.head_conv_fused(x, kmat, hbias, fold).float()
    want = pfc.reference_head(x, kmat, hbias, fold).float()
    gemm = torch.matmul(pfc.prologue(x, fold), kmat.to(x.dtype)).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    scale = want.abs().max().item()
    tol = 2 * torch.finfo(x.dtype).eps * (gemm.abs() + want.abs()) + 1e-3 * scale
    if not bool((err <= tol).all()):
        raise AssertionError(f"K3 head {tag} {(b, h, w, c)}->{co} [{variant}] disagrees: max abs "
                             f"err {err.max().item():.4g}")
    rel = (err / torch.maximum(gemm.abs(), want.abs()).clamp_min(1e-3 * scale)).max().item()
    return err.max().item(), rel, variant


def check_head_conv_fused():
    """K3 at the eval shape (the packed dec_l5 map of 16 images of 1024^2)
    and the train shape (batch 16 of 512^2 crops), Co = 8 (the path) and 16,
    and at a ragged pixel count, against the plain version; the path shapes
    must take the mma.sync kernel.  Timed at Co = 8 beside the plain version,
    ``torch.matmul`` of the activated map and the bound by CUDA events, as
    every kernel is; the kernel and ``matmul`` also by the device time of the
    kernels a call launches (``device_ms``: at the train shape the wrapper's
    host time is of the kernel's order)."""
    import torch

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    c = 128
    row = {}
    for tag, shape in (("eval", (16, 512, 512, c)), ("train", (16, CROP // 2, CROP // 2, c))):
        for co in (16, 8):  # the path's Co = 8 last: its tensors are timed below
            x, kmat, hbias, fold = head_case(shape, co, seed=40)
            err, rel, variant = _compare_head(x, kmat, hbias, fold, tag)
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
            log(f"K3 head {tag} {shape}->{co} bf16 [{variant}]: max abs err {err:.4g}, max rel "
                f"err {rel:.4g} (of max(|gemm|, |out|)), tolerance 2*eps*(|gemm| + |out|) + "
                f"1e-3*max|out|")
            if "mma.sync" not in variant:
                raise AssertionError(f"K3 head {tag} {shape}->{co}: the path shape took "
                                     f"'{variant}'")
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
        pre = "" if tag == "eval" else "train_"
        row.update({f"{pre}ms": ms, f"{pre}plain_ms": plain, f"{pre}library_ms": lib,
                    f"{pre}bound_ms": bnd, f"{pre}device_ms": dev,
                    f"{pre}library_device_ms": lib_dev})
        if tag == "eval":
            row["bound_by"] = by
        del x, a
        torch.cuda.empty_cache()
    # a ragged pixel count: the last tile holds 41 of 128 pixels
    for co in (8, 16):
        x, kmat, hbias, fold = head_case((1, 37, 53, c), co, seed=41)
        err, rel, variant = _compare_head(x, kmat, hbias, fold, "ragged")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        log(f"K3 head ragged (1, 37, 53, {c})->{co} bf16 [{variant}]: max abs err {err:.4g}, "
            f"max rel err {rel:.4g}")
    return row


# K6 shapes of the --autoaugment train path: a shear of 512^2 crops, and the
# two passes of the three-shear rotation on the map widened to 654 columns
# (the first and third pass shift rows, the second shifts columns)
AA_GROUP = 2    # a typical group: 17% of a batch of 16 draw a spatial op
ROT_WIDTH = CROP + 2 * (int(math.ceil(0.2680 * (CROP - 1) / 2.0)) + 2)


def _row_shift_cases(n):
    """(tag, x, shift, sel, axis) at the path's shapes and shift patterns."""
    import numpy as np
    import torch

    from xview2_tpu_torch.ops import autoaugment as aa

    gen = torch.Generator(device="cuda").manual_seed(60 + n)

    def image(w, c=4):
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


def row_shift_host_breakdown(calls: int = 1000) -> dict:
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

    x = torch.zeros((1, 8, 8, 4), device="cuda")
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
        "ctypes_call": lambda: bare(*args, 0, 8, 8, 4, 2, stream),
        "ctypes_call_and_launch": lambda: bare(*args, 1, 8, 8, 4, 2, stream),
        "clone": lambda: x.clone(),
    }, calls)
    us["launch"] = us.pop("ctypes_call_and_launch") - us["ctypes_call"]
    log("K6 host time per call (us, perf_counter over "
        f"{calls} calls of a (1, 8, 8, 4) map): " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
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

def seeded_model(cfg, seed: int):
    """The port's model with random weights from ``seed``: torch's default
    conv init scaled so activations stay O(1), and BN statistics and affines
    drawn away from the identity so the folds do real work."""
    import torch

    from xview2_tpu_torch.models.unet import build_model

    torch.manual_seed(seed)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) * 1.5 + 0.5)
            elif name.endswith("weight") and t.dim() == 1:
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("weight"):
                t.mul_(2.2)
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


def run_eval_path(work: str, profile: bool):
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.data.synthetic import make_synthetic_split
    from xview2_tpu_torch.main import main as port_main
    from xview2_tpu_torch.ops.metrics import init_f1_state
    from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
    from xview2_tpu_torch.parallel.steps import make_eval_step
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
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (VAL_BATCH, TILE, TILE, 3), np.uint8)).cuda()
    masks = torch.from_numpy((rng.random((VAL_BATCH, TILE, TILE)) > 0.9).astype(np.uint8)).cuda()
    valid = torch.ones(VAL_BATCH, device="cuda")
    model = model.cuda()
    outs = {}
    for fused in (False, True):
        step = make_eval_step(cfg.replace(fused_tail=fused), model, device="cuda")
        f1 = init_f1_state(2, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(f1, images, masks, valid), 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        outs[fused] = step(f1, images, masks, valid)[2].float()
        log(f"eval step ({'fused tail' if fused else 'stock tail'}, batch {VAL_BATCH} x 4 TTA "
            f"of {TILE}^2, bf16): {ms:.2f} ms = {VAL_BATCH / ms * 1e3:.3f} tiles/s, peak "
            f"memory {peak:.2f} GiB")
    ref, got = outs[False], outs[True]
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"fused vs stock logits: max abs diff {diff:.4g}, max |logit| {scale:.4g}, argmax "
        f"agreement {agree:.5f} (tolerance: diff <= 0.05*max|logit|, agreement >= 0.99)")
    if not (math.isfinite(diff) and diff <= 0.05 * scale and agree >= 0.99):
        raise AssertionError("fused and stock eval paths disagree")
    check_f32_against_cpu()

    if profile:
        for fused in (False, True):
            step = make_eval_step(cfg.replace(fused_tail=fused), model, device="cuda")
            f1 = init_f1_state(2, device="cuda")
            profile_step(lambda: step(f1, images, masks, valid),
                         f"eval step, {'fused' if fused else 'stock'} tail")
    return launches


def _drive_train_cli(work: str, results_name: str, extra_argv, need_total: dict, tag: str):
    """``main([--exec_mode train ...])`` on the synthetic train split with the
    launch counters set to 0 just before and read just after; then its log
    and both checkpoints are checked.  Returns the launch counts."""
    import torch

    from xview2_tpu_torch.main import main as port_main
    from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
    from xview2_tpu_torch.train.trainer import initial_model
    from xview2_tpu_torch.weights import from_flax

    results = os.path.join(work, results_name)
    argv = ["--exec_mode", "train", "--type", "pre", "--encoder", "resnet50", "--fused_tail",
            "1", "--batch_size", str(TRAIN_BATCH), "--epochs", "1", "--val_batch_size",
            str(VAL_BATCH), "--num_workers", "8", "--data", work, "--results", results]
    argv += list(extra_argv)
    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = port_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    steps = TRAIN_TILES // TRAIN_BATCH
    log(f"{tag} main path: main(--exec_mode train {' '.join(extra_argv)}, {TRAIN_TILES} tiles = "
        f"{steps} steps at batch {TRAIN_BATCH} of {CROP}^2 crops, validation on "
        f"{TRAIN_VAL_TILES} tiles, best and last checkpoints) {wall:.2f} s end to end (index "
        f"build, model build and PNG decode included); launches {launches}")
    _need_launches(launches, dict({k: n * steps for k, n in TRAIN_NEED.items()}, **need_total),
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


def _raw_train_batch():
    """A device-resident batch of raw tiles for the steady-state timings."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13)
    images = torch.from_numpy(
        rng.integers(0, 256, (TRAIN_BATCH, TILE, TILE, 3), np.uint8)).cuda()
    masks = torch.from_numpy((rng.random((TRAIN_BATCH, TILE, TILE)) > 0.9)
                             .astype(np.uint8)).cuda()
    return images, masks


def _time_train_step(cfg, images, masks, profile: bool, tag: str) -> None:
    """Steady state of the train step of ``cfg`` on a device-resident batch:
    CUDA events over 3 steps after 1 warm-up, peak memory, launch counts."""
    import torch

    from xview2_tpu_torch.parallel.steps import (init_train_state, make_train_step,
                                                 step_generator)
    from xview2_tpu_torch.train.optimizers import build_optimizer

    model = seeded_model(cfg, seed=0)
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
    log(f"train step ({tag}, batch {TRAIN_BATCH} raw {TILE}^2 tiles -> {CROP}^2 crops, bf16, "
        f"AdamW): {ms:.2f} ms = {TRAIN_BATCH / ms * 1e3:.3f} tiles/s, peak memory {peak:.2f} "
        f"GiB, losses {[round(v, 4) for v in vals]}, launches over 4 steps "
        f"{ {k: v for k, v in _read_counters().items() if v} }")
    if profile:
        profile_step(one_step, f"train step, {tag}")
    del model, opt, state, step
    torch.cuda.empty_cache()


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
    launches = _drive_train_cli(work, "train_results", [], {}, "train")

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


def check_autoaugment_against_cpu() -> None:
    """The --autoaugment chain (crop, AutoAugment, normalize) on the card,
    through K6, against the same chain on the CPU, through the plain
    version, on the same draws at full size (16 raw 1024^2 tiles -> 512^2
    crops).  Labels EQUAL.  The image within 1e-5 of the normalized scale,
    except where contrast's mean (a float32 sum of 262,144 pixels, in another
    order on the card) lands on another side of .5."""
    import torch

    from xview2_tpu_torch.ops import augment, autoaugment, rowshift

    images, masks = _raw_train_batch()
    gen = torch.Generator().manual_seed(21)
    d = augment.draw_augment_autoaugment(gen, masks.cpu(), CROP)
    # every subpolicy with a spatial op at least once, slots forced to fire
    pol = torch.tensor([0, 5, 8, 10, 11, 15, 18, 18], dtype=d.aa.policy.dtype)[:TRAIN_BATCH]
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
    log(f"--autoaugment chain ({TRAIN_BATCH} x {TILE}^2 -> {CROP}^2, every spatial subpolicy "
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

    launches = _drive_train_cli(work, "autoaugment_results", ["--autoaugment"],
                                {"row_shift_cuda": 1}, "--autoaugment train")
    check_autoaugment_against_cpu()
    images, masks = _raw_train_batch()
    base = Config(type="pre", encoder="resnet50", precision=16, loss_str="focal+dice",
                  batch_size=TRAIN_BATCH, optimizer="adamw", fused_tail=True)
    for aa in (False, True, True, False):
        _time_train_step(base.replace(autoaugment=aa), images, masks, profile and aa,
                         "fused tail, --autoaugment" if aa else "fused tail, plain augmentation")
    return launches


def check_f32_train_step_against_cpu() -> None:
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
    scale."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.ops import packed_fused_conv as pfc
    from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels
    from xview2_tpu_torch.parallel.steps import forward_loss

    base = Config(type="pre", encoder="resnet50", precision=32)
    apply_precision(base)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(4, 256, 256, 3)).astype(np.float32))
    y = packed_loss_view_labels(torch.from_numpy((rng.random((4, 256, 256)) > 0.7)
                                                 .astype(np.int32)))
    loss_fn = make_loss_fn(base.loss_str, base.type)

    def run(dev, fused):
        cfg = base.replace(fused_tail=fused)
        model = seeded_model(cfg, seed=2).to(dev)
        before = pfc.conv_bn_wgrad.launches + pfc.conv_bn_dgrad.launches
        loss = forward_loss(cfg, model, loss_fn, x.to(dev), y.to(dev))
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
    tail = [k for k in gc if any(f"dec_layers_{i}.conv_block" in k for i in (1, 2, 4))]
    err_all, floor_all = rel_l2(gg, gc, list(gc)), rel_l2(gs, gc, list(gc))
    err_tail = max(rel_l2(gg, gc, [k]) for k in tail)
    floor_tail = max(rel_l2(gs, gc, [k]) for k in tail)
    card_all = rel_l2(gg, gs, list(gs))
    card_tail = max(rel_l2(gg, gs, [k]) for k in tail)
    stat_err = max(float((sg[k] - sc[k]).abs().max() / sc[k].abs().max()) for k in sc)
    log(f"f32 train step (4 x 256^2, fused tail), card vs CPU plain path: loss {lg:.6f} vs "
        f"{lc:.6f}; gradients relative L2 error {err_all:.3g} over all {len(gc)} leaves, worst "
        f"of the {len(tail)} fused-tail leaves {err_tail:.3g} (tolerance 5e-2; the card's stock "
        f"tail, no kernel of the port, is {floor_all:.3g} and {floor_tail:.3g} from the CPU, "
        f"loss {ls:.6f}; fused against stock tail on the card: {card_all:.3g} and "
        f"{card_tail:.3g}); running statistics max err {stat_err:.3g} of scale (tolerance "
        f"1e-3); {ng} K4+K5 launches on the card, {nc} on the CPU")
    if not (ng > 0 and nc == 0 and abs(lg - lc) <= 1e-4 * abs(lc) and stat_err <= 1e-3
            and max(err_all, err_tail, card_all, card_tail) <= 5e-2):
        raise AssertionError("float32 train step on the card disagrees with the CPU path")


def check_f32_against_cpu() -> None:
    """The whole eval step in float32 on a small input: on the card (fused
    tail through the f32 kernels, TF32 off) against the port's plain path on
    the CPU, at rtol = atol = 2e-4 of the logits' scale (float32 sums in
    another order through ResNet-50's depth)."""
    import numpy as np
    import torch

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.ops import packed_fused_conv as pfc
    from xview2_tpu_torch.ops.metrics import init_f1_state
    from xview2_tpu_torch.parallel.steps import make_eval_step

    cfg = Config(type="pre", encoder="resnet50", precision=32, tta=True, fused_tail=True)
    apply_precision(cfg)
    model = seeded_model(cfg, seed=1)
    rng = np.random.default_rng(5)
    data = (rng.integers(0, 256, (2, 64, 64, 3), np.uint8),
            (rng.random((2, 64, 64)) > 0.8).astype(np.uint8), np.ones(2, np.float32))
    _, loss_c, logits_c = make_eval_step(cfg, model, device="cpu")(init_f1_state(2), *data)
    before = pfc.conv_bn_fused.launches + pfc.head_conv_fused.launches
    _, loss_g, logits_g = make_eval_step(cfg, model.cuda(), device="cuda")(
        init_f1_state(2, device="cuda"), *data)
    launched = pfc.conv_bn_fused.launches + pfc.head_conv_fused.launches - before
    logits_g = logits_g.cpu()
    scale = max(1.0, logits_c.abs().max().item())
    diff = (logits_g - logits_c).abs().max().item()
    agree = (logits_g.argmax(-1) == logits_c.argmax(-1)).float().mean().item()
    log(f"f32 eval step (2 x 64^2, TTA, fused tail), card vs CPU plain path: max abs diff "
        f"{diff:.4g}, max |logit| {scale:.4g}, loss {loss_g.item():.6f} vs {loss_c.item():.6f}, "
        f"argmax agreement {agree:.5f}, {launched} fused-kernel launches (tolerance 2e-4 "
        f"* max(1, max|logit|))")
    if not (launched > 0 and diff <= 2e-4 * scale
            and abs(loss_g.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item())):
        raise AssertionError("float32 eval step on the card disagrees with the CPU path")


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
    rows.update(check_conv_bn_backward())
    check_prologue_bit_equal()
    check_dgrad_epilogue_bit_equal()
    torch.cuda.empty_cache()
    rows["row_shift"] = check_row_shift()
    rows.update(check_small_conv())
    torch.cuda.empty_cache()
    log(f"kernel checks done at {time.perf_counter() - t_start:.0f} s")

    work = os.path.join(ROOT, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        eval_launches = run_eval_path(work, args.profile)
        torch.cuda.empty_cache()
        log(f"eval path done at {time.perf_counter() - t_start:.0f} s")
        train_launches = run_train_path(work, args.profile)
        torch.cuda.empty_cache()
        log(f"train path done at {time.perf_counter() - t_start:.0f} s")
        small_launches = run_small_conv_path()
        torch.cuda.empty_cache()
        aa_launches = run_autoaugment_path(work, args.profile)
        log(f"--autoaugment path done at {time.perf_counter() - t_start:.0f} s")
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
    # launches: the four main paths' runs (eval CLI, train CLI, conv3x3_small,
    # --autoaugment train CLI), each counted from 0.  ms/plain_ms/library_ms/
    # bound_ms: K1-K3 per eval step (train_* keys: per train step), K4/K5 per
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
                        "launches": eval_launches[counter] + train_launches[counter]
                        + small_launches[counter] + aa_launches[counter],
                        "eval_path_launches": eval_launches[counter],
                        "train_path_launches": train_launches[counter],
                        "small_conv_path_launches": small_launches[counter],
                        "autoaugment_path_launches": aa_launches[counter],
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
