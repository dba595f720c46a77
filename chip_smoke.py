#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``xview2_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py            # build, check, time, drive the eval CLI
    python3 chip_smoke.py --profile  # also print a per-kernel profile of one eval step

Phases, each of which fails the script (non-zero exit, no result line):

1. the card's name and power limit (``nvidia-smi``) and the versions;
2. build every CUDA kernel of the port from ``xview2_tpu_torch/csrc``, one
   ``nvcc`` per source in parallel;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the eval path gives it, and time the kernel, the plain version
   and one PyTorch library call computing the same function (the yardstick;
   the port never calls it);
4. the main path: a synthetic holdout of 8 tiles of 1024^2, a ResNet-50
   UNetLoc made from a fixed seed saved as a port checkpoint, and
   ``xview2_tpu_torch.main.main([... --exec_mode eval ...])`` with 4-flip TTA
   and the fused decoder tail, with every launch counter set to 0 just
   before and read just after; then the eval step's steady-state rate and
   peak memory, and the fused path against the stock (cuDNN) path;
5. one JSON line listing every kernel, then the ``nvidia-smi`` line, then
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


def bound_ms(nbytes: float, flops: float, dtype: str):
    """Least time for the work: max of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- kernels

def check_relayout():
    import torch

    from xview2_tpu_torch.ops import layout

    gen = torch.Generator(device="cuda").manual_seed(1)
    # the eval logits: (4, 1024, 1024, 2) f32; contiguous as the eval step
    # hands them over, and as an NCHW buffer viewed NHWC (a real relayout)
    shape = (VAL_BATCH, TILE, TILE, 2)
    x_c = torch.randn(shape, generator=gen, device="cuda")
    x_p = torch.randn((VAL_BATCH, 2, TILE, TILE), generator=gen, device="cuda").permute(0, 2, 3, 1)
    rows = {}
    for tag, x in (("contiguous", x_c), ("permuted", x_p)):
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt) if dt != torch.float32 else x
            got = layout.relayout_cuda(xd)
            torch.cuda.synchronize()
            if not (got.is_contiguous() and torch.equal(got, xd)):
                raise AssertionError(f"relayout {tag} {dt}: not a bit-exact contiguous copy")
        ms = cuda_ms(lambda: layout.relayout_cuda(x), 20)
        plain = cuda_ms(lambda: layout.relayout_reference(x), 20)
        lib = cuda_ms(lambda: x.contiguous() if not x.is_contiguous() else x.clone(), 20)
        nbytes = 2 * x.numel() * x.element_size()
        b, by = bound_ms(nbytes, 0.0, "float32")
        log(f"K1 relayout {tag} {tuple(x.shape)} f32: bit-exact (tolerance 0), "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
            f"bound {b:.4f} ms ({by})")
        rows[tag] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b, bound_by=by)
    return rows["permuted"]


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

    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for i, (name, b, h, w, c, co) in enumerate(K2_PATH):
        x, k, fold = _k2_case(b, h, w, c, co, torch.bfloat16, seed=10 + i)
        has_fold = name.endswith("conv2")  # the path: conv1 takes the input as it is
        f = fold if has_fold else None
        for variant in ((fold, True), (fold, False)):
            got = pfc.conv_bn_fused(x, k, *variant)
            want = pfc.reference_conv_bn(x, k, variant[0] if variant[1] else None)
            torch.cuda.synchronize()
            err, rel = _compare_conv(got, want, f"{name} fold={variant[1]}")
            total["max_abs_err"] = max(total["max_abs_err"], err)
            log(f"K2 {name} {(b, h, w, c)}->{co} bf16 fold={variant[1]}: max abs err "
                f"{err:.4g}, max rel err {rel:.4g}, tolerance 2*eps*|out| + 1e-3*max|out|")
        a = pfc.prologue(x, f)
        kc = k.permute(3, 2, 0, 1).contiguous()
        ms = cuda_ms(lambda: pfc.conv_bn_fused(x, k, fold, has_fold), 3)
        plain = cuda_ms(lambda: pfc.reference_conv_bn(x, k, f), 3)
        lib = cuda_ms(lambda: F.conv2d(a.permute(0, 3, 1, 2), kc, padding=1), 3)
        flops = 2.0 * b * h * w * 9 * c * co
        nbytes = (b * h * w * (c + co) + 9 * c * co) * 2 + (3 * c + 2 * co) * 4
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        bound_by.add(by)
        log(f"K2 {name} timing: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain:.3f} ms, library (cuDNN conv) {lib:.3f} ms, bound {bnd:.3f} ms ({by})")
        total["ms"] += ms
        total["plain_ms"] += plain
        total["library_ms"] += lib
        total["bound_ms"] += bnd
        del x, a, k, fold
    # one float32 case (--precision 32): the FMA kernel, no TF32
    x, k, fold = _k2_case(4, 256, 256, 128, 128, torch.float32, seed=30)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = pfc.conv_bn_fused(x, k, fold, True)
        want = pfc.reference_conv_bn(x, k, fold)
        torch.cuda.synchronize()
        err, rel = _compare_conv(got, want, "f32 case")
        ms = cuda_ms(lambda: pfc.conv_bn_fused(x, k, fold, True), 3)
        plain = cuda_ms(lambda: pfc.reference_conv_bn(x, k, fold), 3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"K2 f32 (4, 256, 256, 128)->128 fold=True: max abs err {err:.4g}, max rel err "
        f"{rel:.4g}, kernel {ms:.3f} ms, plain {plain:.3f} ms (TF32 off)")
    total["bound_by"] = "operations" if "operations" in bound_by else "bytes"
    log(f"K2 per eval step (6 launches): kernel {total['ms']:.3f} ms, plain "
        f"{total['plain_ms']:.3f} ms, library {total['library_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms")
    return total


def check_head_conv_fused():
    import torch

    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    gen = torch.Generator(device="cuda").manual_seed(40)
    b, h, w, c, co = 16, 512, 512, 128, 8
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    kmat = torch.randn((c, co), generator=gen, device="cuda") / math.sqrt(c)
    hbias = torch.randn(co, generator=gen, device="cuda")
    fold = (torch.randn(c, generator=gen, device="cuda") * 0.5,
            torch.rand(c, generator=gen, device="cuda") + 0.5,
            torch.randn(c, generator=gen, device="cuda") * 0.5)
    got = pfc.head_conv_fused(x, kmat, hbias, fold)
    want = pfc.reference_head(x, kmat, hbias, fold)
    a = pfc.prologue(x, fold)
    kb = kmat.to(torch.bfloat16)
    gemm = torch.matmul(a, kb).float()
    torch.cuda.synchronize()
    gk, gp = got.float(), want.float()
    err = (gk - gp).abs()
    scale = gp.abs().max().item()
    # two bf16 roundings, after the GEMM (at the GEMM's magnitude, which the
    # bias may cancel) and after the bias: up to one ulp of each apart
    tol = 2 * torch.finfo(torch.bfloat16).eps * (gemm.abs() + gp.abs()) + 1e-3 * scale
    if not bool((err <= tol).all()):
        raise AssertionError(f"head_conv_fused disagrees: max abs err {err.max().item():.4g}")
    ms = cuda_ms(lambda: pfc.head_conv_fused(x, kmat, hbias, fold), 10)
    plain = cuda_ms(lambda: pfc.reference_head(x, kmat, hbias, fold), 10)
    lib = cuda_ms(lambda: torch.matmul(a, kb), 10)
    nbytes = x.numel() * 2 + b * h * w * co * 2 + (c * co + co + 3 * c) * 4
    bnd, by = bound_ms(nbytes, 2.0 * b * h * w * c * co, "bfloat16")
    rel = (err / torch.maximum(gemm.abs(), gp.abs()).clamp_min(1e-3 * scale)).max().item()
    log(f"K3 head {(b, h, w, c)}->{co} bf16: max abs err {err.max().item():.4g}, max rel err "
        f"{rel:.4g} (of max(|gemm|, |out|)), tolerance "
        f"2*eps*(|gemm| + |out|) + 1e-3*max|out|; kernel {ms:.3f} ms, plain {plain:.3f} ms, library "
        f"(matmul) {lib:.3f} ms, bound {bnd:.3f} ms ({by})")
    return dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bnd, bound_by=by)


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


def run_main_path(work: str, profile: bool):
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.data.synthetic import make_synthetic_split
    from xview2_tpu_torch.main import main as port_main
    from xview2_tpu_torch.ops import layout
    from xview2_tpu_torch.ops import packed_fused_conv as pfc
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
    counters = (layout.relayout_cuda, pfc.conv_bn_fused, pfc.head_conv_fused)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = port_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
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
    need = {"relayout_cuda": steps, "conv_bn_fused": 6 * steps, "head_conv_fused": steps}
    for k, n in need.items():
        if launches[k] < n:
            raise AssertionError(f"{k} launched {launches[k]} times on the main path, "
                                 f"expected >= {n}")
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
            profile_step(make_eval_step(cfg.replace(fused_tail=fused), model, device="cuda"),
                         (images, masks, valid), "fused tail" if fused else "stock tail")
    return launches


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


# kernel-name fragments -> category of the eval-step breakdown
_CATEGORIES = (("K2 conv_bn_fused", ("conv_bf16_kernel", "conv_f32_kernel")),
               ("K3 head_conv_fused", ("head_kernel",)),
               ("K1 relayout", ("relayout_kernel",)),
               ("library conv/GEMM", ("xmma", "cudnn", "cutlass", "gemm", "conv")),
               ("elementwise", ("elementwise", "reduce")),
               ("cat/copy", ("CatArray", "copy", "Memcpy", "Memset")))


def profile_step(step, batch, tag: str) -> None:
    """torch.profiler over one eval step: device time by category, the
    device's idle share of the step's wall time, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from xview2_tpu_torch.ops.metrics import init_f1_state

    f1 = init_f1_state(2, device="cuda")
    step(f1, *batch)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(f1, *batch)
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
                        help="print a torch.profiler table of one eval step")
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

    log(f"kernel build: {cuda_build.build_all():.1f} s (nvcc, one per source, in parallel)")
    rows = {"relayout": check_relayout(), "conv_bn_fused": check_conv_bn_fused(),
            "head_conv_fused": check_head_conv_fused()}
    torch.cuda.empty_cache()

    work = os.path.join(ROOT, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        launches = run_main_path(work, args.profile)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    meta = {
        "relayout": ("relayout_cuda", "xview2_tpu_torch/csrc/relayout.cu",
                     "xview2_tpu/ops/layout.py:79"),
        "conv_bn_fused": ("conv_bn_fused", "xview2_tpu_torch/csrc/fused_conv.cu",
                          "xview2_tpu/ops/packed_fused_conv.py:157"),
        "head_conv_fused": ("head_conv_fused", "xview2_tpu_torch/csrc/fused_head.cu",
                            "xview2_tpu/ops/packed_fused_conv.py:463"),
    }
    kernels = []
    for name, (counter, source, replaces) in meta.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[counter], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
