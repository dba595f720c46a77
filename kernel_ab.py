#!/usr/bin/env python3
"""A/B timings of versions of one of the port's CUDA sources on one NVIDIA GPU.

Run from the root of a checkout on a machine with the card::

    python3 kernel_ab.py dgrad TAG=PATH [TAG=PATH ...]
    python3 kernel_ab.py head TAG=PATH [TAG=PATH ...]
    python3 kernel_ab.py small TAG=PATH [TAG=PATH ...]
    python3 kernel_ab.py relayout TAG=PATH [TAG=PATH ...]
    python3 kernel_ab.py wgrad TAG=PATH [TAG=PATH ...]
    python3 kernel_ab.py rowshift TAG=PATH [TAG=PATH ...]

``dgrad`` times K5 ``conv_bn_dgrad`` (``csrc/fused_conv_bwd.cu``) at the six
train-path layers, fold on and off; ``head`` times K3 ``head_conv_fused``
(``csrc/fused_head.cu``) at the eval and train shapes; ``small`` times K7
``small_conv_fwd`` (``csrc/small_conv.cu``) in bf16 at the smoke's shape
(16, 512, 512, 32) -> 32 and its odd shape (2, 70, 200, 24) -> 40;
``relayout`` times K1's flat path ``relayout_flat`` (``csrc/relayout.cu``) on
the eval logits (4, 1024, 1024, 2) f32 and the train labels (16, 256, 1024)
int32; ``wgrad`` times K8 ``small_conv_wgrad`` (``csrc/small_conv.cu``) in
bf16 at the smoke's shape and the odd shape, each version's dW held against
the plain version and against two runs of itself; ``rowshift`` times K6
``row_shift`` (``csrc/rowshift.cu``) at the three launches of the
``--autoaugment`` path at a batch of 16 (the shear of 512^2 crops, the
rotation's row and column passes at 512 x 654).  Each PATH is a whole
edited copy of that source file, kept outside the committed sources (in a
directory that ``.gitignore`` lists); the committed source runs beside them
as ``kept``.  Each version is compiled by ``nvcc`` with ``cuda_build``'s
flags and ``-Xptxas -v`` into a library of its own, all builds at once, and
the kernel's registers, spills and serialized-``wgmma`` remarks (C7513) are
printed.  The C entry points are called through ctypes with inputs prepared
once, so no Python wrapper's host time is in the numbers; the versions are
timed by CUDA events in turns (A, B, ..., B, A) in one process on one card,
and each line gives both passes and whether the output equals ``kept``'s.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
P, I = ctypes.c_void_p, ctypes.c_int


def log(msg: str) -> None:
    print(msg, flush=True)


def parse_variants(args) -> dict:
    """``TAG=PATH`` arguments -> {tag: path}; ``kept`` (the committed source)
    comes first and no other version may take its tag."""
    variants = {"kept": None}
    for arg in args:
        tag, sep, path = arg.partition("=")
        if not sep or not tag or not path:
            raise ValueError(f"a version is TAG=PATH, not {arg!r}")
        if tag in variants:
            raise ValueError(f"the tag {tag!r} is given twice or is the committed source's")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        variants[tag] = os.path.abspath(path)
    return variants


def stage_variant(workdir: str, name: str, tag: str, path) -> str:
    """A copy of csrc/ in ``workdir`` with ``path`` in place of ``name``.cu
    (none: the committed source); returns the path of that .cu file."""
    from xview2_tpu_torch.ops import cuda_build

    d = os.path.join(workdir, f"{name}-{tag}")
    shutil.copytree(cuda_build.CSRC, d)
    src = os.path.join(d, f"{name}.cu")
    if path is not None:
        shutil.copyfile(path, src)
    return src


def start_build(src: str):
    """Start nvcc on ``src``; returns (process, library path)."""
    from xview2_tpu_torch.ops import cuda_build

    out = os.path.join(os.path.dirname(src), "libvariant.so")
    cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def finish_builds(started: dict, kernel_name: str) -> dict:
    """Wait for the builds; print each kernel's registers and any spill or
    serialized-wgmma remark of ``kernel_name``; return tag -> library."""
    libs = {}
    for tag, (proc, out) in started.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for version {tag}:\n{text[-4000:]}")
        fn = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            if kernel_name in fn and ("Used" in line or "C7513" in line
                                      or ("spill" in line and " 0 bytes spill stores" not in line)):
                name = fn[fn.find(kernel_name):][:40]
                log(f"  ptxas [{tag}] {name}: {line.split(':', 1)[-1].strip()}")
        libs[tag] = ctypes.CDLL(out)
    return libs


def in_turns(fns: dict, iters: int) -> dict:
    """Each function timed twice, in the order given and then reversed."""
    import chip_smoke as cs

    times = {t: [] for t in fns}
    for t in list(fns) + list(fns)[::-1]:
        times[t].append(cs.cuda_ms(fns[t], iters, warmup=2))
    return times


def time_dgrad(libs: dict) -> None:
    import torch

    import chip_smoke as cs
    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    stream = torch.cuda.current_stream().cuda_stream
    total = {}
    for i, (name, b, h, w, c, co) in enumerate(cs.TRAIN_PATH):
        x, g, k, fold = cs.bwd_case(b, h, w, c, co, torch.bfloat16, seed=70 + i)
        kf = pfc.flip_kernel(k).contiguous()
        fmat = torch.stack(fold).float().contiguous()
        dx = {t: torch.empty_like(x) for t in libs}
        db, dm = torch.zeros(c, device="cuda"), torch.zeros(c, device="cuda")
        flops = 2.0 * b * h * w * 9 * c * co
        for has_fold in (True, False):
            fns = {}
            for tag, lib in libs.items():
                fn = lib.conv_bn_dgrad
                fn.argtypes = [P] * 7 + [I] * 6 + [P]
                args = (g.data_ptr(), kf.data_ptr(), x.data_ptr(),
                        fmat.data_ptr() if has_fold else None, dx[tag].data_ptr(),
                        db.data_ptr(), dm.data_ptr(), b, h, w, co, c, 1, stream)
                fns[tag] = (lambda fn=fn, args=args: fn(*args))
            times = in_turns(fns, 10)
            same = {t: torch.equal(dx[t], dx["kept"]) for t in dx}
            on_path = has_fold == name.endswith("conv2")
            log(f"K5 {name} {(b, h, w, c)}->{co} fold={has_fold}{' (path)' if on_path else ''}: "
                + "; ".join(f"{t} {v[0]:.3f}/{v[1]:.3f} ms ({2 * flops / sum(v) / 1e9:.0f} "
                            f"TFLOP/s{'' if same[t] else ', dx differs'})"
                            for t, v in times.items()))
            if on_path:
                for t, v in times.items():
                    total[t] = total.get(t, 0.0) + sum(v) / 2
        del x, g, k, kf, dx
        torch.cuda.empty_cache()
    log("K5 per train step (6 launches, the path's folds): "
        + "; ".join(f"{t} {v:.3f} ms" for t, v in total.items()))


def time_head(libs: dict) -> None:
    import torch

    import chip_smoke as cs

    stream = torch.cuda.current_stream().cuda_stream
    for tag_shape, shape in (("eval", (16, 512, 512, 128)), ("train", (16, 256, 256, 128))):
        x, kmat, hbias, fold = cs.head_case(shape, 8, seed=40)
        k32 = kmat.to(torch.bfloat16).float().contiguous()
        fmat = torch.stack(fold).float().contiguous()
        out = {t: torch.empty(shape[:3] + (8,), device="cuda", dtype=torch.bfloat16) for t in libs}
        fns = {}
        for tag, lib in libs.items():
            fn = lib.head_conv_fused
            fn.argtypes = [P] * 5 + [ctypes.c_longlong, I, I, I, P]
            args = (x.data_ptr(), k32.data_ptr(), fmat.data_ptr(), hbias.data_ptr(),
                    out[tag].data_ptr(), x.numel() // shape[3], shape[3], 8, 1, stream)
            fns[tag] = (lambda fn=fn, args=args: fn(*args))
        times = in_turns(fns, 20)
        nbytes = x.numel() * 2 + x.numel() // shape[3] * 16
        log(f"K3 {tag_shape} {shape}->8: "
            + "; ".join(f"{t} {v[0]:.4f}/{v[1]:.4f} ms ({2 * nbytes / sum(v) / 1e9:.3f} TB/s"
                        f"{'' if torch.equal(out[t], out['kept']) else ', out differs'})"
                        for t, v in times.items()))
        del x, out


def time_small(libs: dict) -> None:
    import torch

    import chip_smoke as cs
    from xview2_tpu_torch.ops import small_conv as sc

    stream = torch.cuda.current_stream().cuda_stream
    for tag_shape, shape in (("smoke", cs.SMALL_CONV), ("odd", (2, 70, 200, 24, 40))):
        b, h, w, c, co = shape
        x, _, k = cs._small_conv_case(shape, torch.bfloat16, seed=80)
        kmat = sc.kernel_to_mat(k).contiguous()
        out = {t: torch.empty((b, h, w, co), device="cuda", dtype=torch.bfloat16) for t in libs}
        fns = {}
        for tag, lib in libs.items():
            fn = lib.small_conv_fwd
            fn.argtypes = [P] * 3 + [I] * 6 + [P]
            args = (x.data_ptr(), kmat.data_ptr(), out[tag].data_ptr(), b, h, w, c, co, 1, stream)
            fns[tag] = (lambda fn=fn, args=args: fn(*args))
        times = in_turns(fns, 20)
        nbytes = b * h * w * (c + co) * 2 + 9 * c * co * 2
        want = sc.reference_conv3x3(x, kmat)
        ok = {t: cs._compare_small_fwd(o, want, f"K7 [{t}] {shape}") for t, o in out.items()}
        log(f"K7 {tag_shape} {shape[:4]}->{co}: "
            + "; ".join(f"{t} {v[0]:.4f}/{v[1]:.4f} ms ({2 * nbytes / sum(v) / 1e9:.3f} TB/s, "
                        f"max abs err {ok[t]:.3g}"
                        f"{'' if torch.equal(out[t], out['kept']) else ', out differs'})"
                        for t, v in times.items()))
        del x, out


def time_relayout(libs: dict) -> None:
    import torch

    import chip_smoke as cs

    stream = torch.cuda.current_stream().cuda_stream
    for tag_shape, x in (("eval logits", torch.randn((cs.VAL_BATCH, cs.TILE, cs.TILE, 2),
                                                      device="cuda")),
                         ("train labels", torch.randint(0, 2, (cs.TRAIN_BATCH, cs.CROP // 2,
                                                               2 * cs.CROP), device="cuda",
                                                        dtype=torch.int32))):
        out = {t: torch.empty_like(x) for t in libs}
        fns = {}
        for tag, lib in libs.items():
            fn = lib.relayout_flat
            fn.argtypes = [P, P, ctypes.c_longlong, P]
            args = (x.data_ptr(), out[tag].data_ptr(), x.nbytes, stream)
            fns[tag] = (lambda fn=fn, args=args: fn(*args))
        times = in_turns(fns, 50)
        log(f"K1 flat {tag_shape} {tuple(x.shape)} {x.dtype}: "
            + "; ".join(f"{t} {v[0]:.4f}/{v[1]:.4f} ms ({4 * x.nbytes / sum(v) / 1e9:.3f} TB/s"
                        f"{'' if torch.equal(out[t], x) else ', NOT EQUAL'})"
                        for t, v in times.items()))
        del x, out


def time_wgrad(libs: dict) -> None:
    import torch

    import chip_smoke as cs
    from xview2_tpu_torch.ops import small_conv as sc

    stream = torch.cuda.current_stream().cuda_stream
    slots = sc._sm_count(torch.cuda.current_device())
    for tag_shape, shape in (("smoke", cs.SMALL_CONV), ("odd", (2, 70, 200, 24, 40))):
        b, h, w, c, co = shape
        x, g, _ = cs._small_conv_case(shape, torch.bfloat16, seed=80)
        out = {t: torch.empty((9 * c, co), device="cuda") for t in libs}
        ws = torch.empty((slots, 9 * c, co), device="cuda")
        fns = {}
        for tag, lib in libs.items():
            fn = lib.small_conv_wgrad
            fn.argtypes = list(sc._WGRAD_ARGS)
            args = (x.data_ptr(), g.data_ptr(), out[tag].data_ptr(), ws.data_ptr(), b, h, w, c,
                    co, 1, slots, stream)
            fns[tag] = (lambda fn=fn, args=args: fn(*args))
        first = {}
        for t, fn in fns.items():  # one run each, kept to hold the timed runs against
            fn()
            first[t] = out[t].clone()
        times = in_turns(fns, 20)
        nbytes = b * h * w * (c + co) * 2 + 9 * c * co * 4
        want = sc.reference_wgrad(x, g)
        rel = {t: cs._compare_wgrad(o, want, f"K8 [{t}] {shape}")[1] for t, o in out.items()}
        log(f"K8 {tag_shape} {shape[:4]}->{co}: "
            + "; ".join(f"{t} {v[0]:.4f}/{v[1]:.4f} ms ({2 * nbytes / sum(v) / 1e9:.3f} TB/s, "
                        f"{rel[t]:.3g} of max|dW| from the plain version"
                        f"{'' if torch.equal(out[t], first[t]) else ', NOT EQUAL between runs'}"
                        f"{'' if torch.equal(out[t], out['kept']) else ', dW differs from kept'})"
                        for t, v in times.items()))
        del x, g, out, ws


def time_rowshift(libs: dict) -> None:
    import torch

    import chip_smoke as cs
    from xview2_tpu_torch.ops import rowshift

    stream = torch.cuda.current_stream().cuda_stream
    for tag_case, x, shift, sel, axis in cs._row_shift_cases(cs.TRAIN_BATCH):
        b, h, w, c = x.shape
        out = {t: torch.empty_like(x) for t in libs}
        fns = {}
        for tag, lib in libs.items():
            fn = lib.row_shift
            fn.argtypes = list(rowshift._ARGS)
            args = (x.data_ptr(), shift.data_ptr(), sel.data_ptr(), out[tag].data_ptr(), b, h, w,
                    c, axis, stream)
            fns[tag] = (lambda fn=fn, args=args: fn(*args))
        times = in_turns(fns, 20)
        want = rowshift.row_shift_reference(x, shift, sel, axis=axis)
        log(f"K6 {tag_case} {tuple(x.shape)} axis {axis}: "
            + "; ".join(f"{t} {v[0]:.4f}/{v[1]:.4f} ms ({4 * x.nbytes / sum(v) / 1e9:.3f} TB/s"
                        f"{'' if torch.equal(out[t], want) else ', NOT EQUAL to the plain version'})"
                        for t, v in times.items()))
        del x, out


# what the first argument names: (source under csrc/, kernel for ptxas, timer)
KERNELS = {
    "dgrad": ("fused_conv_bwd", "dgrad_wgmma_kernel", time_dgrad),
    "head": ("fused_head", "head_mma_kernel", time_head),
    "small": ("small_conv", "small_fwd_mma_kernel", time_small),
    "relayout": ("relayout", "relayout_flat_kernel", time_relayout),
    "wgrad": ("small_conv", "small_wgrad_mma_kernel", time_wgrad),
    "rowshift": ("rowshift", "row_shift_kernel", time_rowshift),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in KERNELS:
        print(f"usage: kernel_ab.py {{{'|'.join(KERNELS)}}} TAG=PATH [TAG=PATH ...]",
              file=sys.stderr)
        return 2
    name, kernel_name, timer = KERNELS[argv[0]]
    variants = parse_variants(argv[1:])
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    log(f"card: {smi.stdout.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        started = {t: start_build(stage_variant(work, name, t, p)) for t, p in variants.items()}
        libs = finish_builds(started, kernel_name)
        log(f"builds: {time.perf_counter() - t0:.1f} s")
        timer(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
