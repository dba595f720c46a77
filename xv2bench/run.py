"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 xv2bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, CUDA, the seeded weights, the pool, the warm-up) is timed
from the start of this file to the first timed call.  The window then runs
the cell's call in a closed loop for ``--seconds``.  With ``--trace 1`` a
profiled slice of a few calls follows, and the result carries the cell's
per-layer metrics instead of its end-to-end ones.  After the window the
program is freed and the plain reference checks what the timed path
produced; each compared number is printed beside its limit, last on
standard error and last in the result line.  The last line of standard
output is the result: one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda"))

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "xview2_tpu"}


def forbidden_modules() -> set:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``xview2_tpu_torch`` is not ``xview2_tpu``)."""
    return {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache at a fixed path inside the checkout (the port's kernels build
    # into xview2_tpu_torch/_build/ there already)
    for var, sub in CACHES:
        os.environ[var] = os.path.join(ROOT, ".xv2bench_cache", sub)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)
    import torch

    from xv2bench import cells

    cell = cells.load(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from xv2bench import measure

    result = measure.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {sorted(found)}: the benchmark and the port must not",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
