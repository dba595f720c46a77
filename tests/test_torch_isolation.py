"""The port stands alone: every ``xview2_tpu_torch`` module and
``chip_smoke.py`` import with ``jax``, ``flax``, ``optax``, ``orbax`` and the
JAX package blocked, and asking for CUDA without a CUDA device raises."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "xview2_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT)
""")


def _run(body: str) -> subprocess.CompletedProcess:
    code = f"ROOT = {ROOT!r}\n" + _BLOCKER + textwrap.dedent(body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT, env=env)


def test_every_port_module_imports_without_jax():
    proc = _run("""
        import importlib, os, pkgutil
        import xview2_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(xview2_tpu_torch.__path__,
                                                       "xview2_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print(len(names))
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 16


def test_cuda_request_without_a_device_raises():
    proc = _run("""
        import torch
        torch.cuda.is_available = lambda: False
        from xview2_tpu_torch.main import main
        try:
            main(["--exec_mode", "eval", "--type", "pre", "--ckpt", "/nonexistent"],
                 device="cuda")
        except (RuntimeError, FileNotFoundError) as e:
            print(type(e).__name__)
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "RuntimeError"


def test_chip_smoke_fails_without_a_card():
    proc = _run("""
        import torch
        torch.cuda.is_available = lambda: False
        import chip_smoke
        sys.exit(chip_smoke.main([]))
    """)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
