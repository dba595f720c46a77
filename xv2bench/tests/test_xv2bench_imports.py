"""What the benchmark may import: never JAX, its libraries or the JAX package
(top-level names compared whole: ``xview2_tpu_torch`` is not ``xview2_tpu``);
and its reference nothing of the program."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "xview2_tpu"}


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        if os.path.dirname(path) == HERE:
            continue  # the tests may name what they look for
        found = _top_level_imports(path) & FORBIDDEN
        assert not found, f"{os.path.relpath(path, ROOT)} imports {sorted(found)}"


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        names = _top_level_imports(path)
        assert "xview2_tpu_torch" not in names, f"{path} imports the program"
        assert not names & FORBIDDEN


def test_whole_names_are_compared():
    sys.path.insert(0, BENCH)
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["xview2_tpu_torch_like"] = sys
        sys.modules["xview2_tpu_torch.sub"] = sys
        assert not run.forbidden_modules() & {"xview2_tpu_torch_like", "xview2_tpu_torch"}
        sys.modules["jaxlib.xla"] = sys
        assert run.forbidden_modules() == {"jaxlib"}
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """Importing every module of a run, program included, loads none."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from xv2bench import measure, calibrate, harness, program\n"
            "from xv2bench.reference import steps\n"
            "import xview2_tpu_torch.train.trainer\n"
            "bad = {m.split('.')[0] for m in sys.modules} & %r\n"
            "print(sorted(bad)); sys.exit(1 if bad else 0)\n") % (ROOT, FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
