"""The port stands alone: every ``xview2_tpu_torch`` module and the card
scripts (``chip_smoke.py``, ``kernel_ab.py``, ``option_gate_spread.py``,
``rounding_witness.py``) import with ``jax``, ``flax``, ``optax``,
``orbax``, the JAX package, ``cv2`` and ``joblib`` blocked (the card's
machine has neither of the last two), and asking for CUDA without a CUDA
device raises."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "xview2_tpu", "cv2",
               "joblib")

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
        import kernel_ab
        import option_gate_spread
        import rounding_witness
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print(len(names))
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 31


def test_no_port_source_names_the_jax_stack():
    """A static read of every port source and the card scripts: no
    import of jax, flax, optax, orbax, chex, the JAX package, cv2 or joblib,
    lazy ones included."""
    import re

    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|orbax|chex|xview2_tpu|cv2|"
                     r"joblib)\b", re.M)
    files = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "kernel_ab.py",
                                                   "option_gate_spread.py",
                                                   "rounding_witness.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "xview2_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) >= 33
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
    expected = {"data/index.py", "data/exclude_list.py", "train/optimizers.py",
                "train/scheduler.py", "csrc/fused_conv_bwd.cu", "csrc/conv_tile.cuh",
                "ops/rowshift.py", "ops/autoaugment.py", "ops/small_conv.py",
                "csrc/rowshift.cu", "csrc/small_conv.cu", "parallel/mesh.py"}
    for rel in expected:
        assert os.path.exists(os.path.join(ROOT, "xview2_tpu_torch", rel)), rel


def test_options_left_out_raise_naming_a_roadmap_item():
    """Every option outside the ported slices raises NotImplementedError
    naming its ROADMAP item; none returns numbers.  The decoder options
    (``--ppm``, ``--aspp``, ``--attention``, ``--deep_supervision``,
    ``--dec_interp``, ``--interpolate``, alone and together, for ``UNetLoc``
    and the damage variants, ``fused --ppm`` among them) and the recipe's
    options (``--pretrained_enc``, ``--remat``, ``--fold_eval_bn 0``, every
    ``--optimizer``), ``--gpus`` and ``--spatial_shards`` with every option
    (the decoder options, the eight damage variants, ``--remat``, in train
    and in eval mode, at ``--gpus 2`` and ``--gpus 4``) are ported: the
    checks ``main`` runs before it spawns a rank let them through and
    ``build_model`` builds them, and ``make_train_multistep`` on CUDA (its
    CUDA graph) takes ``--autoaugment``.  What still raises:
    ``make_train_multistep`` on CUDA under a gloo group."""
    proc = _run("""
        import torch
        from xview2_tpu_torch.config import Config, parse_args
        from xview2_tpu_torch.models.unet import build_model
        from xview2_tpu_torch.parallel import steps
        from xview2_tpu_torch.train import trainer

        def raises(fn, what):
            try:
                fn()
            except NotImplementedError as e:
                assert "ROADMAP" in str(e), (what, str(e))
                return
            raise AssertionError(f"{what} did not raise NotImplementedError")

        # the graph path of make_train_multistep, checked before it touches a card
        import torch.distributed as dist
        from xview2_tpu_torch.parallel import mesh
        available, torch.cuda.is_available = torch.cuda.is_available, lambda: True
        graphs = [steps.make_train_multistep(Config(**kw), None, None, 2, device="cuda")
                  for kw in (dict(autoaugment=True), dict(type="post", autoaugment=True))]
        mesh.init_data_parallel(1, 0, backend="gloo", device="cpu", store=dist.HashStore())
        raises(lambda: steps.make_train_multistep(Config(gpus=1), None, None, 2, device="cuda"),
               "make_train_multistep under a gloo group")
        mesh.shutdown()
        torch.cuda.is_available = available
        # --spatial_shards with every other option, through the CLI's parser
        # and the checks main runs before it spawns the ranks
        train = ["--exec_mode", "train", "--type", "pre", "--encoder", "resnet50",
                 "--results", "/nonexistent"]
        shards = ["--gpus", "2", "--spatial_shards", "2"]
        options = [["--ppm"], ["--aspp"], ["--attention"], ["--deep_supervision"],
                   ["--dec_interp"], ["--interpolate"], ["--remat", "tail"],
                   ["--remat", "full"]]
        options += [["--type", "post", "--dmg_model", m] for m in (
            "siameseEnc", "fused", "fusedEnc", "parallel", "parallelEnc", "diff", "cat")]
        cli = [train + shards + extra for extra in options]
        cli += [train + ["--gpus", "4", "--spatial_shards", "2", "--ppm"]]
        cli += [["--exec_mode", "eval", "--type", "pre", "--ckpt", "/nonexistent"] + shards
                + ["--attention"]]
        for argv in cli:
            cfg = parse_args(argv)
            assert trainer._check_supported(cfg) is None, argv
            with torch.device("meta"):
                build_model(cfg)
        # --autoaugment, on pairs too, the damage variants, the mse and coral
        # heads and the decoder options are ported: the checks let them through
        ported = [dict(autoaugment=True), dict(type="post", autoaugment=True),
                  dict(type="post", dmg_model="fused", loss_str="coral"),
                  dict(type="post", dmg_model="cat", loss_str="mse"),
                  dict(type="post", dmg_model="fused", ppm=True),
                  dict(type="post", dmg_model="parallel", attention=True),
                  dict(type="post", dmg_model="cat", deep_supervision=True),
                  dict(ppm=True), dict(aspp=True), dict(attention=True),
                  dict(deep_supervision=True), dict(dec_interp=True), dict(interpolate=True),
                  dict(type="post", loss_str="coral", aspp=True),
                  dict(attention=True, deep_supervision=True, ppm=True, dec_interp=True),
                  dict(pretrained_enc="enc.npz"), dict(remat="tail"), dict(remat="dots"),
                  dict(remat="full"), dict(fold_eval_bn=False), dict(gpus=2),
                  dict(gpus=2, spatial_shards=2), dict(gpus=4, spatial_shards=2, dilation=2),
                  dict(gpus=2, spatial_shards=2, type="post", autoaugment=True,
                       loss_str="ohem+dice"),
                  dict(gpus=2, spatial_shards=2, encoder="resnest50", fused_tail=True)]
        ported += [dict(optimizer=o) for o in ("radam", "adabelief", "adabound", "adamp",
                                               "novograd")]
        for kw in ported:
            cfg = Config(**{"encoder": "resnet50", **kw})
            assert trainer._check_fit_supported(cfg) is None, kw
            with torch.device("meta"):
                build_model(cfg)
        print("checked", 1, "raising,", len(cli) + len(ported) + len(graphs), "ported")
    """)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert proc.stdout.split()[-5:] == ["checked", "1", "raising,", "49", "ported"]


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


def test_option_gate_spread_fails_without_a_card():
    proc = _run("""
        import torch
        torch.cuda.is_available = lambda: False
        import option_gate_spread
        sys.exit(option_gate_spread.main([]))
    """)
    assert proc.returncode == 1
    assert "readings" not in proc.stdout


def test_rounding_witness_fails_without_a_card():
    proc = _run("""
        import torch
        torch.cuda.is_available = lambda: False
        import rounding_witness
        sys.exit(rounding_witness.main([]))
    """)
    assert proc.returncode == 1
    assert "readings" not in proc.stdout
