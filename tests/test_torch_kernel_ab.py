"""kernel_ab.py's staging of source versions, on the CPU (the builds and
timings need nvcc and the card)."""

import filecmp
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import kernel_ab  # noqa: E402
from xview2_tpu_torch.ops import cuda_build  # noqa: E402


def test_parse_variants_keeps_the_committed_source_first(tmp_path):
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// a\n")
    b.write_text("// b\n")
    got = kernel_ab.parse_variants([f"six={a}", f"two={b}"])
    assert list(got) == ["kept", "six", "two"]
    assert got["kept"] is None and got["six"] == str(a) and got["two"] == str(b)


@pytest.mark.parametrize("arg", ["nosep", "=x.cu", "kept={a}", "six={a} six={a}",
                                 "six={tmp}/missing.cu"])
def test_parse_variants_refuses_a_bad_version(tmp_path, arg):
    a = tmp_path / "a.cu"
    a.write_text("// a\n")
    args = arg.format(a=a, tmp=tmp_path).split(" ")
    with pytest.raises((ValueError, FileNotFoundError)):
        kernel_ab.parse_variants(args)


@pytest.mark.parametrize("name", sorted({v[0] for v in kernel_ab.KERNELS.values()}))
def test_stage_variant_replaces_only_the_named_source(tmp_path, name):
    edited = tmp_path / "edited.cu"
    edited.write_text("// an edited version\n")
    kept = kernel_ab.stage_variant(str(tmp_path / "w"), name, "kept", None)
    other = kernel_ab.stage_variant(str(tmp_path / "w"), name, "edited", str(edited))
    assert filecmp.cmp(kept, os.path.join(cuda_build.CSRC, f"{name}.cu"), shallow=False)
    assert open(other).read() == "// an edited version\n"
    # the headers it includes come along unchanged
    for f in os.listdir(cuda_build.CSRC):
        if f != f"{name}.cu":
            assert filecmp.cmp(os.path.join(os.path.dirname(other), f),
                               os.path.join(cuda_build.CSRC, f), shallow=False)
