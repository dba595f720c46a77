"""``cuda_build.function`` binds each C entry point once, on the CPU: the
kernel libraries are stood in for by the C library."""

import ctypes
import ctypes.util

import pytest

from xview2_tpu_torch.ops import cuda_build

P, I, SIZE = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t


@pytest.fixture
def libc(monkeypatch):
    lib = ctypes.CDLL(ctypes.util.find_library("c"))
    looked_up = []
    monkeypatch.setattr(cuda_build, "library", lambda name: looked_up.append(name) or lib)
    monkeypatch.setattr(cuda_build, "_FUNCS", {})
    return looked_up


def test_a_second_call_does_no_lookup(libc):
    first = cuda_build.function("libc", "memset", (P, I, SIZE))
    second = cuda_build.function("libc", "memset", (P, I, SIZE))
    assert second is first and libc == ["libc"]
    assert list(first.argtypes) == [P, I, SIZE] and first.restype is ctypes.c_int
    # a list of the same types is the same declaration
    assert cuda_build.function("libc", "memset", [P, I, SIZE]) is first and libc == ["libc"]


def test_other_argtypes_raise(libc):
    fn = cuda_build.function("libc", "memset", (P, I, SIZE))
    with pytest.raises(ValueError, match="memset"):
        cuda_build.function("libc", "memset", (P, P, SIZE))
    assert list(fn.argtypes) == [P, I, SIZE]  # the binding is left as it was


def test_each_symbol_is_bound_once(libc):
    a = cuda_build.function("libc", "memset", (P, I, SIZE))
    b = cuda_build.function("libc", "memcpy", (P, P, SIZE))
    assert a is not b and libc == ["libc", "libc"]
    assert cuda_build.function("libc", "memcpy", (P, P, SIZE)) is b and len(libc) == 2


def test_the_bound_function_calls_through(libc):
    """The binding it keeps really calls the C function."""
    fn = cuda_build.function("libc", "abs", (I,))
    assert fn(-7) == 7 and cuda_build.function("libc", "abs", (I,))(5) == 5
