"""``repro_torch.kernels._build`` on the CPU: a library's path follows its
source and the headers it includes, and a C function's ctypes types are set
once, when it is first asked for (no card, no ``nvcc``: the library is a
fake)."""
import ctypes

import pytest

from repro_torch.kernels import _build


def test_library_path_follows_an_included_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "h.cuh"\n'
                                   "int k() { return H; }\n")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n'
                                    "#define H 1\n")
    (tmp_path / "g.cuh").write_text("#define G 1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    assert before == _build.library_path("k")
    (tmp_path / "g.cuh").write_text("#define G 2\n")   # included twice over
    after_g = _build.library_path("k")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n'
                                    "#define H 2\n")
    after_h = _build.library_path("k")
    assert len({before, after_g, after_h}) == 3
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith("libk-")
               for p in (before, after_g, after_h))


def test_attention_source_hashes_its_hopper_header():
    files = [p.name for p in
             _build._sources(_build.CSRC / "flash_attention.cu", [])]
    assert files == ["flash_attention.cu", "hopper.cuh"]
    for name in _build.SOURCES:
        assert _build.library_path(name).name.startswith(f"lib{name}-")


class _FakeFunction:
    def __init__(self):
        self.sets = 0
        self._argtypes = None
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.sets += 1
        self._argtypes = value

    def __call__(self, *args):
        return 0


class _FakeLibrary:
    opened = 0

    def __init__(self, path):
        type(self).opened += 1
        self.path = path
        self.fwd = _FakeFunction()


@pytest.fixture
def fake_library(tmp_path, monkeypatch):
    lib = tmp_path / "libfake-0.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLibrary)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})
    _FakeLibrary.opened = 0
    return lib


def test_function_sets_ctypes_types_once(fake_library):
    argtypes = [ctypes.c_void_p, ctypes.c_int64]
    fns = [_build.function("fake", "fwd", ctypes.c_int, argtypes)
           for _ in range(5)]
    assert all(fn is fns[0] for fn in fns)
    assert fns[0].sets == 1 and _FakeLibrary.opened == 1
    assert fns[0].argtypes == argtypes and fns[0].restype is ctypes.c_int
    assert _build.load("fake").fwd is fns[0]


def test_attention_wrapper_types_match_its_c_entry_point():
    """flash_attention_fwd(q, k, v, o, BH, S, T, D, bf16, causal,
    sm_scale, stream): pointers and the stream as c_void_p (a c_int would
    cut them), the sizes as 64-bit."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.ARGTYPES == [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
