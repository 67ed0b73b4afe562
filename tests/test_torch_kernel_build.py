"""The kernel builder's cache key, on the CPU (no nvcc needed).

`repro_torch.kernels.build` reuses a library whose name carries a hash of
the compiler flags, the source and the ``csrc`` headers the source
includes.  An edit to an included header must give a new name (a new
build); an edit to a header the source does not include must not.  The
compiler's ``-Xptxas -v`` report beside a library is read back per kernel.
"""
import pytest

pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint f() { return A; }\n')
    (src / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#define A B\n')
    (src / "b.cuh").write_text("#pragma once\n#define B 1\n")
    (src / "unused.cuh").write_text("#define C 2\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return src


def test_headers_are_followed_through_includes(csrc):
    assert kernels._headers(csrc / "k.cu") == [csrc / "a.cuh", csrc / "b.cuh"]


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", True),
    ("a.cuh", True),       # included by the source
    ("b.cuh", True),       # included through a.cuh
    ("unused.cuh", False),  # included by nothing
])
def test_library_name_follows_the_source_and_its_headers(csrc, edited, rebuilds):
    before = kernels.library_path("k.cu")
    assert before.parent == kernels.BUILD_DIR and before.name.startswith("k-")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert (kernels.library_path("k.cu") != before) == rebuilds


def test_library_name_follows_the_flags(csrc, monkeypatch):
    before = kernels.library_path("k.cu")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.library_path("k.cu") != before


def test_ptxas_report_is_read_per_kernel(tmp_path):
    lib = tmp_path / "k-0123.so"
    kernels.report(lib).write_text(
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 64 bytes smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3barv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, 352 bytes cmem[0]\n"
    )
    assert kernels.ptxas_report(lib) == [
        {"name": "_Z3fooPf", "spill_stores": 8, "spill_loads": 4, "registers": 168,
         "static_smem": 64},
        {"name": "_Z3barv", "spill_stores": 0, "spill_loads": 0, "registers": 32,
         "static_smem": 0},
    ]
