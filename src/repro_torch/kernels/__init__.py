"""Hand-written CUDA kernels for Hopper, and the helper that builds them.

The counterpart of `repro.kernels` (the Pallas TPU kernels), chosen by
device rather than by backend: every op wrapper in this package takes its
plain PyTorch version for a tensor on the CPU and launches its CUDA kernel
for a tensor on a GPU, and raises for anything else.  There is no quiet
fallback from a CUDA tensor to the plain version.

Kernels are CUDA C++ sources under ``csrc/`` with a plain C interface.
`load_library` compiles one with ``nvcc`` for ``sm_90a`` at its first use
in a process, into ``build/kernels/`` at the repository root (a directory
git ignores), and loads it with `ctypes`.  Importing this package compiles
nothing and touches no GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    """Path of the CUDA compiler: on ``PATH``, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: a CUDA toolkit is needed to build kernels")


def build(source: str) -> pathlib.Path:
    """Compile ``csrc/<source>`` into a shared library; return its path.

    The library's name carries a hash of the source and flags, so an edited
    source is rebuilt and an unchanged one is reused.  The compiler writes
    to a temporary name that is renamed into place, so concurrent builds
    never load a half-written file.
    """
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    return ctypes.CDLL(str(build(source)))
