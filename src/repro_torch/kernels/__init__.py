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

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel: see `ptxas_report`
)
# What this process compiled and loaded at run time: ``"builds"`` / ``"loads"``
# counts and ``"build_seconds"`` (read by `repro_torch.obs.RetraceCounter`).
BUILD_EVENTS: collections.Counter = collections.Counter()
_EVENTS_LOCK = threading.Lock()  # chip_smoke builds the sources from several threads


def _nvcc() -> str:
    """Path of the CUDA compiler: on ``PATH``, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: a CUDA toolkit is needed to build kernels")


def _headers(src: pathlib.Path) -> list[pathlib.Path]:
    """The ``csrc`` headers ``src`` includes with quotes, directly or through another."""
    found, todo = [], [src]
    while todo:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', todo.pop().read_text(), re.M):
            header = CSRC / name
            if header not in found:
                found.append(header)
                todo.append(header)
    return sorted(found)


def library_path(source: str) -> pathlib.Path:
    """Where `build` puts ``csrc/<source>``'s library.

    The name carries a hash of the flags, the source and every header it
    includes from ``csrc``, so an edit to any of them means a new build.
    """
    src = CSRC / source
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *_headers(src)]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> pathlib.Path:
    """Compile ``csrc/<source>`` into a shared library; return its path.

    An unchanged source (with its headers and flags) is reused, see
    `library_path`.  The compiler writes to a temporary name that is
    renamed into place, so concurrent builds never load a half-written file.
    """
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with _EVENTS_LOCK:
        BUILD_EVENTS["builds"] += 1
        BUILD_EVENTS["build_seconds"] += time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stderr}"
        )
    report(out).write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def report(library: pathlib.Path) -> pathlib.Path:
    """The compiler's report (``-Xptxas -v``) kept beside a built ``library``."""
    return library.with_name(library.stem + ".ptxas.txt")


def ptxas_report(library: pathlib.Path) -> list[dict]:
    """Registers, shared memory and spills of each kernel in ``library``'s report."""
    kernels = []
    for line in report(library).read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            kernels.append({"name": m.group(1)})
        elif kernels and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                          line)):
            kernels[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[-1]["static_smem"] = int(smem.group(1)) if smem else 0
    return kernels


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    lib = ctypes.CDLL(str(build(source)))
    with _EVENTS_LOCK:
        BUILD_EVENTS["loads"] += 1
    return lib
