"""Build the CUDA sources of ``csrc/`` into shared libraries with nvcc.

Each ``.cu`` file becomes ``build/lib<stem>-<digest>.so``, where the digest
hashes the source, every header it includes from ``csrc/`` (recursively)
and the flags: an edit to ``common.cuh`` rebuilds every kernel that
includes it, one to ``sweep.cuh`` the two that share the reverse sweep, and
a library that already exists is reused. ``build_all`` starts one nvcc for
each source at once. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# No --use_fast_math: IEEE sqrt and division, full-range sinf/cosf.
# -fmad=false: with nvcc's default FMA contraction 1.1% of pixels of a 4-spp
# NEE frame flipped a hit decision against the plain version on an H100;
# without it the kernel matched the plain version bit for bit in every mode.
# The gradient kernels retrace the forward kernel's paths, so they take the
# same flags.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        nvcc = candidate if os.path.exists(candidate) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def source_files(source: Path) -> list[Path]:
    """``source`` and the local headers it includes, recursively, in a fixed
    order."""
    seen: list[Path] = []
    todo = [Path(source)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / name.decode()
            if not header.exists():
                raise FileNotFoundError(f"{path.name} includes missing {header}")
            todo.append(header)
    return seen


def library_path(source: Path) -> Path:
    """Where the library of ``source`` lives."""
    h = hashlib.sha256()
    for path in source_files(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_library(source: Path) -> Path:
    """Compile ``source`` into its shared library, or reuse the one that
    exists for the same sources and flags."""
    lib = library_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {Path(source).name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_function(source: Path, symbol: str, argtypes: list):
    """Build ``source`` if needed and bind its C function ``symbol``, which
    returns an int -> (library, function). Keep the library while the
    function is in use."""
    lib = ctypes.CDLL(str(build_library(source)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def build_all(sources: Iterable[Path]) -> Dict[Path, Path]:
    """Build every source at once, one nvcc each -> {source: library}."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        libs = list(pool.map(build_library, sources))
    return dict(zip(sources, libs))
