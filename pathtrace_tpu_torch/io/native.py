"""ctypes bindings to the native IO library (``native/ptio.cpp``).

The counterpart of ``pathtrace_tpu.io.native``, over the port's own copy of
the C++ source. The library is built on first use with ``native/Makefile``
(g++ and zlib) into ``build/libptio-<digest>.so``, where the digest hashes
the source and the Makefile, so an edit rebuilds it and a concurrent build
never leaves half a file behind. Where it cannot be built or loaded every
entry point says so (``False`` or ``None``), and ``io/exr.py`` /
``io/bmp.py`` use their pure-Python writers under ``backend="auto"``: the
framework never hard-depends on a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG / "build"


def library_path() -> Path:
    """Where the library of the current source and Makefile lives."""
    h = hashlib.sha256()
    for name in ("ptio.cpp", "Makefile"):
        h.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes() + b"\0")
    return BUILD_DIR / f"libptio-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["make", "-s", "-B", f"OUT={tmp}"], cwd=NATIVE_DIR,
                              capture_output=True, timeout=120)
        if proc.returncode != 0:
            return False
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def load_library() -> Optional[ctypes.CDLL]:
    """The native library, building it on demand; None if unavailable."""
    lib_path = library_path()
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    lib.ptio_write_exr.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int,
    ]
    lib.ptio_write_exr.restype = ctypes.c_int
    lib.ptio_read_exr_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.ptio_read_exr_header.restype = ctypes.c_int
    lib.ptio_read_exr.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    lib.ptio_read_exr.restype = ctypes.c_int
    lib.ptio_write_bmp.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
    ]
    lib.ptio_write_bmp.restype = ctypes.c_int
    return lib


def available() -> bool:
    return load_library() is not None


_COMP_CODES = {"none": 0, "zips": 1, "zip": 3}


def write_exr_native(path, channels: Dict[str, np.ndarray], compression="zip") -> bool:
    """Native EXR write; returns False if the library is unavailable."""
    lib = load_library()
    if lib is None:
        return False
    names = sorted(channels.keys())
    planes = [
        np.ascontiguousarray(np.asarray(channels[n], np.float32)) for n in names
    ]
    h, w = planes[0].shape
    for n, p in zip(names, planes):
        if p.shape != (h, w):
            raise ValueError(f"channel {n} shape {p.shape} != {(h, w)}")
    c_names = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
    c_planes = (ctypes.c_void_p * len(names))(
        *[p.ctypes.data_as(ctypes.c_void_p) for p in planes]
    )
    rc = lib.ptio_write_exr(
        str(path).encode(), w, h, len(names), c_names, c_planes,
        _COMP_CODES[compression],
    )
    if rc != 0:
        raise IOError(f"ptio_write_exr({path}) failed with code {rc}")
    return True


def read_exr_native(path) -> Optional[Dict[str, np.ndarray]]:
    """Native EXR read; returns None if the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    nc = ctypes.c_int()
    names_buf = ctypes.create_string_buffer(16384)
    rc = lib.ptio_read_exr_header(
        str(path).encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
        names_buf, len(names_buf),
    )
    if rc != 0:
        raise IOError(f"ptio_read_exr_header({path}) failed with code {rc}")
    names = names_buf.value.decode().split("\n")
    out = np.empty((nc.value, h.value, w.value), np.float32)
    rc = lib.ptio_read_exr(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    if rc != 0:
        raise IOError(f"ptio_read_exr({path}) failed with code {rc}")
    return {name: out[i] for i, name in enumerate(names)}


def write_bmp_native(path, rgb: np.ndarray) -> bool:
    """Native BMP write of [H, W, 3] uint8; False if unavailable."""
    lib = load_library()
    if lib is None:
        return False
    img = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError("write_bmp_native expects [H, W, 3] uint8")
    rc = lib.ptio_write_bmp(
        str(path).encode(), w, h, img.ctypes.data_as(ctypes.c_char_p)
    )
    if rc != 0:
        raise IOError(f"ptio_write_bmp({path}) failed with code {rc}")
    return True
