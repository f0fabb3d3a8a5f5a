"""The port's native (C++) IO against its pure-Python format oracle, and
EXR files across the two packages.

The cases of tests/test_native_io.py on the port's own copy of the library
(built into ``pathtrace_tpu_torch/build/``), for all three compressions,
then files written by either package (either backend) read back by the
other: the same channel names and the same f32 values, exactly. Where the
library cannot be built (no g++ or zlib) the native cases skip, decided
inside a fixture; the fallback cases run either way.

The JAX package builds its own library in place, once per process, and a
process that loads a half-written file keeps "unavailable" for its life; so
the cross-package cases load a private copy of it, built in a fixture.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from pathtrace_tpu.io import exr as jax_exr
from pathtrace_tpu.io import native as jax_native

from pathtrace_tpu_torch.io import native
from pathtrace_tpu_torch.io.bmp import encode_bmp, read_bmp, write_bmp
from pathtrace_tpu_torch.io.exr import read_exr, write_exr

COMPRESSIONS = ["none", "zips", "zip"]


@pytest.fixture
def lib():
    if native.load_library() is None:
        pytest.skip("the native IO library cannot be built here (g++ and zlib)")
    return native


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native library, built from its own ``ptio.cpp`` and
    ``Makefile`` into a private directory and loaded from there for this
    module's tests; the package's loader state is restored afterwards."""
    src = tmp_path_factory.mktemp("jax_native")
    for name in ("ptio.cpp", "Makefile"):
        shutil.copy(Path(jax_native._NATIVE_DIR) / name, src / name)
    try:
        subprocess.run(["make", "-s"], cwd=src, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("the JAX package's native IO library cannot be built here (g++ and zlib)")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", str(src / "libptio.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_lib_tried", False)
        if jax_native.load_library() is None:
            pytest.skip("the JAX package's native IO library does not load here")
        yield jax_native


def chans(seed=0, h=33, w=47):
    rng = np.random.default_rng(seed)
    return {
        "B.chan": rng.normal(size=(h, w)).astype(np.float32),
        "A.chan": rng.uniform(size=(h, w)).astype(np.float32),
        "C.flat": np.full((h, w), 0.25, np.float32),  # compressible
    }


def test_library_is_the_ports_own(lib):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.parent.parent.name == "pathtrace_tpu_torch"
    assert (native.NATIVE_DIR / "ptio.cpp").is_file() and (native.NATIVE_DIR / "Makefile").is_file()


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_native_write_python_read(tmp_path, lib, compression):
    c = chans()
    path = tmp_path / "n.exr"
    assert lib.write_exr_native(path, c, compression=compression)
    back = read_exr(path, backend="python")
    assert set(back) == set(c)
    for k in c:
        np.testing.assert_array_equal(back[k], c[k])


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_python_write_native_read(tmp_path, lib, compression):
    c = chans(seed=1)
    path = tmp_path / "p.exr"
    write_exr(path, c, compression=compression, backend="python")
    back = lib.read_exr_native(path)
    assert set(back) == set(c)
    for k in c:
        np.testing.assert_array_equal(back[k], c[k])


def test_native_roundtrip_tall_image(tmp_path, lib):
    # > 16 scanlines exercises multi-chunk ZIP.
    c = {"X": np.random.default_rng(2).normal(size=(100, 64)).astype(np.float32)}
    path = tmp_path / "tall.exr"
    assert lib.write_exr_native(path, c, compression="zip")
    np.testing.assert_array_equal(lib.read_exr_native(path)["X"], c["X"])
    np.testing.assert_array_equal(read_exr(path, backend="native")["X"], c["X"])


@pytest.mark.parametrize("image", ["uint8", "float", "grey"])
def test_native_bmp_matches_python(tmp_path, lib, image):
    rng = np.random.default_rng(3)
    img = {"uint8": rng.integers(0, 256, size=(21, 37, 3), dtype=np.uint8),
           "float": rng.uniform(-0.2, 1.2, size=(21, 37, 3)).astype(np.float32),
           "grey": rng.uniform(size=(21, 37)).astype(np.float32)}[image]
    native_path, py_path = tmp_path / "n.bmp", tmp_path / "p.bmp"
    write_bmp(native_path, img, backend="native")
    write_bmp(py_path, img, backend="python")
    assert native_path.read_bytes() == py_path.read_bytes() == encode_bmp(img)
    assert read_bmp(native_path).shape == (21, 37, 3)
    if image == "uint8":
        np.testing.assert_array_equal(read_bmp(native_path), img)


def test_native_error_on_missing_file(lib):
    with pytest.raises(IOError):
        lib.read_exr_native("/nonexistent/x.exr")


@pytest.mark.parametrize("writer", ["port-native", "port-python", "jax-native", "jax-python"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_exr_across_packages(tmp_path, lib, jax_lib, writer, compression):
    """A file written by either package, with either backend, reads back to
    the same arrays through both packages' readers and both backends."""
    c = chans(seed=4, h=20, w=18)
    path = tmp_path / "x.exr"
    package, backend = writer.split("-")
    write = write_exr if package == "port" else jax_exr.write_exr
    write(path, c, compression=compression, backend=backend)
    for read in (read_exr, jax_exr.read_exr):
        for read_backend in ("python", "native"):
            back = read(path, backend=read_backend)
            assert set(back) == set(c)
            for k in c:
                np.testing.assert_array_equal(back[k], c[k])


def test_unavailable_library_falls_back_or_raises(tmp_path, monkeypatch):
    """Under "auto" a library that cannot be built means the Python codec;
    "native" raises (the JAX package's contract)."""
    monkeypatch.setattr(native, "load_library", lambda: None)
    assert not native.available()
    assert native.write_exr_native(tmp_path / "a.exr", chans()) is False
    assert native.read_exr_native(tmp_path / "a.exr") is None
    c = chans(seed=5)
    write_exr(tmp_path / "a.exr", c)  # auto: the Python writer
    for k, v in read_exr(tmp_path / "a.exr").items():
        np.testing.assert_array_equal(v, c[k])
    write_bmp(tmp_path / "a.bmp", np.zeros((4, 5, 3), np.uint8))
    assert (tmp_path / "a.bmp").read_bytes() == encode_bmp(np.zeros((4, 5, 3), np.uint8))
    for call in (lambda: write_exr(tmp_path / "b.exr", c, backend="native"),
                 lambda: read_exr(tmp_path / "a.exr", backend="native"),
                 lambda: write_bmp(tmp_path / "b.bmp", np.zeros((4, 5, 3)), backend="native")):
        with pytest.raises(RuntimeError, match="native IO library unavailable"):
            call()


def test_failed_build_means_no_library(tmp_path, monkeypatch):
    """A toolchain that fails leaves no library file and reports None."""
    lib_path = tmp_path / "build" / "libptio-x.so"
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)  # no Makefile here: make fails
    assert native._build(lib_path) is False
    assert not lib_path.exists() and list(lib_path.parent.iterdir()) == []
