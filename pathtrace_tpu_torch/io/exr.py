"""OpenEXR scanline IO, implemented from the format spec.

Replaces the reference's vendored ``tinyexr.h`` (12,580 LoC) for the
framework's needs: single-part scanline files of FLOAT channels with NONE,
ZIPS or ZIP compression. The byte layout follows the OpenEXR 2.0 spec
(magic 20000630, attribute list, chunk offset table, per-chunk
``y | size | data``); ZIP chunks use the standard two-plane byte reorder +
delta predictor around zlib.

AOV serialization parity with the reference (``include/OutputBuffer.h:
143-188``): the same 8 layers and channel names — Albedo.{B,G,R},
AlbedoVar.Z, Color.{B,G,R}, ColorVar.Z, Depth.Z, DepthVar.Z, Normal.{X,Y,Z},
NormalVar.Z. One deliberate deviation: the reference stores the Normal
channels in Z,Y,X header order while claiming alphabetical order (a benign
spec violation, ``OutputBuffer.h:176-178``); we write truly alphabetical
(spec-compliant) ordering. Readers that sort channel names — including the
reference's own ``load_data.get_layer`` (``denoise_cnn/load_data.py:
42-68``) — see identical data either way.

When it builds, the native C++ library (``io/native.py``, the port's copy
of ``ptio.cpp``) reads and writes instead, under ``backend="auto"``; this
pure-Python module is the always-works fallback and the format oracle for
tests.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Mapping

import numpy as np

MAGIC = 20000630
PIXEL_TYPE_FLOAT = 2

COMPRESSION_NONE = 0
COMPRESSION_ZIPS = 1  # zlib, 1 scanline per chunk
COMPRESSION_ZIP = 3  # zlib, 16 scanlines per chunk
_COMPRESSION_NAMES = {"none": COMPRESSION_NONE, "zips": COMPRESSION_ZIPS, "zip": COMPRESSION_ZIP}
_LINES_PER_CHUNK = {COMPRESSION_NONE: 1, COMPRESSION_ZIPS: 1, COMPRESSION_ZIP: 16}


# -- zip predictor/reorder (OpenEXR ImfZip) ---------------------------------

def _zip_encode(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    reordered = np.empty(n, np.uint8)
    reordered[:half] = arr[0::2]
    reordered[half:] = arr[1::2]
    # delta predictor: d[i] = t[i] - t[i-1] + 384 (mod 256), d[0] = t[0]
    out = reordered.astype(np.int16)
    out[1:] = (out[1:] - reordered[:-1].astype(np.int16)) + (128 + 256)
    return zlib.compress(out.astype(np.uint8).tobytes())


def _zip_decode(data: bytes, expected_size: int) -> bytes:
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    if raw.size != expected_size:
        raise ValueError(f"zip chunk decoded to {raw.size}, expected {expected_size}")
    # un-predict: cumulative sum with the +(-128-256) bias removed mod 256
    delta = raw.astype(np.int64)
    delta[1:] -= 128 + 256
    undone = np.cumsum(delta).astype(np.uint8)
    # un-reorder
    half = (raw.size + 1) // 2
    out = np.empty(raw.size, np.uint8)
    out[0::2] = undone[:half]
    out[1::2] = undone[half:]
    return out.tobytes()


# -- attribute encoding ------------------------------------------------------

def _attr(name: str, type_name: str, value: bytes) -> bytes:
    return (
        name.encode() + b"\0" + type_name.encode() + b"\0"
        + struct.pack("<i", len(value)) + value
    )


def _chlist(names) -> bytes:
    out = b""
    for n in names:
        out += n.encode() + b"\0"
        out += struct.pack("<i", PIXEL_TYPE_FLOAT)  # pixel type
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)  # x/y sampling
    return out + b"\0"


def write_exr(
    path,
    channels: Mapping[str, np.ndarray],
    compression: str = "zip",
    backend: str = "auto",
):
    """Write a single-part scanline EXR of FLOAT channels.

    channels: name -> [H, W] float array (all same shape). Channels are
    stored in alphabetical order as the spec requires.

    backend: "auto" uses the native C++ library when it builds (files the
    Python reader reads to the same arrays); "python"/"native" force one,
    and "native" raises where the library is unavailable.
    """
    if backend in ("auto", "native"):
        from pathtrace_tpu_torch.io import native

        if native.available():
            native.write_exr_native(path, channels, compression=compression)
            return
        if backend == "native":
            raise RuntimeError("native IO library unavailable")
    names = sorted(channels.keys())
    planes = [np.ascontiguousarray(np.asarray(channels[n], np.float32)) for n in names]
    h, w = planes[0].shape
    for n, p in zip(names, planes):
        if p.shape != (h, w):
            raise ValueError(f"channel {n} shape {p.shape} != {(h, w)}")

    comp = _COMPRESSION_NAMES[compression]
    lines_per_chunk = _LINES_PER_CHUNK[comp]

    header = b""
    header += _attr("channels", "chlist", _chlist(names))
    header += _attr("compression", "compression", struct.pack("<B", comp))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    # Build chunks: per chunk, scanline-major then channel-major data.
    chunks = []
    for y0 in range(0, h, lines_per_chunk):
        ny = min(lines_per_chunk, h - y0)
        rows = []
        for y in range(y0, y0 + ny):
            for p in planes:
                rows.append(p[y].tobytes())
        raw = b"".join(rows)
        if comp == COMPRESSION_NONE:
            data = raw
        else:
            data = _zip_encode(raw)
            if len(data) >= len(raw):  # spec: store raw if zip doesn't help
                data = raw
        chunks.append((y0, data))

    preamble = struct.pack("<ii", MAGIC, 2)
    offset_table_pos = len(preamble) + len(header)
    first_chunk_pos = offset_table_pos + 8 * len(chunks)

    offsets = []
    pos = first_chunk_pos
    for _, data in chunks:
        offsets.append(pos)
        pos += 8 + len(data)

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(header)
        f.write(struct.pack(f"<{len(chunks)}Q", *offsets))
        for (y0, data) in chunks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


# -- reading ----------------------------------------------------------------

def _read_null_str(buf: bytes, pos: int):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode(), end + 1


def read_exr(path, backend: str = "auto") -> Dict[str, np.ndarray]:
    """Read a single-part scanline EXR into name -> [H, W] f32 arrays.

    Supports FLOAT/HALF/UINT channels and NONE/ZIPS/ZIP compression —
    enough to read anything this framework (or the reference pipeline)
    writes. backend as in ``write_exr``.
    """
    if backend in ("auto", "native"):
        from pathtrace_tpu_torch.io import native

        if native.available():
            return native.read_exr_native(path)
        if backend == "native":
            raise RuntimeError("native IO library unavailable")
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    pos = 8

    channels = []  # (name, pixel_type)
    comp = COMPRESSION_NONE
    data_window = None
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_null_str(buf, pos)
        type_name, pos = _read_null_str(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        value = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while value[cpos] != 0:
                cname, cpos = _read_null_str(value, cpos)
                (ptype,) = struct.unpack_from("<i", value, cpos)
                cpos += 16  # type + pLinear/reserved + samplings
                channels.append((cname, ptype))
        elif name == "compression":
            comp = value[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", value)

    if data_window is None:
        raise ValueError("missing dataWindow")
    xmin, ymin, xmax, ymax = data_window
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    if comp not in _LINES_PER_CHUNK:
        raise ValueError(f"unsupported compression {comp}")
    lines_per_chunk = _LINES_PER_CHUNK[comp]
    n_chunks = -(-h // lines_per_chunk)

    dtypes = {0: (np.uint32, 4), 1: (np.float16, 2), 2: (np.float32, 4)}
    bytes_per_px = sum(dtypes[pt][1] for _, pt in channels)

    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)
    out = {name: np.empty((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        ny = min(lines_per_chunk, ymin + h - y)
        expected = bytes_per_px * w * ny
        if comp != COMPRESSION_NONE and size != expected:
            data = _zip_decode(data, expected)
        dpos = 0
        for row in range(y - ymin, y - ymin + ny):
            for cname, ptype in channels:
                dt, nbytes = dtypes[ptype]
                vals = np.frombuffer(data, dt, count=w, offset=dpos)
                out[cname][row] = vals.astype(np.float32)
                dpos += nbytes * w
    return out


# -- AOV layer mapping (reference parity) -----------------------------------

# name in EXR -> (aov key, component index or None)
_LAYER_MAP = {
    "Color.R": ("color", 0), "Color.G": ("color", 1), "Color.B": ("color", 2),
    "Normal.X": ("normal", 0), "Normal.Y": ("normal", 1), "Normal.Z": ("normal", 2),
    "Albedo.R": ("albedo", 0), "Albedo.G": ("albedo", 1), "Albedo.B": ("albedo", 2),
    "Depth.Z": ("depth", None),
    "ColorVar.Z": ("color_var", None),
    "NormalVar.Z": ("normal_var", None),
    "AlbedoVar.Z": ("albedo_var", None),
    "DepthVar.Z": ("depth_var", None),
}


def save_aovs_exr(path, aovs, compression: str = "zip"):
    """Save a rendered AOV dict with the reference's layer naming."""
    aovs = {k: np.asarray(v) for k, v in aovs.items()}
    channels = {}
    for name, (key, comp_idx) in _LAYER_MAP.items():
        arr = aovs[key]
        channels[name] = arr[..., comp_idx] if comp_idx is not None else arr
    write_exr(path, channels, compression=compression)


def load_aovs_exr(path) -> Dict[str, np.ndarray]:
    """Load an AOV EXR (ours or the reference renderer's) back to a dict."""
    raw = read_exr(path)
    h, w = next(iter(raw.values())).shape
    aovs = {
        "color": np.empty((h, w, 3), np.float32),
        "normal": np.empty((h, w, 3), np.float32),
        "albedo": np.empty((h, w, 3), np.float32),
    }
    for name, (key, comp_idx) in _LAYER_MAP.items():
        if name not in raw:
            raise ValueError(f"{path}: missing channel {name}")
        if comp_idx is None:
            aovs[key] = raw[name]
        else:
            aovs[key][..., comp_idx] = raw[name]
    return aovs
