"""8-bit RGB PNG writer, standard library only (``zlib``).

The port's scripts write their pictures as PNG, as the JAX package's do
through matplotlib's ``imsave``; the values are mapped as the BMP writer
maps them (clamp(255 v)), and every row is stored unfiltered.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from pathtrace_tpu_torch.io.bmp import _to_rgb8

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """[H, W, 3] or [H, W] uint8/float data -> the bytes of an 8-bit RGB PNG."""
    img = _to_rgb8(image)
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0: none
    rows[:, 1:] = img.reshape(h, 3 * w)
    return b"".join((
        SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes())),
        _chunk(b"IEND", b""),
    ))


def write_png(path, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))
