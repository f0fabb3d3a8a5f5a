"""24-bit BMP writer (replaces the reference's stb_image_write usage).

``save_aovs_bitmaps`` mirrors ``OutputBuffer::SaveBitmaps``
(``include/OutputBuffer.h:85-94``): 8 files per render — color/normal/albedo
as 3-channel, depth + the 4 variance channels as 1-channel — each value
mapped by clamp(255 * v, 0, 255) exactly as ``saveFeatureToBitmap``
(``OutputBuffer.h:13-22``).
"""

from __future__ import annotations

import struct

import numpy as np


def write_bmp(path, image: np.ndarray):
    """Write [H, W, 3] or [H, W] uint8/float data as a 24-bit BMP.

    Float inputs are mapped with clamp(255*v); single-channel input is
    replicated to grey RGB. Rows are stored bottom-up, BGR, 4-byte aligned
    (the standard layout stb produces).
    """
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.dtype != np.uint8:
        img = np.clip(255.0 * img.astype(np.float64), 0, 255).astype(np.uint8)
    h, w, _ = img.shape

    row_size = (w * 3 + 3) & ~3
    data_size = row_size * h
    header_size = 14 + 40

    rows = np.zeros((h, row_size), np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up BGR

    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", header_size + data_size, 0, 0, header_size))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size, 2835, 2835, 0, 0))
        f.write(rows.tobytes())


def read_bmp(path) -> np.ndarray:
    """Read a 24-bit uncompressed BMP back to [H, W, 3] uint8 (for tests)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"BM":
        raise ValueError("not a BMP")
    (data_offset,) = struct.unpack_from("<I", buf, 10)
    dib_size, w, h, planes, bpp = struct.unpack_from("<IiiHH", buf, 14)
    if bpp != 24:
        raise ValueError(f"unsupported bpp {bpp}")
    flip = h > 0
    h = abs(h)
    row_size = (w * 3 + 3) & ~3
    rows = np.frombuffer(buf, np.uint8, count=row_size * h, offset=data_offset)
    img = rows.reshape(h, row_size)[:, : w * 3].reshape(h, w, 3)[..., ::-1]
    return img[::-1] if flip else img


def save_aovs_bitmaps(base_path, aovs):
    """The reference's 8-file bitmap dump (OutputBuffer.h:85-94)."""
    aovs = {k: np.asarray(v) for k, v in aovs.items()}
    write_bmp(f"{base_path}_color.bmp", aovs["color"])
    write_bmp(f"{base_path}_normal.bmp", aovs["normal"])
    write_bmp(f"{base_path}_albedo.bmp", aovs["albedo"])
    write_bmp(f"{base_path}_depth.bmp", aovs["depth"])
    write_bmp(f"{base_path}_color_var.bmp", aovs["color_var"])
    write_bmp(f"{base_path}_normal_var.bmp", aovs["normal_var"])
    write_bmp(f"{base_path}_albedo_var.bmp", aovs["albedo_var"])
    write_bmp(f"{base_path}_depth_var.bmp", aovs["depth_var"])
