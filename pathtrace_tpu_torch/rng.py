"""Counter-based RNG lattice, bit-equal to ``pathtrace_tpu.rng``.

Every uniform is a pure function of
``(seed, frame, sample_index, draw_slot, pixel_row, pixel_col)`` through two
rounds of the 'lowbias32' integer mixer, so the port, the JAX package and
the CUDA kernel all draw the same numbers.

The mixer needs uint32 arithmetic: wrapping multiplies and LOGICAL right
shifts. torch has no uint32 arithmetic, and ``>>`` on int32 is an
arithmetic shift (a naive int32 port agrees with the reference on about an
eighth of inputs). So the work is done in int64 on values held in
[0, 2**32): each multiply is masked back to 32 bits (int64 wraps, and the
low 32 bits of a wrapped product are exact), which also makes every shift
logical. Public functions take and return int32 bit patterns, as the
reference does.

Draw-slot layout per (sample, pixel): slots 0-1 sub-pixel jitter, then
``slots_per_bounce`` per bounce (2 cosine uniforms; glossy adds 3).
"""

from __future__ import annotations

import torch

JITTER_SLOTS = 2

# Hash constants as uint32 values.
P_MIX1 = 0x7FEB352D
P_MIX2 = 0x846CA68B
P_GOLD = 0x9E3779B1
P_ROW = 0x85EBCA77
P_FRAME = 0xC2B2AE3D

_M32 = 0xFFFFFFFF


def _u32(x, device=None) -> torch.Tensor:
    """int32 bit patterns (tensor or int) -> int64 values in [0, 2**32)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def _mix(u: torch.Tensor) -> torch.Tensor:
    """'lowbias32' on uint32 values held in int64."""
    u = u ^ (u >> 16)
    u = (u * P_MIX1) & _M32
    u = u ^ (u >> 15)
    u = (u * P_MIX2) & _M32
    return u ^ (u >> 16)


def mix32(x) -> torch.Tensor:
    """'lowbias32' avalanche mixer over int32 bit patterns."""
    return _to_i32(_mix(_u32(x)))


def _base(seed, frame, device=None) -> torch.Tensor:
    return _mix(_u32(seed, device) ^ _mix((_u32(frame, device) * P_FRAME) & _M32))


def base_key(seed, frame, device=None) -> torch.Tensor:
    """Scalar int32 stream key for one frame of one render stream."""
    return _to_i32(_base(seed, frame, device))


def _pixels(height: int, width: int, row_offset=0, col_offset=0, device=None):
    rows = torch.arange(height, dtype=torch.int64, device=device)[:, None] + int(row_offset)
    cols = torch.arange(width, dtype=torch.int64, device=device)[None, :] + int(col_offset)
    return _mix((((rows & _M32) * P_GOLD) & _M32) ^ (((cols & _M32) * P_ROW) & _M32))


def pixel_keys(height: int, width: int, row_offset=0, col_offset=0, device=None):
    """[H, W] int32 per-pixel keys from ABSOLUTE image coordinates."""
    return _to_i32(_pixels(height, width, row_offset, col_offset, device))


def _draw(bkey_u, sample_index, slot, n_slots: int) -> torch.Tensor:
    s = _u32(sample_index, bkey_u.device)
    lattice = ((s * n_slots + _u32(slot, bkey_u.device)) & _M32) * P_GOLD
    return _mix(bkey_u ^ (lattice & _M32))


def draw_key(bkey, sample_index, slot, n_slots: int) -> torch.Tensor:
    """int32 key for one (sample, draw-slot)."""
    return _to_i32(_draw(_u32(bkey), sample_index, slot, n_slots))


def _uniform(pix_u, dkey_u) -> torch.Tensor:
    bits = _mix(pix_u ^ dkey_u)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform_from_keys(pix_key, dkey) -> torch.Tensor:
    """f32 uniforms in [0, 1) from pixel keys x a draw key."""
    return _uniform(_u32(pix_key), _u32(dkey))


def sample_uniforms(
    seed,
    frame,
    spp: int,
    height: int,
    width: int,
    max_bounces: int,
    sample_offset: int = 0,
    row_offset=0,
    col_offset=0,
    slots_per_bounce: int = 2,
    device=None,
) -> torch.Tensor:
    """The uniform lattice for a chunk of samples:
    [spp, H, W, 2 + slots_per_bounce*max_bounces] float32."""
    n_slots = JITTER_SLOTS + slots_per_bounce * max_bounces
    bkey = _base(seed, frame, device)
    pkeys = _pixels(height, width, row_offset, col_offset, device)  # [H, W]
    samples = torch.arange(spp, dtype=torch.int64, device=device) + int(sample_offset)
    slots = torch.arange(n_slots, dtype=torch.int64, device=device)
    dkeys = _draw(bkey, samples[:, None], slots[None, :], n_slots)  # [spp, n_slots]
    return _uniform(pkeys[None, :, :, None], dkeys[:, None, None, :])
