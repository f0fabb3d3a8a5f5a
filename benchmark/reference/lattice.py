"""The counter-based random lattice, frozen.

A frozen copy of ``pathtrace_tpu_torch/rng.py`` (itself bit-equal to
``pathtrace_tpu/rng.py``): every uniform is a pure function of (seed,
frame, sample index, draw slot, pixel row, pixel col) through two rounds of
the 'lowbias32' mixer. uint32 arithmetic is done in int64 on values held in
[0, 2**32), each product masked back to 32 bits, so every shift is logical.

Draw slots per (sample, pixel): 0-1 the sub-pixel jitter, then 2 a bounce
(diffuse; glossy would add 3).
"""

from __future__ import annotations

import torch

JITTER_SLOTS = 2
SLOTS_PER_BOUNCE = 2

P_MIX1 = 0x7FEB352D
P_MIX2 = 0x846CA68B
P_GOLD = 0x9E3779B1
P_ROW = 0x85EBCA77
P_FRAME = 0xC2B2AE3D
M32 = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64) & M32


def mix(u: torch.Tensor) -> torch.Tensor:
    u = u ^ (u >> 16)
    u = (u * P_MIX1) & M32
    u = u ^ (u >> 15)
    u = (u * P_MIX2) & M32
    return u ^ (u >> 16)


def base_key(seed: int, frame: int, device=None) -> torch.Tensor:
    """The key of one frame of one render stream (``seed`` as the kernels
    take it: its low 31 bits)."""
    return mix(u32(seed & 0x7FFFFFFF, device) ^ mix((u32(frame, device) * P_FRAME) & M32))


def pixel_keys(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Keys of the absolute pixel coordinates ``rows`` x ``cols`` (int64,
    broadcast together)."""
    return mix((((rows & M32) * P_GOLD) & M32) ^ (((cols & M32) * P_ROW) & M32))


def uniforms(bkey: torch.Tensor, pix: torch.Tensor, samples: torch.Tensor, slot: int,
             n_slots: int) -> torch.Tensor:
    """f32 uniforms in [0, 1) of draw ``slot`` for the absolute sample
    indices ``samples`` (int64 [S, 1, 1]) at the pixel keys ``pix``
    ([h, W]) -> [S, h, W]."""
    lattice = (((samples & M32) * n_slots + slot) & M32) * P_GOLD
    dkey = mix(bkey ^ (lattice & M32))
    bits = mix(pix ^ dkey)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def n_slots(max_bounces: int) -> int:
    return JITTER_SLOTS + SLOTS_PER_BOUNCE * max_bounces
