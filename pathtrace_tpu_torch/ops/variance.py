"""Per-pixel feature variances as associative moment algebra.

The counterpart of ``pathtrace_tpu.ops.variance``: masked moments of a
batch of samples, merged across spp chunks with Chan's parallel formula.
Variance is M2 / (n - 1), and 0 where n < 2 (``pathtrace.cu:60-64``).
Features are Rec.709 luminances, except depth which uses the raw ray t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma of [..., 3] (reference ``luminance``, pathtrace.cu:67)."""
    luma = torch.tensor(LUMA, dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * luma, dim=-1)


class Moments(NamedTuple):
    """Partial Welford moments; a commutative monoid under ``merge_moments``.

    n: included-sample count; mean: mean of included samples (0 where
    n == 0); m2: sum of squared deviations from the mean.
    """

    n: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def moments_from_samples(x: torch.Tensor, include: torch.Tensor, dim: int = 0) -> Moments:
    """Masked moments of samples ``x`` along ``dim``; ``include`` is the
    per-sample mask (escaped paths skip the color update, only bounce-0
    hits count for normal/albedo/depth)."""
    inc = include.to(x.dtype)
    n = torch.sum(inc, dim=dim)
    safe_n = torch.clamp(n, min=1.0)
    mean = torch.sum(x * inc, dim=dim) / safe_n
    centered = (x - mean.unsqueeze(dim)) * inc
    m2 = torch.sum(centered * centered, dim=dim)
    return Moments(n=n, mean=mean, m2=m2)


def merge_moments(a: Moments, b: Moments) -> Moments:
    """Chan et al. parallel-variance merge (associative and commutative)."""
    n = a.n + b.n
    safe_n = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.n / safe_n)
    m2 = a.m2 + b.m2 + delta * delta * (a.n * b.n / safe_n)
    return Moments(n=n, mean=mean, m2=m2)


def zeros_moments(shape, dtype=torch.float32, device=None) -> Moments:
    """Moments of no samples: the identity of ``merge_moments``."""
    z = torch.zeros(shape, dtype=dtype, device=device)
    return Moments(n=z, mean=z, m2=z)


def variance(m: Moments) -> torch.Tensor:
    """Sample variance M2/(n-1); 0 where n < 2."""
    return torch.where(m.n >= 2.0, m.m2 / torch.clamp(m.n - 1.0, min=1.0),
                       torch.zeros_like(m.m2))
