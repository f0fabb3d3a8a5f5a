"""The inverse step, frozen: Adam on the cross-estimator, by autograd through
a frozen tracer, in blocks of rows so that a 512x512x32 frame fits.

A step renders frames ``2 step`` and ``2 step + 1`` (A and B) of the scene
the parameters give, and takes the loss mean((A - T)(B - T)) against the
target T; its gradient is A's colour against (B - T) / n plus B's against
(A - T) / n (n the number of colour values). The two colours are rendered
once without a graph; then each block of rows is rendered again with one,
and autograd takes that block's share of the gradient, so the graph of one
block is held at a time. The forward is the same function of the same
inputs both times, so the two renders agree to the bit. Adam (b1 0.9, b2
0.999, eps 1e-8) is ``torch.optim.Adam``'s update, written out.
"""

from __future__ import annotations

import torch

from benchmark.reference import tracer

B1, B2, EPS = 0.9, 0.999, 1e-8
BLOCK_SAMPLES = 1 << 20  # pixel-samples a block of rows traces with a graph (~6 GB of it)


def row_blocks(rows, width: int, spp: int) -> list:
    """``rows`` cut into blocks of about ``BLOCK_SAMPLES`` pixel-samples."""
    rows = list(rows)
    step = max(1, BLOCK_SAMPLES // (width * spp))
    return [rows[i:i + step] for i in range(0, len(rows), step)]


def cross_steps(frame, scene_of, params: dict, target, rows, width: int, spp: int,
                steps: int, rate, mask=None):
    """``steps`` Adam steps from ``params`` ({name: leaf}) -> ([(loss,
    mean |(A - T)(B - T)|)] a step, {name: first gradient}, {name: value
    after the last step}). ``frame(spheres, index, rows)`` is a frozen
    tracer's ``Frame`` of those rows, ``scene_of(params)`` the spheres the
    parameters give (differentiable), ``target`` [len(rows), W, 3] the
    target of ``rows``, ``rate(name, step)`` the learning rate, ``mask``
    ({name: 0/1 tensor}) the entries that move."""
    blocks = row_blocks(rows, width, spp)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], {}
    for step in range(steps):
        frames = (2 * step, 2 * step + 1)
        with torch.no_grad():
            spheres = scene_of(params)
            a, b = (torch.cat([tracer.color_mean(frame(spheres, i, blk), spp, spp)
                               for blk in blocks]) for i in frames)
        ra, rb = a - target, b - target
        n = ra.numel()
        losses.append((float((ra * rb).sum() / n), float((ra * rb).abs().sum() / n)))
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        at = 0
        for blk in blocks:
            part = slice(at, at + len(blk))
            at += len(blk)
            for index, ct in zip(frames, (rb[part] / n, ra[part] / n)):
                colour = tracer.color_mean(frame(scene_of(params), index, blk), spp, spp)
                for k, g in zip(params, torch.autograd.grad(colour, list(params.values()), ct)):
                    grads[k] += g
                del colour
        del a, b
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * mask[k] if mask and k in mask else grads[k]
                if step == 0:
                    first[k] = g.clone()
                m[k] = B1 * m[k] + (1 - B1) * g
                v[k] = B2 * v[k] + (1 - B2) * g * g
                m_hat = m[k] / (1 - B1 ** (step + 1))
                v_hat = v[k] / (1 - B2 ** (step + 1))
                p -= rate(k, step) * m_hat / (torch.sqrt(v_hat) + EPS)
    return losses, first, {k: p.detach() for k, p in params.items()}
